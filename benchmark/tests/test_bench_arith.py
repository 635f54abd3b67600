"""The frozen yardstick: peaks, the scoring kernel's bound and the FLOP
counts, held to numbers worked out by hand."""

import math

import pytest

from benchmark import arith
from benchmark.common import find_cell, percentile

N_MSMARCO = 8_841_823


def test_peaks_are_the_h100_data_sheet():
    assert arith.BF16_FLOPS == 989e12
    assert arith.HBM_BYTES_PER_S == 3.35e12


def test_plain_gmax_bound_at_the_serving_shape():
    # Q = 64 over MS MARCO: the body's 1,105,227 blocks read once, the
    # block maxima and the 8-wide first level written (PERF.md's 4.149 ms)
    seconds, by = arith.plain_gmax_call_bound_s(64, N_MSMARCO, 768)
    nb = N_MSMARCO // 8
    n_bytes = nb * 8 * 768 * 2 + 64 * 768 * 2 + 64 * (nb + -(-nb // 8)) * 4
    assert by == "bytes"
    assert seconds == pytest.approx(n_bytes / 3.35e12, rel=1e-12)
    assert seconds * 1e3 == pytest.approx(4.149, abs=5e-4)


def test_bound_names_operations_when_compute_bound():
    seconds, by = arith.bound_s(1.0, 989e12)
    assert (seconds, by) == (1.0, "operations")


def test_bert_base_forward_flops_by_hand():
    per_layer = 2 * 32 * (4 * 768 * 768 + 2 * 768 * 3072) + 4 * 32 * 32 * 768
    assert arith.bert_forward_flops(32, 768, 12, 3072) == 12 * per_layer
    cfg = find_cell("bert-base.search-batch").config
    assert arith.bert_config_flops(cfg, 32) == 12 * per_layer
    assert arith.search_query_flops(cfg, 32, N_MSMARCO) == (
        12 * per_layer + 2 * N_MSMARCO * 768)


def test_t5_base_step_flops_by_hand():
    cfg = find_cell("t5-base.encode").config
    S, d, f = 128, 768, 3072
    enc = 2 * S * (4 * d * d + 2 * d * f) + 4 * S * S * d
    dec = (8 * d * d + 4 * d + 4 * d * d + 4 * S * d * d + 4 * S * d
           + 4 * d * f)
    assert arith.t5_encdec_step_flops(cfg, S) == 12 * enc + 12 * dec
    assert 24e9 < arith.t5_encdec_step_flops(cfg, S) < 28e9


def test_train_step_flops_is_three_forwards_plus_the_loss():
    cfg = find_cell("bert-base.train").config
    fwd = 8 * arith.bert_config_flops(cfg, 32) + 64 * arith.bert_config_flops(
        cfg, 128)
    assert arith.dr_train_step_flops(cfg, 8, 64, 32, 128) == 3 * (
        fwd + 2 * 8 * 64 * 768)


def test_mfu_pct():
    assert arith.mfu_pct(989e12, 2.0) == pytest.approx(50.0)


def test_percentile():
    assert percentile([1, 2, 3, 4, 5], 50) == 3
    assert percentile([1, 2, 3, 4, 5], 95) == pytest.approx(4.8)
    assert percentile([1.0, math.inf], 95) == math.inf
