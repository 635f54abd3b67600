"""The ``encode_kimi`` driver on the CPU at tiny sizes, past the look for
a card: a sound run comes out correct, each fault planted in the
``kimi_linear`` backbone turns ``correct`` false, the control fails the
cell's real limits, and a program without the backbone fails before any
weight is drawn. Then the yardstick (``arith_kimi``) and the new
metrics' readers.

The tiny runs compute in float32 with limits of their own, as
``test_bench_lm``'s do."""

import sys
import time

import numpy as np
import pytest
import torch

from benchmark import arith_kimi
from benchmark.common import find_cell, judge, metric_reader
from benchmark.drivers import encode_kimi
from benchmark.tests import faults_kimi
from benchmark.tests.tiny_kimi import CELL, tiny_kimi
from benchmark.tracing import TraceSummary

ENCODE_LIMITS = {"rep_err": 2e-3, "route_err": 1e-4, "order": 0.0}


def encode_run(seed=5, **changes):
    cell = tiny_kimi(ENCODE_LIMITS, **changes)
    return encode_kimi.run(cell, seed, 0.3, False, time.time(), "cpu")


def test_encode_kimi_sound_run_is_correct():
    out = encode_run()
    assert out.correct, out.checks
    graphs = out.layer["graphs"]
    n_tokens = out.layer["rest_lengths"].sum()
    # every real token of the window routed to 2 experts in 3 MoE layers,
    # about half of them to the 4 held of 8
    assert graphs["routed_slots"] == 3 * 2 * n_tokens
    assert 0.3 < graphs["held_slots"] / graphs["routed_slots"] < 0.7
    assert out.layer["rest_held_slots"] == graphs["held_slots"]


@pytest.mark.parametrize("fault", faults_kimi.FAULTS)
def test_encode_kimi_fault_is_caught(monkeypatch, fault):
    getattr(faults_kimi, fault)(monkeypatch)
    out = encode_run()
    assert not out.correct, out.checks


def test_encode_kimi_control_fails_the_real_limits():
    """At the configuration's depth and layer pattern (27 layers, KDA
    three to one), tiny widths."""
    from benchmark.kimi_readings import control

    real = find_cell(CELL)
    cell = tiny_kimi(real.limits, num_hidden_layers=27,
                     linear_attn_config=dict(
                         tiny_kimi().config["linear_attn_config"],
                         kda_layers=real.config["linear_attn_config"][
                             "kda_layers"],
                         full_attn_layers=real.config["linear_attn_config"][
                             "full_attn_layers"]))
    numbers = control(cell, 7, "cpu")
    assert not judge({k: (v, cell.limits[k]) for k, v in numbers.items()})


def test_a_program_without_the_backbone_fails_before_drawing(monkeypatch):
    import benchmark.drivers.encode_kimi as drv

    monkeypatch.setitem(sys.modules, "openmatch_tpu_torch.models.kimi_linear",
                        None)
    monkeypatch.setattr(drv, "KimiDrawn", None)  # drawing would raise
    with pytest.raises(ImportError):
        drv.run(tiny_kimi(ENCODE_LIMITS), 5, 0.3, False, time.time(), "cpu")


# ---- the yardstick and the readers -----------------------------------------


def test_kimi_linear_counts():
    cfg = find_cell(CELL).config
    d, HD = 2304, 4096
    # KDA per token: q, k, v, o; f_a and g_a 2304 x 128, f_b and g_b
    # 128 x 4096; b 2304 x 32; the convolutions; 32 heads x 7 x 128^2
    kda = (2 * (4 * d * HD + 2 * (d * 128 + 128 * HD) + d * 32)
           + 2 * 3 * HD * 4 + 32 * 7 * 128 * 128)
    mla = 2 * (d * 32 * 192 + d * 576 + 512 * 32 * 256 + 32 * 128 * d)
    parts = arith_kimi.token_flops(cfg)
    assert parts == {"kda": 20 * kda, "mla": 7 * mla,
                     "dense": 2 * 3 * d * 9216,
                     "moe": 26 * (2 * d * 256 + 2 * 3 * d * 1024)}
    # causal pairs of a 3-token document: 6, in 7 MLA layers
    assert arith_kimi.attention_flops(cfg, 3) == 7 * 6 * 2 * 32 * 320
    want = 6 * sum(parts.values()) + 2 * 7 * 6 * 2 * 32 * 320 \
        + 100 * 6 * d * 1024
    assert arith_kimi.document_flops(cfg, [3, 3], 100) == pytest.approx(want)
    t, by = arith_kimi.kda_chunk_bound_s(cfg, 1000)
    assert by == "bytes"
    assert t == pytest.approx(1000 * 32 * (3 * 256 + 512 + 4 + 256)
                              / 3.35e12)
    t, by = arith_kimi.held_expert_gemm_bound_s(cfg, 90_000)
    assert by == "operations"
    assert t == pytest.approx(90_000 * 6 * d * 1024 / 989e12)


def trace_of(kernel, calls, seconds):
    return TraceSummary(busy_s=1.0, window_s=1.0, launches=calls,
                        kernels={kernel: (calls, seconds)})


def test_kda_chunk_roofline_reader():
    cfg = find_cell(CELL).config
    read = metric_reader("kda_chunk_roofline").read
    lengths = np.full(96, 300)
    bound = 2 * 20 * arith_kimi.kda_chunk_bound_s(cfg, 48 * 300)[0]
    layer = {"trace": trace_of("kda_chunk_kernel", 40, 4 * bound),
             "traced_lengths": lengths, "batch_size": 48, "config": cfg}
    assert read(layer) == pytest.approx(25.0)
    assert read(dict(layer, trace=TraceSummary(1.0, 1.0, {}, 0))) is None
    assert read(dict(layer, traced_lengths=None)) is None


def test_held_expert_gemm_roofline_reader():
    cfg = find_cell(CELL).config
    read = metric_reader("held_expert_gemm_roofline").read
    held = np.full(26, 3 * 70_000)
    bound = 26 * 3 * arith_kimi.held_expert_gemm_bound_s(cfg, 70_000)[0]
    layer = {"trace": trace_of("(anonymous namespace)::grouped_gemm_kernel"
                               "<256>(...)", 156, 2 * bound),
             "traced_held_slots": held, "traced_batches": 3, "config": cfg}
    assert read(layer) == pytest.approx(50.0)
    assert read(dict(layer, traced_held_slots=None)) is None
    assert read(dict(layer, traced_batches=0)) is None


def test_mfu_and_held_share_readers():
    cfg = find_cell(CELL).config
    mfu = metric_reader("kimi_encode_step_mfu").read
    flops = arith_kimi.document_flops(cfg, [100, 300], 3200)
    layer = {"rest_lengths": np.array([100, 300]), "rest_held_slots": 3200.0,
             "window_s": 2.0, "config": cfg}
    assert mfu(layer) == pytest.approx(100 * flops / 2 / 989e12)
    assert mfu(dict(layer, rest_held_slots=None)) is None
    assert mfu(dict(layer, rest_lengths=np.array([]))) is None
    share = metric_reader("held_slots_pct").read
    assert share({"graphs": {"held_slots": 30, "routed_slots": 120}}) == 25.0
    assert share({"graphs": {"packed_slots": 4}}) is None
    assert share({}) is None


def test_the_drawn_share_keeps_each_experts_seed():
    """An expert's weights are the same bits whichever share draws it."""
    from benchmark.kimi_weights import KimiDrawn

    cfg = tiny_kimi().config
    whole = KimiDrawn(dict(cfg, held_experts=[0, 8]), 3, "cpu", torch.float32)
    half = KimiDrawn(cfg, 3, "cpu", torch.float32)
    name = "layers.2.mlp.experts.3.w2.weight"
    assert torch.equal(whole[name], half[name])
    assert "layers.2.mlp.experts.5.w2.weight" not in half
    a_log = half["layers.0.self_attn.A_log"]
    assert bool(((a_log >= 0) & (a_log <= np.log(16) + 1e-6)).all())
    dt = torch.nn.functional.softplus(half["layers.0.self_attn.dt_bias"])
    assert float(dt.min()) >= 1e-4 - 1e-7 and float(dt.max()) <= 0.1 + 1e-6
