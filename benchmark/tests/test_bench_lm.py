"""The ``encode_lm`` driver on the CPU at tiny sizes, past the look for a
card: a sound run comes out correct, each fault planted in the
``deepseek_v3`` backbone turns ``correct`` false, the control fails the
cell's real limits, and a program without the backbone fails before any
weight is drawn. Then the new yardstick (``arith_moe``) and the new
metrics' readers.

The tiny runs compute in float32 with limits of their own: at these sizes
bf16 on the CPU says nothing about bf16 on the card."""

import sys
import time

import numpy as np
import pytest
import torch

from benchmark import arith_moe
from benchmark.common import find_cell, judge, metric_reader
from benchmark.drivers import encode_lm
from benchmark.tests import faults_lm
from benchmark.tests.tiny_lm import tiny_lm
from benchmark.tracing import TraceSummary

# reps come back fp16, and the centred gap's denominator (a rep's distance
# from the sample's mean) is below the rep's norm
ENCODE_LIMITS = {"rep_err": 2e-3, "route_err": 1e-4, "order": 0.0}
CELL = "moonlight-16b-a3b.encode-long"


def encode_run(seed=5):
    cell = tiny_lm(CELL, ENCODE_LIMITS)
    return encode_lm.run(cell, seed, 0.3, False, time.time(), "cpu")


def test_encode_lm_sound_run_is_correct():
    out = encode_run()
    assert out.correct, out.checks
    assert out.attempted > 0 and out.metrics["encode_passages_per_s"] > 0
    slots = out.layer["expert_slots"]
    # every real token of the window routed to 2 experts in each MoE layer
    n_tokens = out.layer["rest_lengths"].sum()
    assert (slots.sum(axis=1) == 2 * n_tokens).all()


@pytest.mark.parametrize("fault", ["causal_mask_dropped", "bias_as_weight",
                                   "rope_not_interleaved",
                                   "pooled_at_padded_end",
                                   "one_expert_dropped",
                                   "bias_left_out_of_selection"])
def test_encode_lm_fault_is_caught(monkeypatch, fault):
    getattr(faults_lm, fault)(monkeypatch)
    out = encode_run()
    assert not out.correct, out.checks


def test_a_selection_fault_is_caught_by_route_err(monkeypatch):
    """The reference follows the program's choices, so a wrong choice
    shows in ``route_err``, not in the reps."""
    faults_lm.bias_left_out_of_selection(monkeypatch)
    out = encode_run()
    assert out.checks["route_err"][0] > 100 * ENCODE_LIMITS["route_err"]
    assert out.checks["rep_err"][0] <= ENCODE_LIMITS["rep_err"]


def test_encode_lm_control_fails_the_real_limits():
    """At the configuration's depth: the control's gap grows with the
    layers it crosses (at 3 tiny layers it reads about 0.2)."""
    from benchmark.more_readings import encode_lm_control

    cell = tiny_lm(CELL, find_cell(CELL).limits)
    cell.config["num_hidden_layers"] = find_cell(CELL).config[
        "num_hidden_layers"]
    numbers = encode_lm_control(cell, 7, "cpu")
    assert not judge({k: (v, cell.limits[k]) for k, v in numbers.items()})


def test_a_program_without_the_backbone_fails_before_drawing(monkeypatch):
    import benchmark.drivers.encode_lm as drv

    monkeypatch.setitem(sys.modules, "openmatch_tpu_torch.models.deepseek_v3",
                        None)
    monkeypatch.setattr(drv, "Drawn", None)  # drawing would raise TypeError
    with pytest.raises(ImportError):
        drv.run(tiny_lm(CELL, ENCODE_LIMITS), 5, 0.3, False, time.time(),
                "cpu")


# ---- the yardstick and the readers -----------------------------------------


def test_moonlight_counts():
    cfg = find_cell(CELL).config
    # per token: MLA 4 x 2 x (2048 x 3072 + 2048 x 576 + 512 x 4096 +
    # 2048 x 2048) over 27 layers, dense SwiGLU 2 x 3 x 2048 x 11264 once,
    # then 26 x (router 2 x 2048 x 64, 6 routed and 2 shared experts)
    attn = 2 * (2048 * 3072 + 2048 * 576 + 512 * 4096 + 2048 * 2048)
    moe = 2 * 2048 * 64 + 8 * 2 * 3 * 2048 * 1408
    want = 27 * attn + 2 * 3 * 2048 * 11264 + 26 * moe
    assert arith_moe.token_flops(cfg) == want
    # causal pairs of a 3-token passage: 6; 2 x 16 x (192 + 128) each
    assert arith_moe.attention_flops(cfg, 3) == 27 * 6 * 2 * 16 * 320
    t, by = arith_moe.expert_gemm_bound_s(cfg, 13_000)
    assert by == "operations"
    assert t == pytest.approx(26 * 13_000 * 6 * 6 * 2048 * 1408 / 989e12)


def test_expert_load_reader():
    read = metric_reader("expert_load_max_pct").read
    slots = np.array([[10, 10, 10, 10], [40, 0, 0, 0]])
    assert read({"expert_slots": slots}) == pytest.approx(400.0)
    assert read({}) is None


def test_expert_gemm_roofline_reader():
    cfg = find_cell(CELL).config
    read = metric_reader("expert_gemm_roofline").read
    lengths = np.full(128, 200)
    bound = 2 * arith_moe.expert_gemm_bound_s(cfg, 64 * 200)[0]
    trace = TraceSummary(busy_s=1.0, window_s=1.0, launches=104,
                         kernels={"(anonymous namespace)::grouped_gemm_"
                                  "kernel(...)": (104, 4 * bound)})
    layer = {"trace": trace, "traced_lengths": lengths, "batch_size": 64,
             "config": cfg}
    assert read(layer) == pytest.approx(25.0)
    assert read(dict(layer, trace=TraceSummary(1.0, 1.0, {}, 0))) is None


def test_mfu_reader():
    cfg = find_cell(CELL).config
    mfu = metric_reader("moe_encode_step_mfu").read
    flops = arith_moe.passage_flops(cfg, [100, 300])
    assert mfu({"rest_lengths": np.array([100, 300]), "window_s": 2.0,
                "config": cfg}) == pytest.approx(100 * flops / 2 / 989e12)
    assert mfu({"rest_lengths": np.array([]), "window_s": 2.0,
                "config": cfg}) is None
