"""The port's measuring tools: the timer's refusals and the rescore
scratch's size. The CPU has no CUDA events; the timer itself runs in the
``cuda``-marked test, which skips without a card."""

import numpy as np
import pytest
import torch

from openmatch_tpu_torch.ops import cuda_mips as cm
from openmatch_tpu_torch.perf import event_ms, spin_ms, time_ms


def test_event_ms_refuses_an_unknown_queue():
    with pytest.raises(ValueError, match="queue"):
        event_ms(lambda: None, "sleep")


@pytest.mark.parametrize("nb,k,slots", [
    (1_105_227, 1000, 64_000),  # the serving index: a chunk's picks bound U
    (100, 1000, 100),  # a small corpus: its blocks bound U
])
def test_dedup_scratch_holds_the_distinct_blocks_a_chunk_can_name(nb, k,
                                                                 slots):
    """mask + count, slot, then ulist and scores sized by U = min(NB,
    64 * k) distinct blocks, each part on a 256-byte boundary."""
    buf, ptrs = cm._dedup_scratch(nb, 64, k, torch.device("cpu"))
    sizes = (8 * (nb + 1), 4 * nb, 4 * slots, 4 * slots * 64 * 8)
    ends = np.cumsum([-(-s // 256) * 256 for s in sizes])
    assert buf.numel() == ends[-1]
    assert [p - buf.data_ptr() for p in ptrs] == [0, *ends[:-1]]


@pytest.mark.cuda
def test_cuda_event_ms_times_the_card_alone():
    """A call of many tiny launches takes the host longer to enqueue than
    the card to run: behind a spin the events hold the card's work alone
    and read less than behind an untimed call, which holds the host's
    enqueue. The spin is measured."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA events have no CPU mode")
    x = torch.zeros(1, device="cuda")

    def host_heavy():  # 200 launches of a one-element kernel
        for _ in range(200):
            x.add_(1)

    spin = time_ms(host_heavy, torch.device("cuda", 0), 2, 5, queue="spin")
    call = time_ms(host_heavy, torch.device("cuda", 0), 2, 5, queue="call")
    cycles, ms = spin_ms()
    assert 0 < spin < call and cycles > 0 and ms > 0


# ---- the mesh perf twins and serve_load at a tiny size ------------------------


@pytest.mark.parametrize("method", ["plain", "kernel"])
def test_sharded_merge_times_both_paths_over_two_ranks(method):
    """``perf.sharded_merge`` over 2 gloo ranks: a row per (Q, k) with both
    times and their difference."""
    from openmatch_tpu_torch.perf import sharded_merge

    out = sharded_merge.main(["--world", "2", "--shard_rows", "4096",
                              "--dim", "16", "--qs", "8", "--ks", "10,100",
                              "--method", method, "--device", "cpu"])
    assert [(r["Q"], r["k"]) for r in out["rows"]] == [(8, 10), (8, 100)]
    for r in out["rows"]:
        assert r["t_full_ms"] > 0 and r["t_sharded_ms"] > 0
        assert r["overhead_ms"] == pytest.approx(r["t_sharded_ms"]
                                                 - r["t_full_ms"])


def test_mesh_parity_equal_answers_and_a_ratio():
    """``perf.mesh_parity``: the 1-rank mesh queries path and the direct
    prepared path give the same scores; N must be a multiple of 8."""
    from openmatch_tpu_torch.perf import mesh_parity

    out = mesh_parity.main(["16384", "8", "20", "--device", "cpu"])
    assert out["dispatch"] == "kernel-mesh-queries"
    assert out["max_score_diff"] <= 1e-3 and out["ratio"] > 0
    with pytest.raises(ValueError, match="multiple of 8"):
        mesh_parity.main(["16385", "8", "20", "--device", "cpu"])


@pytest.mark.parametrize("mode", ["search", "rerank"])
def test_serve_load_drives_the_live_http_surface(mode):
    """``perf.serve_load`` at a tiny size: every request answered, the
    percentiles ordered, the queue's stats and timeline read."""
    from openmatch_tpu_torch.perf import serve_load

    out = serve_load.main(["--mode", mode, "--n-docs", "4096",
                           "--concurrency", "4", "--duration", "1.5",
                           "--warm-s", "0.5", "--max-batch", "8",
                           "--docs-per-req", "4", "--port", "0",
                           "--device", "cpu"])
    assert out["requests"] > 0 and out["errors"] == 0
    assert out["p50_ms"] <= out["p95_ms"] <= out["p99_ms"]
    assert out["dispatches"] >= 1 and out["max_coalesced"] >= 1


def test_term_tokenizer_is_the_scripts_bert_vocabulary():
    from openmatch_tpu_torch.perf.serve_load import TermTokenizer

    tok = TermTokenizer()
    assert tok.encode_plus("term0 term199 other", max_length=4)[
        "input_ids"] == [2, 5, 204, 3]
    assert tok.encode_plus(("term1 term2", "term3"), max_length=6,
                           return_token_type_ids=True) == {
        "input_ids": [2, 6, 7, 3, 8, 3], "token_type_ids": [0] * 4 + [1] * 2}
