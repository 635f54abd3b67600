"""The port's measuring tools: ``perf.parent_vs_change`` (the replayed
serving selection, the other checkout loaded under another name), the
timer's refusals and the rescore scratch's size. The CPU has no CUDA
events; the timer itself runs in the ``cuda``-marked test, which skips
without a card."""

import importlib
from pathlib import Path

import numpy as np
import pytest
import torch

from openmatch_tpu_torch.ops import cuda_mips as cm
from openmatch_tpu_torch.ops.mips import Searcher
from openmatch_tpu_torch.perf import event_ms, spin_ms, time_ms
from openmatch_tpu_torch.perf import ablate
from openmatch_tpu_torch.perf import parent_vs_change as pvc

REPO = Path(__file__).resolve().parents[1]


def queries_per_block(bid: torch.Tensor, n: int) -> tuple:
    """Blocks of ``bid`` by the number of its rows that name them, 1..n."""
    _, per = torch.unique(torch.cat([r.unique() for r in bid]),
                          return_counts=True)
    return tuple(torch.bincount(per, minlength=n + 1)[1:].tolist())


@pytest.mark.parametrize("hist,n_q,k,nb", [
    (pvc.SERVING_QUERIES_PER_BLOCK, 64, 1000, 1_105_227),
    ((1, 1, 1), 3, 2, 10),  # one block each of 1, 2 and 3 queries
    ((8,), 1, 8, 8),  # one query, every block
    ((0, 0, 5), 3, 5, 7),  # every block picked by all three
])
def test_replay_selection_has_the_shape(hist, n_q, k, nb):
    """Every row names k distinct blocks below nb, the blocks split by
    queries as ``hist`` says, and the seed fixes the result."""
    bid = pvc.replay_selection(hist, n_q, k, nb, seed=3)
    assert bid.shape == (n_q, k) and bid.dtype == torch.int32
    assert all(r.unique().numel() == k for r in bid)
    assert 0 <= int(bid.min()) and int(bid.max()) < nb
    assert queries_per_block(bid, len(hist)) == tuple(hist)
    assert torch.equal(bid, pvc.replay_selection(hist, n_q, k, nb, seed=3))


@pytest.mark.parametrize("hist,n_q,k,nb", [
    ((2, 1), 2, 3, 10),  # 4 picks for 6 places
    ((0, 0, 1), 2, 1, 10),  # a block of 3 queries among 2
    ((4,), 1, 4, 3),  # 4 blocks from 3
])
def test_replay_selection_refuses_a_shape_that_does_not_fit(hist, n_q, k, nb):
    with pytest.raises(ValueError):
        pvc.replay_selection(hist, n_q, k, nb, seed=0)


def test_serving_shape_is_the_logged_selection():
    """64 queries x 1,000 picks over 5,010 distinct blocks."""
    hist = np.asarray(pvc.SERVING_QUERIES_PER_BLOCK)
    assert len(hist) == 64 and hist.sum() == pvc.UNIFORM_POOL
    assert (hist * np.arange(1, 65)).sum() == 64 * pvc.K


def test_load_tree_imports_a_tree_under_another_name():
    """The tree loaded under another name runs its own modules, and its
    search answers as this tree's does (CPU tensors: plain versions)."""
    build, cuda_mips, mips = pvc.load_tree(REPO, "other_tree")
    for mod, name in ((build, "_build"), (cuda_mips, "cuda_mips"),
                      (mips, "mips")):
        assert mod.__name__ == f"other_tree.ops.{name}"
        assert mod is not importlib.import_module(
            f"openmatch_tpu_torch.ops.{name}")
        assert Path(mod.__file__).resolve() == \
            REPO / "openmatch_tpu_torch" / "ops" / f"{name}.py"
    g = torch.Generator().manual_seed(0)
    rows = torch.randn(20_000, 16, generator=g)
    q = torch.randn(4, 16, generator=g)
    for n_segs in (1, 3):
        want = Searcher(rows, k=50, method="kernel", n_segs=n_segs).search(q)
        got = mips.Searcher(rows, k=50, method="kernel",
                            n_segs=n_segs).search(q)
        assert torch.equal(got[1], want[1])
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)


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


@pytest.mark.parametrize("kernel,variant", [
    (kernel, variant) for kernel, (_, variants, _) in ablate.KERNELS.items()
    for variant in variants])
def test_ablate_variants_follow_the_source(tmp_path, kernel, variant):
    """Every ablation's text edits are found in its kernel's source and
    applied to the copy (a variant whose edit no longer matches would
    raise on the card), and the package itself is left as it is."""
    src, variants, _ = ablate.KERNELS[kernel]
    before = (ablate.PKG / src).read_text()
    root = ablate.make_variant(tmp_path, src, variants[variant])
    text = (root / "openmatch_tpu_torch" / src).read_text()
    for old, new in variants[variant]:
        assert old in before and new in text
    assert (text == before) == (not variants[variant])
    assert (ablate.PKG / src).read_text() == before


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
