"""The port's segmented-index search and its sequential corpus windows on
the CPU against the JAX package (Pallas in interpret mode, with the small
tiles of tests/test_pallas_mips.py):

- K4 ``fused_plain_gmax_segs`` and K5/K6 ``gather_rescore`` over segments
  and with ``pipeline=True``, as plain PyTorch versions (the CUDA kernels
  are held against these in the ``cuda``-marked tests of
  tests/test_torch_mips_kernels.py);
- ``plain_topk_prepared`` with ``n_segs``, ``c_split`` and ``pipeline``,
  ``Searcher(n_segs=2)``, and the ``search_n_segs`` wiring of
  ``Retriever``.

Tolerances: kernel outputs atol 1e-4 with entries masked to
finfo(float32).min bit-equal; top-k scores atol 1e-4 and ids compared as
sets above the k-th score's tie band (fp32 sums in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmatch_tpu.config import DataArguments, InferenceArguments
from openmatch_tpu.ops import mips as jmips
from openmatch_tpu.ops import pallas_mips as pm
from openmatch_tpu_torch.ops import cuda_mips as cm
from openmatch_tpu_torch.ops import mips
from openmatch_tpu_torch.retriever.retriever import Retriever

from test_torch_mips_kernels import assert_match, bf16_data
from test_torch_search import assert_same_topk, brute, corpus_pair

torch.set_num_threads(2)
TILE_G = 128  # the JAX kernels' test tile (blocks)


def jax_segments(segs):
    return tuple(jnp.asarray(s.float().numpy()) for s in segs)


# ---- K4: block maxima over segments ------------------------------------------


@pytest.mark.parametrize("tile_q", [8, 16])
def test_plain_gmax_segs_matches_jax(tile_q):
    """Segments of (1, 2, 1) tiles, pad blocks masked in the last one: gmax
    and level 1 as the JAX alias-windowed per-segment kernels write them."""
    D, Q = 64, 16
    segs = [bf16_data(20 + i, nt * TILE_G * 8, D)[0]
            for i, nt in enumerate((1, 2, 1))]
    nb_valid = 4 * TILE_G - 37
    segs[-1][(nb_valid - 3 * TILE_G) * 8:] = 4.0  # pads would win unmasked
    q, q_j = bf16_data(24, Q, D)
    want = pm.fused_plain_gmax_segs(q_j, jax_segments(segs), TILE_G, tile_q,
                                    emit_l1=8, nb_valid=nb_valid)
    got = cm.fused_plain_gmax_segs(q, tuple(segs), emit_l1=8,
                                   nb_valid=nb_valid)
    assert_match(got[0], want[0])
    assert_match(got[1], want[1])
    # without level 1: the single-buffer JAX kernel over the concatenation,
    # pads masked after it as the JAX non-fused segmented path masks them
    want0 = np.array(pm.fused_plain_gmax(
        q_j, jnp.concatenate(jax_segments(segs)), TILE_G, tile_q))
    want0[:, nb_valid:] = np.finfo(np.float32).min
    assert_match(cm.fused_plain_gmax_segs(q, tuple(segs), nb_valid=nb_valid),
                 want0)


def test_plain_gmax_segs_refuses_tiles_across_segments():
    q, _ = bf16_data(25, 2, 16)
    segs = (bf16_data(26, 8 * 24, 16)[0], bf16_data(27, 8 * 16, 16)[0])
    with pytest.raises(ValueError, match="multiple of 16 blocks"):
        cm.fused_plain_gmax_segs(q, segs)
    with pytest.raises(ValueError, match="emit_l1"):
        cm.fused_plain_gmax_segs(q, segs[::-1], emit_l1=3)


# ---- K5/K6: gather-rescore ---------------------------------------------------


def rescore_case(seed, seg_blocks, Q=5, k=12, D=64):
    segs = [bf16_data(seed + i, nb * 8, D)[0] for i, nb in enumerate(seg_blocks)]
    q, q_j = bf16_data(seed + 10, Q, D)
    NB = sum(seg_blocks)
    bids = np.random.RandomState(seed).randint(0, NB, (Q, k)).astype(np.int32)
    cuts = np.cumsum((0,) + tuple(seg_blocks))
    bids[:, :len(seg_blocks)] = cuts[:-1]    # the first block of each segment
    bids[:, -len(seg_blocks):] = cuts[1:] - 1  # ... and the last
    bids[:, 4] = bids[:, 5]                  # a repeated id
    return segs, q, q_j, bids


def test_gather_rescore_segments_match_jax():
    segs, q, q_j, bids = rescore_case(30, (40, 24, 72))
    want, _ = pm.pallas_gather_rescore(q_j, jax_segments(segs),
                                       jnp.asarray(bids), kt=16)
    got = cm.gather_rescore(q, tuple(segs), torch.from_numpy(bids))
    assert_match(got, np.asarray(want)[:, :bids.shape[1] * 8])
    # one buffer or its segments: the same scores
    full = torch.cat(segs)
    np.testing.assert_array_equal(
        got.numpy(), cm.gather_rescore(q, full, torch.from_numpy(bids)).numpy())


def test_gather_rescore_pipelined_matches_jax():
    (plain,), q, q_j, bids = rescore_case(40, (70,))
    want, _ = pm.pallas_gather_rescore(q_j, jnp.asarray(plain.float().numpy()),
                                       jnp.asarray(bids), pipeline=True, kt=16)
    got = cm.gather_rescore(q, plain, torch.from_numpy(bids), pipeline=True)
    assert_match(got, np.asarray(want)[:, :bids.shape[1] * 8])


def test_segmented_rescore_refuses_pipeline():
    segs, q, _, bids = rescore_case(50, (16, 16), D=16)
    with pytest.raises(ValueError, match="pipeline"):
        cm.gather_rescore(q, tuple(segs), torch.from_numpy(bids),
                          pipeline=True)


# ---- the prepared layout -----------------------------------------------------


@pytest.mark.parametrize("N,n_segs", [(2061, 2), (8 * 640 + 5, 3),
                                      (8 * 2600, 4)])
def test_segments_are_separate_allocations_cut_as_jax(N, n_segs):
    c, c_j = corpus_pair(60, N, 8)
    prep = cm.prepare_plain_corpus(c, n_segs=n_segs)
    want = pm.prepare_plain_corpus(c_j, tile_g=256, n_segs=n_segs)
    rows = [s.shape[0] for s in prep.plain]
    want_rows = [s.shape[0] for s in want.plain]
    # the JAX layout pads the last segment to whole tiles; the port does not
    assert rows[:-1] == want_rows[:-1]
    assert sum(rows) == N // 8 * 8
    storages = {s.untyped_storage().data_ptr() for s in prep.plain}
    storages.add(prep.tail.untyped_storage().data_ptr())
    assert len(storages) == len(rows) + 1
    assert c.untyped_storage().data_ptr() not in storages
    np.testing.assert_array_equal(torch.cat(prep.plain).float().numpy(),
                                  c[:N // 8 * 8].float().numpy())
    np.testing.assert_array_equal(prep.tail.float().numpy(),
                                  c[N // 8 * 8:].float().numpy())


# ---- the search --------------------------------------------------------------


def all_negative_case(N=8 * 640 + 5, D=16, Q=4):
    """All scores negative (zero pad rows would score 0 and win), the top
    doc in the ragged tail and another in the last full block."""
    rng = np.random.RandomState(70)
    c = np.abs(rng.randn(N, D)).astype(np.float32)
    c[N - 1] *= 0.01
    c[N - 9] *= 0.01
    q = -np.abs(rng.randn(Q, D)).astype(np.float32)
    c_t = torch.from_numpy(c).to(torch.bfloat16)
    q_t = torch.from_numpy(q).to(torch.bfloat16)
    return (c_t, jnp.asarray(c_t.float().numpy()),
            q_t, jnp.asarray(q_t.float().numpy()))


@pytest.mark.parametrize("option", [
    dict(n_segs=2), dict(n_segs=3), dict(c_split=2), dict(c_split=3),
    dict(pipeline=True)])
def test_plain_topk_prepared_matches_jax(option):
    c, c_j, q, q_j = all_negative_case()
    k = 12
    n_segs = option.get("n_segs", 1)
    search = {key: v for key, v in option.items() if key != "n_segs"}
    want = pm.pallas_plain_topk_prepared(
        q_j, pm.prepare_plain_corpus(c_j, tile_g=TILE_G, n_segs=n_segs), k=k,
        tile_g=TILE_G, tile_q=8, **search)
    prep = cm.prepare_plain_corpus(c, n_segs=n_segs)
    assert isinstance(prep.plain, tuple) == (n_segs > 1)
    got = cm.plain_topk_prepared(q, prep, k, **search)
    assert_same_topk(got[0], got[1], want[0], want[1])
    assert_same_topk(got[0], got[1], *brute(q, c, k))
    assert (got[1] >= c.shape[0] - 9).any()  # the planted top docs


def test_c_split_windows_and_fallback(monkeypatch):
    """c_split runs one gmax per sequential window (the windows partition
    the blocks), and falls back to one window when they would hold too
    few blocks to select k from."""
    c, _, q, _ = all_negative_case()
    prep = cm.prepare_plain_corpus(c)
    windows = []
    real = cm.fused_plain_gmax

    def spy(queries, plain, blk_lo=0, n_blk=None, **kw):
        windows.append((blk_lo, n_blk))
        return real(queries, plain, blk_lo, n_blk, **kw)

    monkeypatch.setattr(cm, "fused_plain_gmax", spy)
    cm.plain_topk_prepared(q, prep, 12, c_split=3)
    assert windows == [(0, 256), (256, 256), (512, 128)]
    windows.clear()
    cm.plain_topk_prepared(q, prep, 200, c_split=3)  # 640 // 3 // 2 <= 200
    assert windows == [(0, 640)]


def test_segmented_search_refuses_c_split_and_pipeline():
    c, _, q, _ = all_negative_case()
    prep = cm.prepare_plain_corpus(c, n_segs=2)
    with pytest.raises(ValueError, match="c_split"):
        cm.plain_topk_prepared(q, prep, 12, c_split=2)
    with pytest.raises(ValueError, match="pipeline"):
        cm.plain_topk_prepared(q, prep, 12, pipeline=True)


def test_segmented_tiny_corpus_falls_back_to_the_scan():
    c, _ = corpus_pair(80, 8 * 300 + 3, 8)
    q, _ = corpus_pair(81, 3, 8)
    prep = cm.prepare_plain_corpus(c, n_segs=2)
    assert len(prep.plain) == 2
    got = cm.plain_topk_prepared(q, prep, 200)  # 300 // 2 <= 200
    assert_same_topk(got[0], got[1], *brute(q, c, 200))


def test_segmented_searcher_matches_jax_pallas_searcher():
    """tests/test_mips.py's segmented Searcher case: NB = 257 blocks, two
    tiles at the serving tile of 256 blocks, a tail of 5."""
    rng = np.random.RandomState(4)
    q_np = rng.randn(7, 16).astype(np.float32)
    c_np = rng.randn(2061, 16).astype(np.float32)
    q = torch.from_numpy(q_np).to(torch.bfloat16)
    c = torch.from_numpy(c_np).to(torch.bfloat16)
    j = jmips.Searcher(jnp.asarray(c.float().numpy()), k=10, method="pallas",
                       n_segs=2)
    want = j.search(jnp.asarray(q.float().numpy()))
    searcher = mips.Searcher(c, k=10, method="kernel", n_segs=2)
    assert [s.shape[0] for s in searcher._prep.plain] == [2048, 8]
    got = searcher.search(q)
    assert searcher.last_dispatch == "kernel-segmented:cpu"
    assert_same_topk(got[0], got[1], want[0], want[1])
    assert_same_topk(got[0], got[1], *brute(q, c, 10))


def test_segmented_searcher_needs_the_kernel_path():
    c, _ = corpus_pair(90, 2061, 8)
    with pytest.raises(ValueError, match="n_segs"):
        mips.Searcher(c, k=10, n_segs=2)  # "auto" on a CPU tensor: "plain"
    with pytest.raises(ValueError, match="n_segs"):
        mips.Searcher(c, k=10, method="plain", n_segs=2)


# ---- Retriever ---------------------------------------------------------------


def test_index_tensor_casts_on_the_host(monkeypatch):
    """No fp32 copy of the index is ever handed to the device transfer."""
    moved = []
    real_to = torch.Tensor.to

    def spy(self, *args, **kwargs):
        if "device" in kwargs or any(
                isinstance(a, (torch.device, str)) for a in args):
            moved.append(self.dtype)
        return real_to(self, *args, **kwargs)

    r = Retriever(None, DataArguments(), InferenceArguments(), 0, "cpu")
    r.doc_embeddings = np.random.RandomState(91).randn(40, 8).astype(
        np.float32)
    monkeypatch.setattr(torch.Tensor, "to", spy)
    index = r.index_tensor()
    assert index.dtype == torch.bfloat16 and moved == [torch.bfloat16]


@pytest.mark.parametrize("method", ["kernel", "pallas"])
def test_retriever_search_builds_a_segmented_searcher(method):
    c, _ = corpus_pair(92, 8 * 640 + 5, 16)
    q, _ = corpus_pair(93, 3, 16)
    infer = InferenceArguments(search_method=method, search_n_segs=2)
    r = Retriever(None, DataArguments(), infer, 0, "cpu")
    r.doc_embeddings = c.float().numpy()
    r.doc_ids = [f"d{i}" for i in range(c.shape[0])]
    got = r.search(q.float().numpy(), ["a", "b", "c"], topk=12)
    assert len(r._searcher._prep.plain) == 2
    assert r._searcher.last_dispatch == "kernel-segmented:cpu"
    ws, wi = brute(q, c, 12)
    for row, qid in enumerate(["a", "b", "c"]):
        assert set(got[qid]) == {f"d{i}" for i in wi[row]}


def test_retriever_search_takes_approx():
    """search_method="approx" runs the plain path (full scores, exact
    top-k), which meets JAX's 0.99-recall contract with recall 1."""
    c, _ = corpus_pair(94, 8 * 640 + 5, 16)
    q, _ = corpus_pair(95, 3, 16)
    infer = InferenceArguments(search_method="approx", search_n_segs=1)
    r = Retriever(None, DataArguments(), infer, 0, "cpu")
    r.doc_embeddings = c.float().numpy()
    r.doc_ids = [f"d{i}" for i in range(c.shape[0])]
    got = r.search(q.float().numpy(), ["a", "b", "c"], topk=12)
    assert r._searcher.method == "plain"
    assert r._searcher.last_dispatch == "plain:cpu"
    _, wi = brute(q, c, 12)
    for row, qid in enumerate(["a", "b", "c"]):
        assert set(got[qid]) == {f"d{i}" for i in wi[row]}


@pytest.mark.parametrize("tiles,n_segs,want_segs", [(66, 65, 64),
                                                    (10, 200, 10)])
def test_retriever_clamps_the_segment_count(caplog, tiles, n_segs, want_segs):
    """--search_n_segs past the tile count takes one segment per 256-block
    tile, as JAX's split_tiles does; past the kernels' 64 it takes 64 with
    one warning. The answers equal the JAX package's exact search."""
    c, c_j = corpus_pair(96, tiles * 2048 + 5, 16)
    q, q_j = corpus_pair(97, 3, 16)
    infer = InferenceArguments(search_method="kernel", search_n_segs=n_segs)
    r = Retriever(None, DataArguments(), infer, 0, "cpu")
    r.doc_embeddings = c.float().numpy()
    r.doc_ids = [str(i) for i in range(c.shape[0])]
    with caplog.at_level("WARNING", logger=cm.__name__):
        got = r.search(q.float().numpy(), ["a", "b", "c"], topk=10)
    segs = r._searcher._prep.plain
    assert len(segs) == want_segs
    assert len({s.untyped_storage().data_ptr() for s in segs}) == want_segs
    warnings = [rec for rec in caplog.records if rec.name == cm.__name__]
    assert len(warnings) == (want_segs < min(tiles, n_segs))
    if warnings:
        assert f"n_segs={n_segs}" in warnings[0].getMessage()
        assert f"{want_segs} segments" in warnings[0].getMessage()
    ws, wi = jmips.exact_search(q_j, c_j, k=10)
    for row, qid in enumerate(["a", "b", "c"]):
        ids = sorted(got[qid], key=lambda d: -got[qid][d])
        assert_same_topk(np.array([[got[qid][d] for d in ids]]),
                         np.array([[int(d) for d in ids]]),
                         np.asarray(ws)[row:row + 1],
                         np.asarray(wi)[row:row + 1])


def test_prepare_plain_corpus_refuses_no_segments():
    c, _ = corpus_pair(98, 64, 8)
    with pytest.raises(ValueError, match="n_segs"):
        cm.prepare_plain_corpus(c, n_segs=0)


def test_retriever_auto_on_cpu_refuses_segments():
    infer = InferenceArguments(search_n_segs=2)  # search_method="auto"
    r = Retriever(None, DataArguments(), infer, 0, "cpu")
    r.doc_embeddings = np.zeros((64, 8), np.float32)
    r.doc_ids = [str(i) for i in range(64)]
    with pytest.raises(ValueError, match="n_segs"):
        r.search(np.zeros((1, 8), np.float32), ["q"], topk=5)
