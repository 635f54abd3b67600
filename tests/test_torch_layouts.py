"""The alternative exact-search layouts of the port (``ops/cuda_mips.py``:
the block-row, score-materializing and strided hier2 paths, and their
kernels' plain versions) against the JAX package's ``pallas_mips`` on the
CPU. The JAX side runs its Pallas kernels in interpret mode, as
tests/test_pallas_mips.py runs them; inputs are made with numpy from a
seed.

Tolerances: fp32 inputs, scores rel 1e-5 (fp32 sums in another order);
bf16-valued inputs, 1e-3 x max|score| (chip_smoke's REL_TOL); entries
masked to finfo(float32).min bit-equal. Ids are compared as sets above the
k-th score's tie band, since equal scores may come back in any order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmatch_tpu.ops import mips as jmips
from openmatch_tpu.ops import pallas_mips as pm
from openmatch_tpu_torch.ops import cuda_mips as cm
from openmatch_tpu_torch.ops import mips

torch.set_num_threads(2)
RTOL = 1e-5
REL_TOL = 1e-3
NEG = np.finfo(np.float32).min
TILE_G, TILE_Q = 128, 8  # the JAX kernels' test tiles


def fp32_pair(seed, *shape):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return torch.from_numpy(x), jnp.asarray(x)


def bf16_pair(seed, *shape):
    """A bf16 tensor for the port and the same values as fp32 for JAX."""
    x = torch.from_numpy(np.random.RandomState(seed).randn(*shape).astype(
        np.float32)).to(torch.bfloat16)
    return x, jnp.asarray(x.float().numpy())


def assert_kernel_match(got: torch.Tensor, want):
    """Masked entries bit-equal, the rest within REL_TOL * max|want|."""
    got, want = got.float().numpy(), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got == NEG, want == NEG)
    live = want != NEG
    np.testing.assert_allclose(got[live], want[live], rtol=0,
                               atol=REL_TOL * np.abs(want[live]).max())


def assert_same_topk(s_got, i_got, s_want, i_want):
    s_got, i_got = np.asarray(s_got), np.asarray(i_got)
    s_want, i_want = np.asarray(s_want), np.asarray(i_want)
    assert s_got.shape == s_want.shape and i_got.shape == i_want.shape
    np.testing.assert_allclose(s_got, s_want, rtol=RTOL, atol=1e-6)
    assert (np.diff(s_got, axis=1) <= 0).all()
    for r in range(s_got.shape[0]):
        band = s_want[r, -1] + RTOL * np.abs(s_want[r]).max()
        assert set(i_got[r][s_got[r] > band].tolist()) \
            == set(i_want[r][s_want[r] > band].tolist())


def brute(q, c, k):
    s = q.float().numpy() @ c.float().numpy().T
    i = np.argsort(-s, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(s, i, axis=1), i


# ---- (a) the kernel wrappers' plain versions against the JAX kernels --------


def test_fused_block_gmax_matches_jax():
    NB, D, Q = 2 * TILE_G, 32, 8
    c, c_j = bf16_pair(0, NB * 8, D)
    q, q_j = bf16_pair(1, Q, D)
    prep = cm.prepare_block_corpus(c)
    want = pm.fused_block_gmax(q_j, c_j.reshape(NB, 8 * D), tile_g=TILE_G,
                               tile_q=TILE_Q)
    got = cm.fused_block_gmax(q, prep.cb)
    assert_kernel_match(got, want)
    # the block-row layout is the doc-major one: K7 equals K2 on it
    np.testing.assert_array_equal(got.numpy(),
                                  cm.fused_plain_gmax(q, prep.plain).numpy())


def test_fused_scores_matches_jax():
    c, c_j = bf16_pair(2, 4096, 32)
    q, q_j = bf16_pair(3, 8, 32)
    want = pm.fused_scores(q_j, c_j, tile=1024, tile_q=TILE_Q)
    assert_kernel_match(cm.fused_scores(q, c), want)


@pytest.mark.parametrize("N", [4096, 4096 - 203])
def test_fused_score_gmax_matches_jax(N):
    """N % tile == 0: JAX's kernel as it is. A ragged last tile: what
    pallas_hier2_search makes of it, a zero-padded corpus with the pad
    scores masked and the last tile's maxima taken again."""
    tile = 1024
    c, c_j = bf16_pair(4, N, 32)
    q, q_j = bf16_pair(5, 8, 32)
    pad = (-N) % tile
    scores, gmax = pm.fused_score_gmax(
        q_j, jnp.pad(c_j, ((0, pad), (0, 0))), tile=tile, tile_q=TILE_Q)
    if pad:
        scores = jnp.where(jnp.arange(N + pad)[None] < N, scores, NEG)
        gmax = gmax.at[:, -(tile // 8):].set(
            pm._slab_gmax(scores[:, -tile:]))
    got_s, got_g = cm.fused_score_gmax(q, c, tile=tile)
    assert_kernel_match(got_s, scores)
    assert_kernel_match(got_g, gmax)
    np.testing.assert_array_equal(
        cm.fused_gmax_only(q, c, tile=tile).numpy(), got_g.numpy())


@pytest.mark.parametrize("N", [4096, 4096 - 203])
def test_fused_gmax_only_matches_jax(N):
    """N % tile == 0: JAX's kernel; a ragged last tile: what
    pallas_hier2_rescore makes of it (kernel on the whole tiles, the tail
    tile's strided maxima over masked scores)."""
    tile = 1024
    c, c_j = bf16_pair(6, N, 32)
    q, q_j = bf16_pair(7, 8, 32)
    aligned = N // tile * tile
    want = pm.fused_gmax_only(q_j, c_j[:aligned], tile=tile, tile_q=TILE_Q)
    if N > aligned:
        tail = jnp.pad(q_j @ c_j[aligned:].T,
                       ((0, 0), (0, tile - N + aligned)), constant_values=NEG)
        want = jnp.concatenate([want, pm._slab_gmax(tail)], axis=1)
    assert_kernel_match(cm.fused_gmax_only(q, c, tile=tile), want)


def test_slab_gmax_matches_jax():
    x, x_j = fp32_pair(8, 3, 2048)
    np.testing.assert_array_equal(cm._slab_gmax(x).numpy(),
                                  np.asarray(pm._slab_gmax(x_j)))
    per_tile = torch.cat([cm._slab_gmax(x[:, :1024]),
                          cm._slab_gmax(x[:, 1024:])], 1)
    np.testing.assert_array_equal(cm._slab_gmax(x, 1024).numpy(),
                                  per_tile.numpy())


# ---- selection helpers -------------------------------------------------------


@pytest.mark.parametrize("C,k", [(8000, 37), (8003, 37), (800, 100)])
def test_hier_topk_matches_jax(C, k):
    """Two-level selection (C % 8 == 0 and n_groups > k) and its plain
    top-k fallbacks."""
    x, x_j = fp32_pair(9, 4, C)
    s_want, i_want = jmips._hier_topk(x_j, k)
    assert_same_topk(*mips._hier_topk(x, k), s_want, i_want)


@pytest.mark.parametrize("fanout", [4, 16])
def test_select_groups_fanout_matches_jax(fanout):
    """A uniform fanout other than 8: the same levels as JAX's integer
    ``fanout`` and the true top-k maxima."""
    W, k = 70001, 37
    g = np.random.RandomState(10).randn(3, W).astype(np.float32)
    assert mips.pyramid_fanouts(W, k, fanout) == (fanout,) * {4: 5, 16: 2}[
        fanout]
    want = np.asarray(jmips._select_groups(jnp.asarray(g), k, fanout=fanout))
    got = mips._select_groups(torch.from_numpy(g), k, fanout).numpy()
    for r in range(3):
        top = np.sort(g[r])[::-1][:k]
        np.testing.assert_array_equal(np.sort(g[r, want[r]])[::-1], top)
        np.testing.assert_array_equal(np.sort(g[r, got[r]])[::-1], top)


# ---- (b) each path against its JAX function --------------------------------

SHAPES = [(70000, 50), (66003, 64)]


@pytest.fixture(scope="module")
def shape_data():
    """(q, corpus) pairs for each (N, k), torch and JAX, made once."""
    return {N: (fp32_pair(11, 8, 32), fp32_pair(12, N, 32))
            for N, _ in SHAPES}


@pytest.fixture(scope="module")
def jax_answers():
    """The JAX functions' answers, each computed once per module."""
    return {}


def jax_answer(cache, path, N, k, q_j, c_j):
    key = (path, N, k)
    if key not in cache:
        if path.startswith("hier2_search"):
            out = pm.pallas_hier2_search(q_j, c_j, k=k,
                                         tile=int(path.split("_")[-1]))
        elif path.startswith("hier2_rescore"):
            out = pm.pallas_hier2_rescore(q_j, c_j, k=k,
                                          tile=int(path.split("_")[-1]))
        elif path == "block_topk":
            out = pm.pallas_block_topk(q_j, c_j, k=k, tile_g=TILE_G,
                                       tile_q=TILE_Q, qb=4)
        else:
            prep = pm.prepare_block_corpus(c_j, tile_g=TILE_G)
            if path == "block_score_topk_prepared":
                out = pm.pallas_block_score_topk_prepared(
                    q_j, prep, k=k, tile_g=TILE_G, tile_q=TILE_Q)
            else:
                out = pm.pallas_block_topk_prepared(
                    q_j, prep, k=k, tile_g=TILE_G, tile_q=TILE_Q, qb=4,
                    rescore=path.split("_")[-1])
        cache[key] = tuple(np.asarray(x) for x in out)
    return cache[key]


def port_answer(path, q, c, k):
    if path.startswith("hier2_search"):
        return cm.hier2_search(q, c, k, tile=int(path.split("_")[-1]))
    if path.startswith("hier2_rescore"):
        return cm.hier2_rescore(q, c, k, tile=int(path.split("_")[-1]))
    if path == "block_topk":
        return cm.block_topk(q, c, k, qb=3)
    prep = cm.prepare_block_corpus(c)
    if path == "block_score_topk_prepared":
        return cm.block_score_topk_prepared(q, prep, k)
    return cm.block_topk_prepared(q, prep, k, qb=5,
                                  rescore=path.split("_")[-1])


PATHS = ["block_topk", "block_topk_prepared_xla", "block_topk_prepared_dma",
         "block_score_topk_prepared", "hier2_search_2048",
         "hier2_search_1024", "hier2_rescore_2048", "hier2_rescore_1024"]


@pytest.mark.parametrize("N,k", SHAPES)
@pytest.mark.parametrize("path", PATHS)
def test_path_matches_jax(shape_data, jax_answers, path, N, k):
    (q, q_j), (c, c_j) = shape_data[N]
    got = port_answer(path, q, c, k)
    assert got[1].dtype == torch.int64
    assert_same_topk(got[0], got[1],
                     *jax_answer(jax_answers, path, N, k, q_j, c_j))
    assert_same_topk(got[0], got[1], *brute(q, c, k))


# ---- (c) adversarial cases, against brute force ----------------------------


@pytest.mark.parametrize("fn", [cm.hier2_search, cm.hier2_rescore])
def test_clustered_strided_group(fn):
    """The top-k packed into one strided group (tile 1024, gw 128: docs
    5 + m * 128) plus one doc elsewhere must be found exactly."""
    q = torch.ones(1, 4)
    c = torch.zeros(131072, 4)
    cols = [5 + m * 128 for m in range(8)]
    c[cols] = 3.0
    c[70000] = 2.0
    _, i = fn(q, c, k=9, tile=1024)
    assert set(i[0].tolist()) == set(cols) | {70000}


BLOCK_PATHS = {
    "block_topk": lambda q, c, k: cm.block_topk(q, c, k, qb=1),
    "xla": lambda q, c, k: cm.block_topk_prepared(
        q, cm.prepare_block_corpus(c), k),
    "dma": lambda q, c, k: cm.block_topk_prepared(
        q, cm.prepare_block_corpus(c), k, rescore="dma"),
    "score": lambda q, c, k: cm.block_score_topk_prepared(
        q, cm.prepare_block_corpus(c), k),
}


@pytest.mark.parametrize("path", sorted(BLOCK_PATHS))
def test_clustered_block_and_tail(path):
    """All top docs in one contiguous 8-doc block, plus one in the ragged
    tail of 5."""
    q = torch.ones(1, 4)
    N = 131072 + 5
    c = torch.zeros(N, 4)
    cols = list(range(4096, 4104))
    c[cols] = 3.0
    c[N - 2] = 2.0
    _, i = BLOCK_PATHS[path](q, c, 9)
    assert set(i[0].tolist()) == set(cols) | {N - 2}


ALL_PATHS = dict(BLOCK_PATHS, **{
    "hier2_search": lambda q, c, k: cm.hier2_search(q, c, k, tile=1024),
    "hier2_rescore": lambda q, c, k: cm.hier2_rescore(q, c, k, tile=1024),
})


@pytest.mark.parametrize("path", sorted(ALL_PATHS))
def test_all_negative_scores_with_ragged_tile(path):
    """Every real score is negative and the last tile is ragged: the rows
    past N (which would score 0) must never displace a real doc."""
    c = torch.from_numpy(np.abs(np.random.RandomState(13).randn(
        66003, 4)).astype(np.float32))
    q = -torch.ones(1, 4)
    s, i = ALL_PATHS[path](q, c, 30)
    assert_same_topk(s, i, *brute(q, c, 30))


@pytest.mark.parametrize("path", ["hier2_rescore", "xla"])
def test_forty_queries(path):
    """40 queries: more than one query chunk of 32 (hier2_rescore) or 16
    (the block rows' rescore), the last one ragged."""
    q, _ = fp32_pair(14, 40, 32)
    c, _ = fp32_pair(15, 70000, 32)
    s, i = ALL_PATHS[path](q, c, 20)
    assert_same_topk(s, i, *brute(q, c, 20))


# ---- (d) refusals and the small-corpus fallbacks ---------------------------


def test_paths_that_need_plain_refuse_without_it():
    q, _ = fp32_pair(16, 2, 16)
    c, _ = fp32_pair(17, 8 * 300 + 3, 16)
    prep = cm.prepare_block_corpus(c, with_plain=False)
    assert prep.plain is None and prep.cb is not None
    with pytest.raises(ValueError, match="with_plain=True"):
        cm.block_topk_prepared(q, prep, k=10, rescore="dma")
    with pytest.raises(ValueError, match="with_plain=False"):
        cm.block_score_topk_prepared(q, prep, k=10)
    with pytest.raises(ValueError, match="rescore"):
        cm.block_topk_prepared(q, prep, k=10, rescore="pallas")
    with pytest.raises(ValueError, match="cb is None"):
        cm.block_topk_prepared(q, cm.prepare_plain_corpus(c), k=10)
    with pytest.raises(ValueError, match="tile"):
        cm.hier2_search(q, c, k=10, tile=1000)
    # the score-free xla rescore does not need plain
    assert_same_topk(*cm.block_topk_prepared(q, prep, k=10), *brute(q, c, 10))


@pytest.mark.parametrize("path", sorted(ALL_PATHS))
def test_small_corpus_fallbacks(path):
    """NB // 2 <= k (block paths), n_groups // 8 <= k (hier2_search) and
    N < tile (hier2_rescore) take the exact fallbacks: k distinct docs,
    as JAX's fallbacks return; a dma rescore without ``plain`` is not
    reached, as in JAX."""
    q, q_j = fp32_pair(18, 3, 16)
    c, c_j = fp32_pair(19, 8 * 20 + 3, 16)
    if path == "dma":
        prep = cm.prepare_block_corpus(c, with_plain=False)
        got = cm.block_topk_prepared(q, prep, 20, rescore="dma")
        want = pm.pallas_block_topk_prepared(
            q_j, pm.prepare_block_corpus(c_j, tile_g=TILE_G, with_plain=False),
            k=20, tile_g=TILE_G, tile_q=TILE_Q, rescore="dma")
        assert_same_topk(*got, *want)
    else:
        got = ALL_PATHS[path](q, c, 20)
    assert all(len(set(r.tolist())) == 20 for r in got[1])
    assert_same_topk(*got, *brute(q, c, 20))


# ---- (e) the block-row layout is a view -------------------------------------


def test_prepare_block_corpus_views_the_corpus():
    c = torch.randn(8 * 50 + 3, 16).to(torch.bfloat16)
    prep = cm.prepare_block_corpus(c)
    assert prep.n_docs == 403 and prep.cb.shape == (50, 128)
    for t in (prep.cb, prep.plain, prep.tail):
        assert t.untyped_storage().data_ptr() == c.untyped_storage().data_ptr()
    assert prep.cb.data_ptr() == prep.plain.data_ptr() == c.data_ptr()
    torch.testing.assert_close(prep.cb.reshape(400, 16), c[:400])
    torch.testing.assert_close(prep.tail, c[400:])
    with pytest.raises(ValueError, match="contiguous"):
        cm.prepare_block_corpus(c.T.contiguous().T)


def test_prepare_block_corpus_with_plain_rule():
    """JAX's default: ``plain`` kept iff N * D * 2 <= 4 GiB (meta tensors:
    no memory)."""
    D = 1024
    small = torch.empty((2**21, D), dtype=torch.bfloat16, device="meta")
    big = torch.empty((2**21 + 8, D), dtype=torch.bfloat16, device="meta")
    assert cm.prepare_block_corpus(small).plain is not None
    assert cm.prepare_block_corpus(big).plain is None
    assert cm.prepare_block_corpus(big, with_plain=True).plain is not None
    assert cm.prepare_block_corpus(small, with_plain=False).plain is None
