"""The port's exact search (ops/mips.py, ops/cuda_mips.py) on the CPU
against the JAX package: ``_select_groups``, ``gather_row_slices``,
``exact_search``, the kernel pipeline core and ``Searcher(method="pallas")``
(Pallas in interpret mode).

Tolerances: scores atol 1e-4 (fp32 sums in another order); ids compared as
sets above the k-th score's tie band (scores > s_k + 1e-4), because equal
scores may be returned in any order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmatch_tpu.ops import mips as jmips
from openmatch_tpu.ops import pallas_mips as pm
from openmatch_tpu_torch.ops import cuda_mips as cm
from openmatch_tpu_torch.ops import mips

torch.set_num_threads(2)
ATOL = 1e-4


def corpus_pair(seed, N, D, scale=1.0, transform=None):
    x = np.random.RandomState(seed).randn(N, D).astype(np.float32) * scale
    if transform is not None:
        x = transform(x)
    t = torch.from_numpy(x).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy())


def assert_same_topk(s_got, i_got, s_want, i_want):
    s_got, i_got = np.asarray(s_got), np.asarray(i_got)
    s_want, i_want = np.asarray(s_want), np.asarray(i_want)
    assert s_got.shape == s_want.shape and i_got.shape == i_want.shape
    np.testing.assert_allclose(s_got, s_want, atol=ATOL, rtol=0)
    assert (np.diff(s_got, axis=1) <= 0).all()
    for r in range(s_got.shape[0]):
        band = s_want[r, -1] + ATOL
        assert set(i_got[r][s_got[r] > band].tolist()) \
            == set(i_want[r][s_want[r] > band].tolist())


def brute(q, c, k):
    s = q.float().numpy() @ c.float().numpy().T
    i = np.argsort(-s, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(s, i, axis=1), i


# ---- selection -------------------------------------------------------------


@pytest.mark.parametrize("W,k", [(70001, 37), (9000, 1000), (4096, 16)])
def test_select_groups_matches_jax(W, k):
    """Selected maxima multisets equal the JAX pyramid's (fanout 8) and the
    true top-k maxima, self-built and with a precomputed level 1."""
    g = np.random.RandomState(1).randn(3, W).astype(np.float32)
    want = np.asarray(jmips._select_groups(jnp.asarray(g), k, fanout=8))
    got = mips._select_groups(torch.from_numpy(g), k).numpy()
    fanouts = mips.pyramid_fanouts(W, k)
    if fanouts:
        pad = (-W) % 8
        l1 = np.pad(g, ((0, 0), (0, pad)), constant_values=mips.NEG
                    ).reshape(3, -1, 8).max(-1)
        got_l1 = mips._select_groups(torch.from_numpy(g), k,
                                     l1=torch.from_numpy(l1)).numpy()
    for r in range(3):
        top = np.sort(g[r])[::-1][:k]
        np.testing.assert_array_equal(np.sort(g[r, want[r]])[::-1], top)
        np.testing.assert_array_equal(np.sort(g[r, got[r]])[::-1], top)
        if fanouts:
            np.testing.assert_array_equal(np.sort(g[r, got_l1[r]])[::-1], top)


def test_select_groups_clustered_maxima():
    """All top values inside one fanout subtree: siblings must survive."""
    W, k = 40000, 16
    g = np.zeros((1, W), np.float32)
    g[0, 512:512 + k] = np.arange(k, 0, -1)
    ids = mips._select_groups(torch.from_numpy(g), k)[0].tolist()
    assert set(ids) == set(range(512, 512 + k))


def test_gather_row_slices_matches_jax():
    rng = np.random.RandomState(2)
    arr = rng.randn(4, 96).astype(np.float32)
    starts = rng.randint(0, 12, size=(4, 5)) * 8
    want = jmips.gather_row_slices(jnp.asarray(arr),
                                   jnp.asarray(starts, jnp.int32), 8)
    got = mips.gather_row_slices(torch.from_numpy(arr),
                                 torch.from_numpy(starts), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # a ragged width reads the missing members as finfo.min
    ragged = mips.gather_row_slices(torch.from_numpy(arr[:, :90]),
                                    torch.tensor([[88]]).expand(4, 1), 8)
    np.testing.assert_array_equal(ragged[:, 0, :2].numpy(), arr[:, 88:90])
    assert (ragged[:, 0, 2:] == mips.NEG).all()


# ---- exact search ----------------------------------------------------------


@pytest.mark.parametrize("valid_rows", [None, 2901])
def test_exact_search_matches_jax(valid_rows):
    c, c_j = corpus_pair(3, 3000, 16)
    q, q_j = corpus_pair(4, 5, 16)
    want = jmips.exact_search(q_j, c_j, k=40, chunk_size=700,
                              valid_rows=valid_rows)
    got = mips.exact_search(q, c, k=40, chunk_size=700, valid_rows=valid_rows)
    assert_same_topk(got[0], got[1], want[0], want[1])
    if valid_rows is not None:
        assert (got[1] < valid_rows).all()


def test_plain_topk_core_masks_zero_pad_rows_like_jax():
    """All real scores are negative and the body carries zero pad rows
    (scoring 0): the pads must never displace a real doc."""
    N, D, k = 8 * 900 + 5, 16, 25
    c, c_j = corpus_pair(5, N, D, transform=np.abs)
    q = -torch.ones(2, D, dtype=torch.bfloat16)
    nb = N // 8
    NBp = 1024  # 8 tiles of 128 blocks
    body = torch.cat([c[:nb * 8], torch.zeros((NBp - nb) * 8, D,
                                              dtype=torch.bfloat16)])
    body_j = jnp.asarray(body.float().numpy())
    got = cm._plain_topk_core(q, body, c[nb * 8:], N, k)
    want = pm._plain_topk_core(jnp.asarray(q.float().numpy()), body_j,
                               c_j[nb * 8:], N, k, 128, 8)
    assert_same_topk(got[0], got[1], want[0], want[1])
    assert (got[1] < N).all()
    assert_same_topk(got[0], got[1], *brute(q, c, k))


# ---- the Searcher ------------------------------------------------------------


CASES = {
    # (N, corpus transform): what each case exercises. Q = 3, D = 16 and
    # k = 12 throughout, and N mostly within one 2048-row tile count of the
    # JAX layout, so its interpret-mode kernels compile few times.
    "pyramid_ragged_tail": (5003, None),    # K1 mode, N % 8 = 3
    "no_pyramid_level": (800, None),        # K2 mode: NB / 8 <= k
    "all_negative": (5001, np.abs),         # JAX's zero pads would score 0
    "tiny_corpus": (30, None),              # NB // 2 <= k: exact_search
    "ties": (5000, lambda x: np.repeat(x[:625], 8, axis=0)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_searcher_matches_jax_pallas_searcher(case):
    N, transform = CASES[case]
    D, Q, k = 16, 3, 12
    c, c_j = corpus_pair(6, N, D, transform=transform)
    q, q_j = corpus_pair(7, Q, D)
    if case == "all_negative":
        q, q_j = -q.abs(), -jnp.abs(q_j)
    want = jmips.Searcher(c_j.astype(jnp.bfloat16), k=k,
                          method="pallas").search(q_j.astype(jnp.bfloat16))
    searcher = mips.Searcher(c, k=k, method="kernel")
    got = searcher.search(q)
    assert searcher.last_dispatch == "kernel:cpu"
    assert_same_topk(got[0], got[1], want[0], want[1])
    assert_same_topk(got[0], got[1], *brute(q, c, k))
    plain = mips.Searcher(c, k=k)  # "auto" on a CPU tensor is "plain"
    assert plain.method == "plain"
    assert_same_topk(*plain.search(q), want[0], want[1])


def jax_search_methods():
    """The search_method names the JAX package's InferenceArguments lists
    in its help text ("exact-MIPS engine: auto (...) | pallas | ...")."""
    import dataclasses

    from openmatch_tpu.config import InferenceArguments as JaxArgs

    (field,) = [f for f in dataclasses.fields(JaxArgs)
                if f.name == "search_method"]
    listed = field.metadata["help"].split(":", 1)[1].split("|")
    return [name.split()[0] for name in listed]


def test_build_searcher_takes_every_jax_search_method():
    """Every search_method of the JAX package builds a Searcher that
    answers as brute force; "approx" (JAX: full scores, approx_max_k) is
    the plain path's full scores with an exact top-k."""
    from openmatch_tpu_torch.config import InferenceArguments
    from openmatch_tpu_torch.retriever.retriever import build_searcher

    names = jax_search_methods()
    assert "approx" in names and len(names) == 7
    c, _ = corpus_pair(12, 5003, 16)
    q, _ = corpus_pair(13, 3, 16)
    for name in names:
        searcher = build_searcher(c, InferenceArguments(search_method=name),
                                  k=12)
        if name == "approx":
            assert searcher.method == "plain"
        assert_same_topk(*searcher.search(q), *brute(q, c, 12))


def test_searcher_rejects_unknown_method():
    with pytest.raises(ValueError, match="method"):
        mips.Searcher(torch.zeros(16, 4), method="approx")


# ---- search methods (exact_search(method=...), hier2, pyramid) --------------


@pytest.mark.parametrize("method", ["hier", "hier2", "pyramid", "topk",
                                    "approx"])
@pytest.mark.parametrize("chunk_size", [0, 1600])
def test_exact_search_methods_match_jax(method, chunk_size):
    """Each of JAX's _chunk_topk methods, in one chunk of 3200 rows and in
    two of 1600 (both wide enough for hier2's supergroups and a pyramid
    level at k=5); "approx" is exact torch.topk in the port."""
    c, c_j = corpus_pair(8, 3200, 16)
    q, q_j = corpus_pair(9, 4, 16)
    want = jmips.exact_search(q_j, c_j, k=5, chunk_size=chunk_size,
                              method=method)
    got = mips.exact_search(q, c, k=5, chunk_size=chunk_size, method=method)
    assert_same_topk(got[0], got[1], want[0], want[1])
    assert_same_topk(got[0], got[1], *brute(q, c, 5))


@pytest.mark.parametrize("name", ["_hier_topk", "_hier2_topk",
                                  "_pyramid_topk"])
@pytest.mark.parametrize("C,k", [(64 * 40, 7), (64 * 40, 100), (1000, 7),
                                 (64 * 300, 16)])
def test_grouped_topk_matches_jax(name, C, k):
    """Two-level, three-level and pyramid top-k of a score matrix, with a
    run of tied columns; widths that take each function's fallback too
    (C % 64 != 0, too few supergroups or pyramid levels)."""
    s = np.random.RandomState(10).randn(3, C).astype(np.float32)
    s[:, 40:56] = s[:, 39:40]
    want = getattr(jmips, name)(jnp.asarray(s), k)
    got = getattr(mips, name)(torch.from_numpy(s), k)
    top = -np.sort(-s, axis=1)[:, :k]
    np.testing.assert_array_equal(got[0].numpy(), top)
    assert_same_topk(got[0], got[1], want[0], want[1])
    np.testing.assert_array_equal(
        np.take_along_axis(s, got[1].numpy(), 1), got[0].numpy())


@pytest.mark.parametrize("W,k,plan", [(70000, 37, (8, 8)), (70000, 37, (16,)),
                                      (9000, 100, (4, 8)),
                                      (70000, 37, (8, 8, 8))])
def test_select_groups_tuple_fanouts_match_jax(W, k, plan):
    """JAX's finest-first fanout tuples, self-built and with a precomputed
    level 1: the same groups as the JAX pyramid, and the true top-k."""
    g = np.random.RandomState(11).randn(3, W).astype(np.float32)
    want = np.asarray(jmips._select_groups(jnp.asarray(g), k, fanout=plan))
    got = mips._select_groups(torch.from_numpy(g), k, fanout=plan).numpy()
    l1 = torch.from_numpy(g.reshape(3, -1, plan[0]).max(-1))
    got_l1 = mips._select_groups(torch.from_numpy(g), k, fanout=plan,
                                 l1=l1).numpy()
    for r in range(3):
        top = np.sort(g[r])[::-1][:k]
        assert set(got[r].tolist()) == set(want[r].tolist())
        np.testing.assert_array_equal(np.sort(g[r, got[r]])[::-1], top)
        np.testing.assert_array_equal(np.sort(g[r, got_l1[r]])[::-1], top)
    with pytest.raises(ValueError, match="fanouts"):
        mips._select_groups(torch.from_numpy(g), k, fanout=(8, 1))
