"""The port's mesh search (``ops/mips.py``: ``sharded_search``,
``query_sharded_search``, ``Searcher(mesh=, partition=, n_segs=)``;
``ops/cuda_mips.py``: ``pad_plain``, ``plain_topk_valid``) on 2 gloo ranks
(``spawn_ranks`` once for the module; the bodies in ``tests/torch_ranks.py``)
against brute force and the JAX package's mesh ``Searcher`` on 2 of the
conftest's host devices, mirroring JAX's ``tests/test_mips.py`` and
``tests/test_pallas_mips.py``:

- both partitions, plain and kernel (on the CPU the kernel wrappers run
  their plain versions): ids equal brute force's, scores within rtol 1e-5
  (1e-4 where JAX's test takes it), every rank the same answer;
- k above a shard's rows returns k; a padded corpus; zero pad rows never
  evict all-negative real scores, and a shard of 5 valid rows (or none)
  fills its slots with -inf; query padding; a host bf16 index; the
  segmented queries partition (K4 and K5's path); a host index of which
  each rank reads only its own rows; the ``Retriever`` with a mesh equal
  to one process.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torch_ranks as tr
from openmatch_tpu_torch.models.jax_convert import params_from_jax
from openmatch_tpu_torch.ops import cuda_mips as cm
from openmatch_tpu_torch.ops.mips import Searcher
from openmatch_tpu_torch.parallel.mesh import spawn_ranks
from openmatch_tpu_torch.retriever.retriever import Retriever
from torch_ranks import seeded

torch.set_num_threads(2)
CASES = tr.search_cases()


def brute(q, c, k):
    s = q.astype(np.float64) @ c.astype(np.float64).T
    i = np.argsort(-s, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(s, i, 1), i


@pytest.fixture(scope="module")
def jx():
    import jax

    from openmatch_tpu.models.bert import BertConfig
    from openmatch_tpu.models.dr_model import DRModel
    from openmatch_tpu.ops import mips
    from openmatch_tpu.parallel.mesh import make_mesh

    jm = DRModel(encoder_config=BertConfig(**tr.BERT))
    return SimpleNamespace(
        jax=jax, mips=mips, mesh2=make_mesh(2, 1, devices=jax.devices()[:2]),
        params=seeded(jax, jm.init_params(jax.random.PRNGKey(0)), 5))


@pytest.fixture(scope="module")
def ranks(jx):
    inputs = {"dr": (("bert", tr.BERT, {}), params_from_jax(jx.params))}
    return spawn_ranks(tr.search_world, 2, args=(inputs,), device="cpu",
                       timeout_s=300)


def results(ranks, key):
    """The rank-0 answer, after checking every rank gave the same."""
    s, i, dispatch = ranks[0][key]
    for res in ranks[1:]:
        np.testing.assert_array_equal(res[key][0], s)
        np.testing.assert_array_equal(res[key][1], i)
    return s, i, dispatch


@pytest.mark.parametrize("part", ["docs", "queries"])
@pytest.mark.parametrize("case", ["basic", "k_above_shard", "padded",
                                  "negative"])
def test_plain_mesh_search_matches_brute_and_jax(ranks, jx, case, part):
    q, c, k = CASES[case]
    s, i, dispatch = results(ranks, f"{case}/plain/{part}")
    assert dispatch == f"plain-mesh-{part}:plain"
    es, ei = brute(q, c, k)
    assert i.shape == (q.shape[0], k)
    np.testing.assert_array_equal(i, ei)
    np.testing.assert_allclose(s, es, rtol=1e-5, atol=1e-6)
    js, ji = jx.mips.Searcher(c, k=k, mesh=jx.mesh2, method="hier2",
                              partition=part).search(q)
    np.testing.assert_array_equal(i, np.asarray(ji))
    np.testing.assert_allclose(s, np.asarray(js), rtol=1e-5, atol=1e-6)


def test_sharded_search_functions(ranks, jx):
    q, c, k = CASES["basic"]
    s, i, _ = results(ranks, "basic/sharded_search")
    js, ji = jx.mips.sharded_search(q, c, k=k, mesh=jx.mesh2)
    np.testing.assert_array_equal(i, np.asarray(ji))
    np.testing.assert_allclose(s, np.asarray(js), rtol=1e-5, atol=1e-6)
    q8 = np.concatenate([q, q[:1]])
    s, i, _ = results(ranks, "basic/query_sharded_search")
    js, ji = jx.mips.query_sharded_search(q8, c, k=k, mesh=jx.mesh2)
    np.testing.assert_array_equal(i, np.asarray(ji))
    np.testing.assert_allclose(s, np.asarray(js), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("key", ["kernel_negative/kernel/docs",
                                 "kernel_negative/kernel/queries",
                                 "kernel_negative/sharded_corpus",
                                 "k_above_shard/kernel/docs",
                                 "segmented/kernel/queries"])
def test_kernel_mesh_search_is_exact(ranks, key):
    """The kernel path (plain versions on the CPU): all-negative scores,
    zero padding, a ragged tail, a 5-row and an empty shard."""
    q, c, k = CASES[key.split("/")[0]]
    s, i, dispatch = results(ranks, key)
    want = {"docs": "kernel-mesh-docs", "queries": "kernel-mesh-queries",
            "sharded_corpus": "kernel-mesh-docs"}[key.split("/")[-1]]
    if key.startswith("segmented"):
        want = "kernel-mesh-queries-seg"
        assert ranks[0]["segmented/n_segs"] == 2
    assert dispatch == want
    es, ei = brute(q, c, k)
    np.testing.assert_array_equal(i, ei)
    np.testing.assert_allclose(s, es, rtol=1e-4, atol=1e-5)
    assert (np.diff(s, axis=1) <= 1e-6).all()


@pytest.mark.parametrize("method", ["plain", "kernel"])
@pytest.mark.parametrize("part", ["docs", "queries"])
def test_host_bf16_index(ranks, method, part):
    q, c, k = CASES["bf16"]
    _, i, _ = results(ranks, f"bf16/{method}/{part}")
    assert set(i.ravel().tolist()) == {100, 101, 102}


def test_retriever_over_a_mesh_equals_one_process(ranks, jx):
    model = tr.port_dr(("bert", tr.BERT, {}), params_from_jax(jx.params))
    one = Retriever(model, None, tr.InferenceArguments(), pad_token_id=0,
                    device="cpu")
    one.doc_embeddings = CASES["segmented"][1]
    one.doc_ids = [f"d{i}" for i in range(len(one.doc_embeddings))]
    want = one.search(CASES["segmented"][0], [f"q{i}" for i in range(7)],
                      topk=10)
    for res in ranks:
        for part in ("docs", "queries"):
            assert res[f"retriever/{part}"] == want


def test_plain_topk_valid_partial_block():
    """JAX test_plain_topk_valid_partial_block: a top doc inside the partial
    8-row block is found, pad rows never selected."""
    rng = np.random.RandomState(3)
    N, D, k = 4100, 128, 7
    corpus = np.abs(rng.randn(N, D)).astype(np.float32)
    corpus[N - 2] *= 10.0
    q = -np.abs(rng.randn(4, D)).astype(np.float32)
    q[1] = np.abs(q[1])
    plain = cm.pad_plain(torch.from_numpy(corpus))
    assert plain.shape[0] == 6144 and not plain[N:].any()
    s, i = cm.plain_topk_valid(torch.from_numpy(q), plain, N, k)
    np.testing.assert_array_equal(i.numpy(), brute(q, corpus, k)[1])
    for valid in (0, 3, N // 8 * 8):
        s, i = cm.plain_topk_valid(torch.from_numpy(q), plain, valid, k)
        n = min(valid, k)
        np.testing.assert_array_equal(i[:, :n].numpy(),
                                      brute(q, corpus[:valid], n)[1])
        assert torch.isneginf(s[:, n:]).all()
    # k near half the blocks: the selection takes masked blocks, the
    # partial one among them; its rows count once, the rest read -inf
    small = plain[:2048]
    for valid in range(9, 16):
        s, i = cm.plain_topk_valid(torch.from_numpy(q), small, valid, 127)
        live = torch.isfinite(s)
        assert (live.sum(1) == valid).all() and (i[live] < valid).all()
        for row in range(q.shape[0]):
            assert sorted(i[row][live[row]].tolist()) == list(range(valid))


def test_searcher_mesh_refusals():
    from openmatch_tpu_torch.parallel.mesh import Mesh

    c = torch.zeros(4096, 8)
    with pytest.raises(ValueError, match="n_segs=2 requires"):
        Searcher(c, mesh=Mesh(dp=2, tp=1), method="kernel", n_segs=2)
    with pytest.raises(ValueError, match="unknown partition"):
        Searcher(c, mesh=Mesh(dp=2, tp=1), partition="rows")
