"""The port's ranks (``parallel/mesh.py``) against the JAX package's mesh,
on the CPU: 2 gloo ranks (``spawn_ranks``, once for the module; the rank
bodies are ``tests/torch_ranks.py``'s) against JAX on 2 of the conftest's 8
host devices, with the same numpy-seeded inputs and weights:

- the mesh rules (JAX ``tests/test_mesh.py``) and ``shard_batch``'s rows;
- ``all_gather_rows``: rows tiled in rank order, this rank's gradient back;
- ``DRTrainer`` with dp = 2 in every mode (local negatives, global
  negatives, with ``dual_learning``, GradCache local and global): the loss
  and every parameter after 2 steps within rtol 1e-5 and atol 1e-5 of
  JAX's ``DRTrainer`` on a 2-device mesh (as ``test_torch_train.py``), and
  the parameters bit-identical on both ranks;
- ``RRTrainer`` with dp = 2 (the same tolerances);
- ``Reranker(mesh=)``: scores within 1e-5 x max|score| of JAX's
  ``Reranker`` on the mesh, the global batch per-device x dp;
- ``maybe_init_distributed``: (rank, world) of the initialised group, and
  of torchrun's ``env://`` rendezvous with the gloo backend.

JAX is imported inside the tests only (the ranks import nothing of it).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torch_ranks as tr
from torch_ranks import seeded
from openmatch_tpu_torch.models.jax_convert import (params_from_jax,
                                                    params_to_jax)
from openmatch_tpu_torch.parallel.mesh import Mesh, make_mesh, spawn_ranks

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def jx():
    import jax

    from openmatch_tpu.config import DataArguments, InferenceArguments
    from openmatch_tpu.config import TrainingArguments
    from openmatch_tpu.models.bert import BertConfig
    from openmatch_tpu.models.dr_model import DRModel
    from openmatch_tpu.models.rr_model import RRModel
    from openmatch_tpu.parallel import mesh
    from openmatch_tpu.retriever.reranker import Reranker
    from openmatch_tpu.train.dr_trainer import DRTrainer
    from openmatch_tpu.train.rr_trainer import RRTrainer

    return SimpleNamespace(
        jax=jax, DataArguments=DataArguments,
        InferenceArguments=InferenceArguments,
        TrainingArguments=TrainingArguments, BertConfig=BertConfig,
        DRModel=DRModel, RRModel=RRModel, mesh=mesh, Reranker=Reranker,
        DRTrainer=DRTrainer, RRTrainer=RRTrainer,
        mesh2=mesh.make_mesh(2, 1, devices=jax.devices()[:2]))


@pytest.fixture(scope="module")
def models(jx):
    jm = jx.DRModel(encoder_config=jx.BertConfig(**tr.BERT),
                    dtype=jx.jax.numpy.float32)
    params = seeded(jx.jax, jm.init_params(jx.jax.random.PRNGKey(0)), 1)
    rm = jx.RRModel(encoder_config=jx.BertConfig(**tr.BERT),
                    head_in_dim=tr.BERT["hidden_size"])
    rparams = seeded(jx.jax, rm.init_params(jx.jax.random.PRNGKey(1)), 2)
    return SimpleNamespace(jm=jm, params=params, rm=rm, rparams=rparams)


@pytest.fixture(scope="module")
def ranks(models):
    inputs = {"dr": (("bert", tr.BERT, {}), params_from_jax(models.params)),
              "rr": (tr.BERT, params_from_jax(models.rparams))}
    return spawn_ranks(tr.dp2_world, 2, args=(inputs,), device="cpu",
                       timeout_s=300)


def assert_tree_close(jax, got_state, want_tree, heads=4):
    got = jax.tree_util.tree_leaves_with_path(params_to_jax(got_state, heads))
    want = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, want_tree))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g, w, err_msg=jax.tree_util.keystr(path),
                                   **TOL)


def assert_replicated(results, key=lambda r: r):
    a, b = (key(r) for r in results)
    assert a["losses"] == b["losses"]
    for name in a["state"]:
        assert torch.equal(a["state"][name], b["state"][name]), name


# ---- the mesh --------------------------------------------------------------


def test_make_mesh_rules():
    """One process: the JAX rules' messages; a hand-made mesh reads as
    JAX's (shape, rank = d * tp + t)."""
    with pytest.raises(ValueError, match=r"dp\(3\) \* tp\(2\) != devices"):
        make_mesh(dp_size=3, tp_size=2, device="cpu")
    with pytest.raises(ValueError, match="not divisible by tp=2"):
        make_mesh(dp_size=-1, tp_size=2, device="cpu")
    assert make_mesh(device="cpu").shape == {"data": 1, "model": 1}
    if not torch.cuda.is_available():  # the card unless the CPU is named
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh()
    m = Mesh(dp=4, tp=2, rank=5)
    assert m.shape == {"data": 4, "model": 2}
    assert (m.data_index, m.model_index) == (2, 1)


def test_mesh_and_shard_batch_on_two_ranks(ranks, jx):
    for r, res in enumerate(ranks):
        assert res["mesh"] == dict(shape={"data": 2, "model": 1}, rank=r,
                                   data_index=r, stage=False)
    # JAX places rows d*B/dp ... (d+1)*B/dp on data index d
    x = jx.mesh.shard_batch({"x": np.arange(16, dtype=np.int32)
                            .reshape(16, 1)}, jx.mesh2)["x"]
    for shard in x.addressable_shards:
        d = jx.mesh2.devices.tolist().index([shard.device])
        np.testing.assert_array_equal(ranks[d]["shard_rows"],
                                      np.asarray(shard.data))


def test_all_gather_rows_forward_and_backward(ranks):
    want = np.concatenate([np.arange(6.0).reshape(3, 2) + 10 * r
                           for r in range(2)])
    weights = np.arange(12.0).reshape(6, 2)
    for r, res in enumerate(ranks):
        y, grad = res["gather"]
        np.testing.assert_array_equal(y, want)
        np.testing.assert_array_equal(grad, weights[3 * r:3 * r + 3])


def test_shard_batch_refuses_uneven_rows():
    from openmatch_tpu_torch.parallel.mesh import shard_batch

    with pytest.raises(ValueError, match="does not split over 2"):
        shard_batch({"x": np.zeros((5, 1))}, Mesh(dp=2, tp=1))


# ---- the trainers ------------------------------------------------------------


@pytest.mark.parametrize("mode", sorted(tr.DP_MODES))
def test_dp2_dr_trainer_matches_jax(ranks, jx, models, mode):
    jt = jx.DRTrainer(models.jm, models.params,
                      jx.TrainingArguments(**tr.train_kw(**tr.DP_MODES[mode])),
                      total_steps=10, mesh=jx.mesh2)
    want = [float(jt.train_step(tr.qp_batch(s))) for s in tr.STEP_SEEDS]
    got = ranks[0]["dr"][mode]
    np.testing.assert_allclose(got["losses"], want, **TOL)
    assert_tree_close(jx.jax, got["state"], jt.state.params)
    assert_replicated(ranks, lambda r: r["dr"][mode])


def test_dp2_rr_trainer_matches_jax(ranks, jx, models):
    jt = jx.RRTrainer(models.rm, models.rparams,
                      jx.TrainingArguments(**tr.train_kw()),
                      total_steps=10, mesh=jx.mesh2)
    want = [float(jt.train_step(tr.rr_batch(s))) for s in tr.STEP_SEEDS]
    got = ranks[0]["rr"]
    np.testing.assert_allclose(got["losses"], want, **TOL)
    assert_tree_close(jx.jax, got["state"], jt.state.params)
    assert_replicated(ranks, lambda r: r["rr"])


def test_reranker_on_a_mesh_matches_jax(ranks, jx, models):
    reranker = jx.Reranker(
        models.rm, models.rparams, tr.IdTokenizer(),
        jx.DataArguments(**tr.RERANK_ARGS),
        jx.InferenceArguments(per_device_eval_batch_size=4), mesh=jx.mesh2)
    want = reranker.rerank(*tr.rerank_inputs())
    scale = max(abs(s) for d in want.values() for s in d.values())
    for res in ranks:
        batch_size, got = res["rerank"]
        assert batch_size == reranker.batch_size == 8
        assert got.keys() == want.keys()
        for qid in want:
            assert got[qid].keys() == want[qid].keys()
            for did, s in want[qid].items():
                assert abs(got[qid][did] - s) <= 1e-5 * scale, (qid, did)


def test_maybe_init_distributed_on_two_ranks(ranks):
    for r, res in enumerate(ranks):
        assert res["init"] == (r, 2)
        assert res["env_init"] == ((r, 2), "gloo")


def test_spawn_ranks_defaults_to_the_card():
    """Ranks run on the card unless the caller names the CPU: without a
    card the default raises before any rank starts."""
    import inspect

    assert inspect.signature(spawn_ranks).parameters["device"].default \
        == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        spawn_ranks(tr.maybe_init_rank, 2, timeout_s=30)


def test_spawn_ranks_stops_at_a_failing_or_hanging_rank():
    """A rank's exception fails the job at once (the waiting rank is
    stopped, the error names the rank); a rank past the deadline fails it
    too. Nothing retries."""
    import time

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="of 2 failed") as err:
        spawn_ranks(tr.failing_rank, 2, device="cpu", timeout_s=120)
    # rank 0's barrier may fail as fast: the message holds each error
    assert "rank 1 fails on purpose" in str(err.value)
    assert time.monotonic() - t0 < 60
    with pytest.raises(TimeoutError, match="still running"):
        spawn_ranks(tr.hanging_rank, 2, device="cpu", timeout_s=10)
