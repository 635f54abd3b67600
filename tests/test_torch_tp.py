"""Tensor parallelism in the port (``parallel/tp.py``) against the JAX
package's (``tests/test_tp.py``), on the CPU:

- the spec mapping on the port's [out, in] layout: each rank's slices equal
  the JAX shards of the same weights on a tp = 2 mesh, carried over by
  ``jax_convert``, for BERT and T5 (exactly); the indivisible refusal and
  "tp requires global negatives" with JAX's messages;
- ``DRTrainer`` on 2 gloo ranks as tp = 2 and on 4 as dp = 2 x tp = 2
  (``spawn_ranks``, the bodies in ``tests/torch_ranks.py``), BERT and T5,
  plain and GradCache with global negatives: the loss and the gathered
  parameters after 2 steps within rtol 1e-5 and atol 1e-5 of JAX's
  ``DRTrainer`` on the same mesh shape; GradCache equal to plain tp at the
  same tolerance; each rank's weights the slices' shapes;
- a tp = 2 checkpoint: rank 0 writes the one-process layout, JAX loads it
  and encodes within 1e-5 of the port's one-process load, and a resumed
  trainer continues bit for bit;
- the JAX package's ``dryrun_multichip(4)`` rebuilt over 4 gloo ranks:
  global-negatives and GradCache steps, a tp step, both search partitions
  plus the segmented one through the plain versions of the kernels (exact
  under zero padding and all-negative scores), data-parallel reranking.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torch_ranks as tr
from openmatch_tpu_torch.config import TrainingArguments
from openmatch_tpu_torch.models.dr_model import DRModel
from openmatch_tpu_torch.models.jax_convert import (params_from_jax,
                                                    params_to_jax)
from openmatch_tpu_torch.parallel import tp as tp_mod
from openmatch_tpu_torch.parallel.mesh import Mesh, spawn_ranks
from openmatch_tpu_torch.train.dr_trainer import DRTrainer
from torch_ranks import seeded

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)
SPECS = {"bert": ("bert", tr.BERT, {}),
         "t5": ("t5", tr.T5, dict(pooling="mean"))}


@pytest.fixture(scope="module")
def jx():
    import jax

    from openmatch_tpu.config import TrainingArguments as JaxArgs
    from openmatch_tpu.models.bert import BertConfig
    from openmatch_tpu.models.dr_model import DRModel as JaxDRModel
    from openmatch_tpu.models.rr_model import RRModel
    from openmatch_tpu.models.t5 import T5Config
    from openmatch_tpu.parallel.mesh import make_mesh
    from openmatch_tpu.parallel.tp import place_params
    from openmatch_tpu.train.dr_trainer import DRTrainer as JaxDRTrainer

    configs = {"bert": BertConfig(**tr.BERT), "t5": T5Config(**tr.T5)}
    models = {}
    for name, (backbone, _, kw) in SPECS.items():
        jm = JaxDRModel(encoder_config=configs[name], backbone_type=backbone,
                        **kw)
        models[name] = (jm, seeded(jax, jm.init_params(
            jax.random.PRNGKey(0)), 3))
    rm = RRModel(encoder_config=configs["bert"],
                 head_in_dim=tr.BERT["hidden_size"])
    return SimpleNamespace(
        jax=jax, JaxArgs=JaxArgs, JaxDRModel=JaxDRModel,
        JaxDRTrainer=JaxDRTrainer, make_mesh=make_mesh,
        place_params=place_params, models=models,
        rr=seeded(jax, rm.init_params(jax.random.PRNGKey(1)), 4))


def inputs(jx, root=None):
    return {"models": {name: (SPECS[name], params_from_jax(params))
                       for name, (_, params) in jx.models.items()},
            "dr": (SPECS["bert"], params_from_jax(jx.models["bert"][1])),
            "rr": (tr.BERT, params_from_jax(jx.rr)), "root": root}


@pytest.fixture(scope="module")
def tp2(jx, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tp2"))
    return spawn_ranks(tr.tp_world, 2, args=(inputs(jx, root),),
                       device="cpu", timeout_s=300), root


@pytest.fixture(scope="module")
def world4(jx):
    return spawn_ranks(tr.world4, 4, args=(inputs(jx),), device="cpu",
                       timeout_s=300)


def jax_run(jx, name, mode, dp):
    jm, params = jx.models[name]
    mesh = jx.make_mesh(dp, 2, devices=jx.jax.devices()[:2 * dp])
    kw = dict(tr.TP_MODES[mode])
    if kw.get("grad_cache"):
        kw["per_device_train_batch_size"] = 4 // dp
    jt = jx.JaxDRTrainer(jm, params, jx.JaxArgs(**tr.train_kw(**kw)),
                         total_steps=10, mesh=mesh)
    losses = [float(jt.train_step(tr.qp_batch(s))) for s in tr.STEP_SEEDS]
    return losses, jt.state.params


def assert_matches(jx, got, want_losses, want_tree):
    np.testing.assert_allclose(got["losses"], want_losses, **TOL)
    g = jx.jax.tree_util.tree_leaves_with_path(params_to_jax(got["state"], 4))
    w = jx.jax.tree_util.tree_leaves_with_path(
        jx.jax.tree.map(np.asarray, want_tree))
    assert [k for k, _ in g] == [k for k, _ in w]
    for (path, a), (_, b) in zip(g, w):
        np.testing.assert_allclose(a, b, **TOL,
                                   err_msg=jx.jax.tree_util.keystr(path))


# ---- specs -----------------------------------------------------------------


def test_bert_spec_mapping():
    specs = tp_mod.param_partition_specs(DRModel(_bert_cfg()).state_dict(),
                                         8)
    lp = "encoder_q.layers.0."
    assert specs[lp + "attention.qkv.weight"] == (0, 3, 8)
    assert specs[lp + "attention.qkv.bias"] == (0, 3, 8)
    assert specs[lp + "attention.out.weight"] == (1, 1, 8)
    assert specs[lp + "attention.out.bias"] is None
    assert specs[lp + "intermediate.weight"] == (0, 1, 1)
    assert specs[lp + "intermediate.bias"] == (0, 1, 1)
    assert specs[lp + "output.weight"] == (1, 1, 1)
    assert specs[lp + "output.bias"] is None
    assert specs["encoder_q.word_embeddings.weight"] is None
    assert specs["encoder_q.embeddings_ln.weight"] is None


def _bert_cfg():
    from openmatch_tpu_torch.models.bert import BertConfig

    return BertConfig(**tr.BERT)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_slices_equal_jax_shards(jx, name):
    """Rank t's slices of every weight equal JAX's shards on device t of a
    tp = 2 mesh (the JAX shard tree carried over by jax_convert)."""
    jm, params = jx.models[name]
    mesh = jx.make_mesh(1, 2, devices=jx.jax.devices()[:2])
    placed = jx.place_params(params, mesh)
    full = params_from_jax(params)
    hd = 8
    for t, device in enumerate(mesh.devices.ravel()):
        local_tree = jx.jax.tree.map(
            lambda x: np.asarray(next(s.data for s in x.addressable_shards
                                      if s.device == device)), placed)
        want = params_from_jax(local_tree)
        got = tp_mod.place_params(full, Mesh(dp=1, tp=2, rank=t), hd)
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k


def test_validate_rejects_indivisible():
    state = DRModel(_bert_cfg()).state_dict()
    specs = tp_mod.param_partition_specs(state, 8)
    with pytest.raises(ValueError, match="does not divide"):
        tp_mod.validate_tp(state, specs, 3)  # 4 heads, FFN 64


def test_tp_requires_global_negatives():
    with pytest.raises(ValueError, match="tensor parallelism"):
        DRTrainer(DRModel(_bert_cfg()),
                  TrainingArguments(negatives_x_device=False),
                  total_steps=2, device="cpu", mesh=Mesh(dp=1, tp=2))


def test_gather_inverts_place():
    """One rank's view of gather_params: the slices of all model ranks
    reassemble the full tensors (layout only; no process group)."""
    full = DRModel(_bert_cfg()).state_dict()
    specs = tp_mod.param_partition_specs(full, 8)
    for name, spec in specs.items():
        if spec is None:
            continue
        parts = [tp_mod.local_slice(full[name], spec, 2, t) for t in (0, 1)]
        dim, groups, _ = spec
        views = [p.reshape(tp_mod._blocks(p.shape, spec)) for p in parts]
        assert torch.equal(torch.cat(views, dim + 1).reshape(
            full[name].shape), full[name]), name


# ---- training ----------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(SPECS))
@pytest.mark.parametrize("mode", sorted(tr.TP_MODES))
def test_tp2_matches_jax(jx, tp2, name, mode):
    ranks, _ = tp2
    got = ranks[0][f"{name}/{mode}"]
    assert_matches(jx, got, *jax_run(jx, name, mode, 1))
    for res in ranks[1:]:
        other = res[f"{name}/{mode}"]
        assert other["losses"] == got["losses"]
        for k in got["state"]:
            assert torch.equal(other["state"][k], got["state"][k]), k


@pytest.mark.parametrize("name", sorted(SPECS))
@pytest.mark.parametrize("mode", sorted(tr.TP_MODES))
def test_dp2_tp2_matches_jax(jx, world4, name, mode):
    got = world4[0]["tp"][f"{name}/{mode}"]
    assert_matches(jx, got, *jax_run(jx, name, mode, 2))


def test_tp_grad_cache_equals_plain_tp(tp2, world4):
    for res in (tp2[0][0], world4[0]["tp"]):
        for name in SPECS:
            plain, gc = res[f"{name}/x_device"], res[f"{name}/gc_x_device"]
            np.testing.assert_allclose(gc["losses"], plain["losses"], **TOL)
            for k in plain["state"]:
                np.testing.assert_allclose(gc["state"][k], plain["state"][k],
                                           err_msg=k, **TOL)


def test_ranks_hold_their_slices(tp2):
    for res in tp2[0]:
        shapes = res["bert/x_device"]["local_shapes"]
        lp = "encoder_q.layers.0."
        assert shapes[lp + "attention.qkv.weight"] == (48, 32)
        assert shapes[lp + "attention.out.weight"] == (32, 16)
        assert shapes[lp + "intermediate.weight"] == (32, 32)
        assert shapes[lp + "output.weight"] == (32, 32)
        assert shapes[lp + "output.bias"] == (32,)
        t5 = res["t5/x_device"]["local_shapes"]
        assert t5["encoder_q.layers.0.self_attn.q.weight"] == (16, 32)
        assert t5["encoder_q.rel_bias"] == (8, 4)


def test_tp2_checkpoint_loads_in_jax_and_resumes(jx, tp2):
    ranks, root = tp2
    path = f"{root}/model"
    port = DRModel.load(path, device="cpu")
    jm, params = jx.JaxDRModel.load(path)
    batch = tr.qp_batch(11)["passage"]
    want = np.asarray(jm.encode_passage(params, batch["input_ids"],
                                        batch["attention_mask"]))
    with torch.no_grad():
        got = port.encode_passage(torch.from_numpy(batch["input_ids"]),
                                  torch.from_numpy(batch["attention_mask"]))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the written weights are the gathered ones after the STEP_SEEDS steps
    # (the same run as the x_device case's, which saved nothing)
    trained = ranks[0]["bert/x_device"]["state"]
    for k, v in port.state_dict().items():
        assert torch.equal(v, trained[k]), k
    same, step, after = ranks[0]["resume"]
    assert same and after and step == len(tr.STEP_SEEDS) + 1


def test_dryrun_multichip_four_ranks(world4):
    rng = np.random.RandomState(0)
    n = 2048 * 4 + 5
    corpus = np.abs(rng.randn(n, 128)).astype(np.float32)
    queries = -np.abs(rng.randn(8, 128)).astype(np.float32)
    want = np.argsort(-(queries @ corpus.T), axis=1, kind="stable")[:, :9]
    for res in world4:
        dry = res["dryrun"]
        for key in ("train_loss", "gc_loss", "tp_loss"):
            assert np.isfinite(dry[key]), key
        assert dry["tp_shape"] == (32, 32)
        assert sorted(dry["search"]) == ["kernel-mesh-docs",
                                         "kernel-mesh-queries",
                                         "kernel-mesh-queries-seg"]
        for ids in dry["search"].values():
            np.testing.assert_array_equal(ids, want)
        batch_size, scores = dry["rerank"]
        assert batch_size == 8 and len(scores) == 5
        assert dry["rerank"] == world4[0]["dryrun"]["rerank"]
