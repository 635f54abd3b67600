"""ANCE's alternating loop over ranks (``ance/loop.py`` ``write_ann_data(
mesh=)``, ``perf/ance_cycle.py`` over ``torch.distributed``) against the JAX
package's loop on a 2-device data mesh, on the CPU.

2 gloo ranks (``spawn_ranks`` once for the module; the body is
``tests/torch_ranks.py``'s ``ance_world``) run the topic miniature of
``test_torch_ance.py::test_alternating_miniature_matches_jax`` (tiny BERT,
fp32, a global batch of 8 queries x 2 passages, three generations of three
steps), each rank training its rows through ``DRTrainer(mesh=)`` and each
refresh going through ``Retriever(mesh=)``; JAX's ``DRTrainer`` on
``make_mesh(2, 1)`` runs ``run_ance_alternating`` from the same
numpy-seeded weights (``params_from_jax``) and files, its refresh through
JAX's ``Retriever`` on the same mesh (fp16 embeddings, an fp32 search, as
the port's). Held:

- every step's loss within 1e-4 relative (the single-process test's), the
  final parameters within rtol = atol = 1e-5, and bit-identical on both
  ranks;
- each published generation byte-equal to JAX's, written by rank 0 alone
  (the writes each rank made are counted), no ``.tmp`` left, both ranks
  reading the same bytes; each query's refreshed ranking JAX's, its docs
  separated by more than the two packages' largest score difference, so
  the mined order cannot hang on a tie;
- ``perf.ance_cycle`` at ``--tiny`` over the 2 ranks: the same negatives,
  losses and published bytes on both;
- ``write_ann_data`` with no mesh or a one-rank mesh writes JAX's bytes;
  a ``--tp_size 2`` cycle raises, naming tp.
"""

import json
import os

import numpy as np
import pytest
import torch

import torch_ranks as tr
from openmatch_tpu_torch.ance import loop
from openmatch_tpu_torch.models.jax_convert import (params_from_jax,
                                                    params_to_jax)
from openmatch_tpu_torch.parallel.mesh import Mesh, spawn_ranks
from openmatch_tpu_torch.perf import ance_cycle

torch.set_num_threads(2)
LOSS_REL = 1e-4
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX's miniature on a 2-device mesh: (numpy params it started from,
    losses, final params, refresh scores, used files)."""
    import jax
    import jax.numpy as jnp

    from openmatch_tpu.ance import loop as jloop
    from openmatch_tpu.config import (DataArguments, InferenceArguments,
                                      TrainingArguments)
    from openmatch_tpu.data.collators import QPCollator
    from openmatch_tpu.data.loader import batched
    from openmatch_tpu.data.train_dataset import DRTrainDataset
    from openmatch_tpu.models.bert import BertConfig
    from openmatch_tpu.models.dr_model import DRModel
    from openmatch_tpu.parallel.mesh import make_mesh
    from openmatch_tpu.retriever.retriever import Retriever
    from openmatch_tpu.train.dr_trainer import DRTrainer

    root = tmp_path_factory.mktemp("ance_jax")
    init = root / "gen_init.jsonl"
    corpus, queries, qrels, rows = tr.ance_texts()
    init.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    jm = DRModel(encoder_config=BertConfig(**tr.ANCE_BERT), normalize=True,
                 dtype=jnp.float32)
    params = jax.tree.map(lambda x: np.asarray(x, np.float32),
                          jm.init_params(jax.random.PRNGKey(0)))
    trainer = DRTrainer(jm, params, TrainingArguments(**tr.ance_kw()),
                        total_steps=10_000,
                        mesh=make_mesh(2, 1, devices=jax.devices()[:2]))
    losses, scores = [], []

    class Recording:
        def train_step(self, batch):
            loss = trainer.train_step(batch)
            losses.append(float(loss))
            return loss

    def refresh_fn(_, generation):
        # JAX's Retriever on the trainer's mesh, as the port's refresh
        # runs its own: fp16 embeddings, an fp32 search
        retriever = Retriever(jm, trainer.state.params,
                              DataArguments(q_max_len=8, p_max_len=8),
                              InferenceArguments(per_device_eval_batch_size=4),
                              0, mesh=trainer.mesh)
        retriever.encode_corpus({"id": k, "input_ids": v}
                                for k, v in corpus.items())
        q_emb, qids = retriever.encode_queries(
            {"id": k, "input_ids": v} for k, v in queries.items())
        run = retriever.search(q_emb, qids, topk=len(corpus),
                               search_dtype=jnp.float32)
        scores.append(np.array([[run[q][d] for d in corpus]
                                for q in queries]))
        cfg = jloop.AnceConfig(ann_dir=str(root / "ann"), topk_training=8,
                               negative_sample=1, seed=0)
        negs = jloop.generate_hard_negatives(run, qrels, cfg, generation)
        return jloop.write_ann_data(
            cfg.ann_dir, generation,
            jloop.build_ann_lines(negs, qrels, queries, corpus))

    used = jloop.run_ance_alternating(
        Recording(), tr.ance_data_iter((DataArguments, DRTrainDataset,
                                        QPCollator, batched)),
        refresh_fn, str(init), steps_per_generation=3, num_generations=3)
    files = {os.path.basename(p): open(p, "rb").read() for p in used[1:]}
    return dict(params=params, init=str(init), losses=losses,
                state=jax.device_get(trainer.state.params), scores=scores,
                files=files, used=[os.path.basename(p) for p in used])


@pytest.fixture(scope="module")
def ranks(jax_run, tmp_path_factory):
    root = tmp_path_factory.mktemp("ance_ranks")
    inputs = {"state": params_from_jax(jax_run["params"]),
              "init": jax_run["init"], "ann_dir": str(root / "ann"),
              "cycle_dir": str(root / "cycle")}
    return spawn_ranks(tr.ance_world, 2, args=(inputs,), device="cpu",
                       timeout_s=300)


def test_losses_and_parameters_match_jax(ranks, jax_run):
    import jax

    assert ranks[0]["used"] == ranks[1]["used"] == jax_run["used"] \
        == ["gen_init.jsonl", "ann_training_data_0", "ann_training_data_1"]
    for r in ranks:
        assert len(r["losses"]) == 9
        np.testing.assert_allclose(r["losses"], jax_run["losses"],
                                   rtol=LOSS_REL)
    assert ranks[0]["losses"] == ranks[1]["losses"]
    for name, value in ranks[0]["state"].items():
        assert torch.equal(value, ranks[1]["state"][name]), name
    got = jax.tree_util.tree_leaves_with_path(
        params_to_jax(ranks[0]["state"], tr.ANCE_BERT["num_attention_heads"]))
    want = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, jax_run["state"]))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g, w, err_msg=jax.tree_util.keystr(path),
                                   **TOL)


def test_each_generation_is_jax_bytes_written_once(ranks, jax_run):
    for got, want in zip(ranks[0]["scores"], jax_run["scores"]):
        # each query's ranking, which the mined negatives follow, is JAX's,
        # and no two of its docs lie within its largest score difference
        np.testing.assert_array_equal(np.argsort(-got, axis=1),
                                      np.argsort(-want, axis=1))
        diff = np.abs(got - want).max(axis=1)
        gaps = np.diff(np.sort(got, axis=1), axis=1).min(axis=1)
        assert (gaps > diff).all()
    assert ranks[0]["files"] == ranks[1]["files"] == jax_run["files"]
    assert ranks[0]["writes"] == ["ann_training_data_0.tmp",
                                  "ann_training_data_1.tmp"]
    assert ranks[1]["writes"] == []
    for r in ranks:  # no .tmp left in the shared directory
        assert r["listing"] == ["ann_training_data_0", "ann_training_data_1"]


def test_ance_cycle_over_two_ranks(ranks):
    a, b = (r["cycle"] for r in ranks)
    assert a["ranks"] == b["ranks"] == 2
    assert a["negatives"] == b["negatives"] and len(a["negatives"]) == 16
    for qid, negs in a["negatives"].items():
        assert len(negs) == ance_cycle.NEGATIVE_SAMPLE
        assert f"d{qid[1:]}" not in negs  # never the positive
    assert a["losses"] == b["losses"] and len(a["losses"]) == 6
    assert np.isfinite(a["losses"]).all()
    assert a["sha"] == b["sha"]
    assert a["listing"] == b["listing"] == ["ann_training_data_0"]


@pytest.mark.parametrize("mesh", [None, Mesh(dp=1, tp=1)])
def test_write_ann_data_without_ranks_is_jax_bytes(mesh, tmp_path):
    from openmatch_tpu.ance import loop as jloop

    lines = ['{"query": [1, 2]}', '{"query": [3]}']
    got = loop.write_ann_data(str(tmp_path / "port"), 1, lines,
                              {"ndcg_cut_10": 0.5}, mesh=mesh)
    want = jloop.write_ann_data(str(tmp_path / "jax"), 1, lines,
                                {"ndcg_cut_10": 0.5})
    assert open(got, "rb").read() == open(want, "rb").read()
    for name in ("ann_ndcg_1",):
        assert (tmp_path / "port" / name).read_bytes() \
            == (tmp_path / "jax" / name).read_bytes()
    assert sorted(os.listdir(tmp_path / "port")) \
        == sorted(os.listdir(tmp_path / "jax"))


def test_ance_cycle_refuses_tensor_parallelism(tmp_path):
    with pytest.raises(NotImplementedError, match="tp_size=2"):
        ance_cycle.main(["400", "16", "3", "--tiny", "--device", "cpu",
                         "--tp_size", "2", "--workdir", str(tmp_path)])
