"""The v1-family trainers over ranks against the JAX package's on a 2-device
CPU mesh: 2 gloo ranks (``spawn_ranks`` once for the module; the rank body
is ``tests/torch_ranks.py`` ``v1_world``), the same seeded Flax trees and
numpy batches on both sides, each trainer fed the GLOBAL batch (each rank
trains on its half, JAX shards it over its mesh):

- ``V1Trainer`` (KNRM, ranking and classification): 3 steps;
- ``MetaLTRTrainer``: 2 steps (the first under warmup's lr 0, so zero
  weights; the second reweights at the live lr), the meta weights of the
  global batch in row order (as ``test_torch_research.py``'s one-device
  test: a third step starts from Adam-updated parameters, and the
  second-order meta-gradient magnifies their rounding to ~1e-5 of a
  weight);
- ``ReInfoSelectTrainer`` (margin loss: a pairwise loss leaves the ranking
  head's bias a zero gradient that Adam would scale from rounding noise):
  3 selection steps fed JAX's Gumbel draws of the
  global batch, two REINFORCE refreshes (each sign of the reward);
- losses, every parameter (the policy's too) within rtol 1e-5 / atol 1e-5
  (``test_torch_mesh.py``'s ``TOL``), meta weights within 1e-5, keep
  decisions exactly;
- the ``train_v1`` (plain and ``-reinfoselect``) and ``meta_train``
  drivers over 2 ranks (margin loss, as above; the drivers' Adam epsilon
  is 1e-8): rank 0's files load within 1e-4 x max|value| of
  one process's run on the same flags (PARAM_REL of
  ``test_torch_research.py``: Adam steps with the drivers' epsilon), and
  ``weights.txt`` holds one line of the global batch's weights a step.
"""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torch_ranks as tr
from openmatch_tpu_torch.models.flax_msgpack import read_flax_msgpack
from openmatch_tpu_torch.models.jax_convert import (v1_params_from_jax,
                                                    v1_params_to_jax)
from openmatch_tpu_torch.parallel.mesh import spawn_ranks

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)
DRIVER_REL = 1e-4
B = 8  # the global batch
WORDS = ["apple", "banana", "cherry", "grape", "melon", "fruit", "stone",
         "rock"]
META_KW = dict(learning_rate=0.5, warmup_steps=2)
REWARDS = (None, 0.25, -0.5)  # a refresh after steps 2 and 3


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp

    from openmatch_tpu.config import TrainingArguments
    from openmatch_tpu.parallel import mesh
    from openmatch_tpu.train import meta_trainer, reinfoselect_trainer
    from openmatch_tpu.train.v1_trainer import V1Trainer
    from openmatch_tpu.v1 import models

    return SimpleNamespace(
        jax=jax, jnp=jnp, TrainingArguments=TrainingArguments, mesh=mesh,
        meta=meta_trainer, ris=reinfoselect_trainer, V1Trainer=V1Trainer,
        models=models, mesh2=mesh.make_mesh(2, 1, devices=jax.devices()[:2]))


def seeded_tree(jax, tree, seed):
    """Every leaf drawn from a seed: kernels N(0, 1/fan_in), biases small,
    embeddings N(0, 1)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = tuple(leaf.shape)
        x = rng.standard_normal(shape).astype(np.float32)
        if name.endswith("['bias']"):
            x = 0.1 * x
        elif "kernel" in name:
            x = x / np.sqrt(np.prod(shape[:-1]))
        return x

    return jax.tree_util.tree_map_with_path(draw, tree)


def word_batch(seed, task="ranking", n=B):
    rng = np.random.RandomState(seed)

    def ids(length):
        x = rng.randint(1, tr.V1_V, size=(n, length)).astype(np.int32)
        lengths = rng.randint(2, length + 1, size=n)
        mask = (np.arange(length)[None] < lengths[:, None]).astype(
            np.float32)
        return x * mask.astype(np.int32), mask

    q, qm = ids(5)
    d, dm = ids(12)
    if task == "classification":
        return {"query_idx": q, "query_mask": qm, "doc_idx": d,
                "doc_mask": dm,
                "label": rng.randint(0, 2, size=n).astype(np.int32)}
    d2, dm2 = ids(12)
    return {"query_idx": q, "query_mask": qm, "doc_pos_idx": d,
            "doc_pos_mask": dm, "doc_neg_idx": d2, "doc_neg_mask": dm2}


def jax_model(jx, task="ranking", policy=False, seed=0):
    """(module, seeded params, score_fn) of the JAX KNRM (Conv-KNRM for the
    policy)."""
    m = jx.models
    if policy:
        jm = m.ConvKNRM(vocab_size=tr.V1_V, embed_dim=tr.V1_E,
                        kernel_dim=tr.V1_KD, task="classification")
    else:
        jm = m.KNRM(vocab_size=tr.V1_V, embed_dim=tr.V1_E, task=task)
    keys = ("query_idx", "query_mask", "doc_idx", "doc_mask")
    b = word_batch(0, "classification", 1)
    args = [jx.jnp.asarray(b[k]) for k in keys]
    shapes = jx.jax.eval_shape(jm.init, jx.jax.random.PRNGKey(0),
                               *args)["params"]
    params = seeded_tree(jx.jax, shapes, seed)

    def score(p, batch):
        return jm.apply({"params": p}, *(batch[k] for k in keys))[0]

    return jm, params, score


def jax_draws(jx, rng, n=B):
    """JAX select_pairs' two Gumbel draws for the step key ``rng``."""
    g_key, a_key = jx.jax.random.split(rng)
    return (np.asarray(jx.jax.random.gumbel(g_key, (n, 2))),
            np.asarray(jx.jax.random.gumbel(a_key, (n, 2))))


# ---- driver files --------------------------------------------------------


def write_files(root):
    """A word vocab, source pairs (odd rows with pos and neg swapped),
    clean target pairs, and a dev set with qrels."""
    (root / "vocab.txt").write_text("\n".join(WORDS))

    def row(i, swap=False):
        f = WORDS[i % 4]
        pos, neg = f"{f} {f} fruit", "stone rock"
        if swap:
            pos, neg = neg, pos
        return {"query": f"{f} fruit", "doc_pos": pos, "doc_neg": neg}

    (root / "source.jsonl").write_text("".join(
        json.dumps(row(i, i % 2 == 1)) + "\n" for i in range(16)))
    (root / "target.jsonl").write_text("".join(
        json.dumps(row(i)) + "\n" for i in range(8)))
    with open(root / "dev.jsonl", "w") as f, open(root / "qrels", "w") as q:
        for j, fruit in enumerate(WORDS[:4]):
            docs = [(f"{fruit} {fruit} fruit", 1), ("stone rock", 0),
                    (f"{WORDS[(j + 1) % 4]} fruit melon", 0)]
            for k, (doc, label) in enumerate(docs):
                f.write(json.dumps({
                    "query_id": f"q{j}", "doc_id": f"d{j}_{k}",
                    "label": label, "retrieval_score": 1.0,
                    "query": f"{fruit} fruit", "doc": doc}) + "\n")
                q.write(f"q{j} 0 d{j}_{k} {label}\n")


def driver_argv(root, out):
    """{name: argv} of the three driver runs, writing under ``out``."""
    words = ["-model", "knrm", "-vocab", str(root / "vocab.txt"),
             "-embed_dim", "8", "-max_query_len", "4", "-max_doc_len", "8",
             "-task", "ranking", "-ranking_loss", "margin_loss",
             "--device", "cpu"]
    dev = ["-dev", str(root / "dev.jsonl"), "-qrels", str(root / "qrels")]
    v1 = words + dev + ["-train", str(root / "source.jsonl"), "-epoch", "2",
                        "-batch_size", "8", "-eval_every", "2"]
    return {
        "train_v1": v1 + ["-lr", "0.05", "-save", str(out / "v1"),
                          "-res", str(out / "v1.trec")],
        "reinfoselect": v1 + ["-lr", "0.5", "-reinfoselect", "-reset",
                              "-save", str(out / "ris"),
                              "-res", str(out / "ris.trec")],
        "meta_train": words + dev + [
            "-train", str(root / "source.jsonl"),
            "-target", str(root / "target.jsonl"), "-epoch", "2",
            "-train_batch_size", "8", "-target_batch_size", "8",
            "-lr", "0.05", "-n_warmup_steps", "1", "-eval_every", "2",
            "-eval_during_train", "-log_weights",
            "-save_folder", str(out / "meta")],
    }


CHECKPOINTS = {"train_v1": "v1", "reinfoselect": "ris",
               "meta_train": "meta/final"}


# ---- the ranks -------------------------------------------------------------


@pytest.fixture(scope="module")
def world(jx, tmp_path_factory):
    """The JAX trainers' inputs, the ranks' results and the drivers'
    directories."""
    root = tmp_path_factory.mktemp("v1mesh")
    write_files(root)
    inputs = {"v1": {}}
    sides = {"v1": {}}
    for task, seed in (("ranking", 1), ("classification", 2)):
        _, params, score = jax_model(jx, task, seed=seed)
        batches = [word_batch(10 * seed + s, task) for s in range(3)]
        inputs["v1"][task] = (v1_params_from_jax(params), batches)
        sides["v1"][task] = (params, score, batches)

    _, params, score = jax_model(jx, seed=3)
    pairs = [(word_batch(30 + s), word_batch(40 + s)) for s in range(2)]
    kw = tr.v1_kw(**META_KW)
    inputs["meta"] = (v1_params_from_jax(params), pairs, kw)
    sides["meta"] = (params, score, pairs, kw)

    _, params, score = jax_model(jx, seed=4)
    _, pparams, pscore = jax_model(jx, policy=True, seed=5)
    rngs = list(jx.jax.random.split(jx.jax.random.PRNGKey(7), 3))
    batches = [word_batch(50 + s) for s in range(3)]
    steps = [(b, *jax_draws(jx, r)) for b, r in zip(batches, rngs)]
    inputs["reinfoselect"] = (v1_params_from_jax(params),
                              v1_params_from_jax(pparams), steps,
                              REWARDS)
    sides["reinfoselect"] = (params, score, pparams, pscore, batches, rngs)

    inputs["drivers"] = driver_argv(root, root / "ranks")
    ranks = spawn_ranks(tr.v1_world, 2, args=(inputs,), timeout_s=600)
    return SimpleNamespace(root=root, ranks=ranks, sides=sides)


def jax_args(jx, **kw):
    return jx.TrainingArguments(**tr.v1_kw(**kw))


def assert_tree_close(jax, got_state, want_tree):
    got = jax.tree_util.tree_leaves_with_path(v1_params_to_jax(got_state))
    want = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, want_tree))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g, w, err_msg=jax.tree_util.keystr(path),
                                   **TOL)


def assert_replicated(results, key):
    a, b = (r[key] for r in results)
    for part in ("state", "policy"):
        for name in a.get(part, {}):
            assert torch.equal(a[part][name], b[part][name]), (part, name)
    assert a["losses"] == b["losses"]


@pytest.mark.parametrize("task", ["ranking", "classification"])
def test_dp2_v1_trainer_matches_jax(jx, world, task):
    params, score, batches = world.sides["v1"][task]
    jt = jx.V1Trainer(score, params, jax_args(jx), 10, task=task,
                      mesh=jx.mesh2)
    want = [float(jt.train_step(dict(b))) for b in batches]
    got = world.ranks[0][f"v1/{task}"]
    np.testing.assert_allclose(got["losses"], want, **TOL)
    assert_tree_close(jx.jax, got["state"], jt.state.params)
    assert_replicated(world.ranks, f"v1/{task}")


def test_dp2_meta_trainer_matches_jax(jx, world):
    params, score, pairs, kw = world.sides["meta"]
    jt = jx.meta.MetaLTRTrainer(score, params, jx.TrainingArguments(**kw), 6,
                                mesh=jx.mesh2)
    got = world.ranks[0]["meta"]
    for step, (b, t) in enumerate(pairs):
        loss, weights = jt.train_step(dict(b), dict(t))
        np.testing.assert_allclose(got["losses"][step], float(loss), **TOL)
        w = got["weights"][step]
        assert w.shape == (B,)
        np.testing.assert_allclose(w, np.asarray(weights), rtol=0,
                                   atol=1e-5, err_msg=f"weights {step}")
        assert bool(w.any()) == (step > 0)  # lr 0 at the first
    assert_tree_close(jx.jax, got["state"], jt.state.params)
    assert_replicated(world.ranks, "meta")
    for r in world.ranks:  # every rank returns the global weights
        for a, b in zip(r["meta"]["weights"], got["weights"]):
            np.testing.assert_array_equal(a, b)


def test_dp2_reinfoselect_trainer_matches_jax(jx, world):
    params, score, pparams, pscore, batches, rngs = \
        world.sides["reinfoselect"]
    jt = jx.ris.ReInfoSelectTrainer(
        score, params, pscore, pparams, jax_args(jx, **tr.RIS_KW), 10,
        mesh=jx.mesh2)
    got = world.ranks[0]["reinfoselect"]
    kept = []
    for step, (batch, rng, reward) in enumerate(zip(batches, rngs,
                                                    REWARDS)):
        with jx.mesh2:
            b = jx.mesh.shard_batch(dict(batch), jx.mesh2)
            jt.state, actions, loss = jt._step_fn(jt.state,
                                                  jt.policy_params, b, rng)
            jt._buffer.append((jx.ris.policy_inputs_from_batch(b), rng,
                               actions))
        np.testing.assert_array_equal(got["actions"][step],
                                      np.asarray(actions))
        np.testing.assert_allclose(got["losses"][step], float(loss), **TOL)
        kept.append(int(np.asarray(actions).sum()))
        if reward is not None:
            jt.refresh_policy(reward)
    assert 0 < sum(kept) < B * len(kept)  # the draws keep some, drop some
    assert got["counts"] == (int(jt.state.step),
                             int(jt.state.opt_state[1][0].count))
    assert_tree_close(jx.jax, got["state"], jt.state.params)
    assert_tree_close(jx.jax, got["policy"], jt.policy_params)
    assert_replicated(world.ranks, "reinfoselect")


# ---- the drivers -------------------------------------------------------------


@pytest.fixture(scope="module")
def one_process(world):
    """The three driver runs on one process, same flags."""
    from openmatch_tpu_torch.drivers import meta_train, train_v1

    out = world.root / "one"
    results = {}
    for name, argv in driver_argv(world.root, out).items():
        main = meta_train.main if name == "meta_train" else train_v1.main
        results[name] = main(argv)
    return out, results


@pytest.mark.parametrize("name", sorted(CHECKPOINTS))
def test_drivers_over_two_ranks_write_one_process_files(world, one_process,
                                                        name):
    out, results = one_process
    for r in world.ranks:
        assert r[f"driver/{name}"]["final_step"] == \
            results[name]["final_step"] == 4
    sub = CHECKPOINTS[name]
    got = read_flax_msgpack(str(world.root / "ranks" / sub
                                / "train_state.msgpack"))
    want = read_flax_msgpack(str(out / sub / "train_state.msgpack"))
    assert int(np.asarray(got["step"])) == int(np.asarray(want["step"]))

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], f"{prefix}/{k}")
        else:
            yield prefix, np.asarray(tree)

    got_l, want_l = list(leaves(got["params"])), list(leaves(want["params"]))
    assert [k for k, _ in got_l] == [k for k, _ in want_l]
    for (path, g), (_, w) in zip(got_l, want_l):
        tol = DRIVER_REL * max(np.abs(w).max(), 1e-30)
        assert np.abs(g - w).max() <= tol, path
    if name == "meta_train":
        lines = (world.root / "ranks" / "meta" / "weights.txt"
                 ).read_text().splitlines()
        assert len(lines) == 4  # one a step: rank 0 alone wrote
        assert all(len(x.split("\t")) == 1 + B for x in lines)
    if name == "reinfoselect":
        np.testing.assert_array_equal(
            world.ranks[0]["driver/reinfoselect"]["keep_rates"],
            results["reinfoselect"]["keep_rates"])
