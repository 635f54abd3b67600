"""The port's research recipes against the JAX package's on the same weights
and the same draws: MLM (``mlm_logits``, ``mlm_loss``, ``mask_tokens`` fed
JAX's draws, and its laws under a generator), Meta-LTR
(``meta_reweight_step``'s weights and loss and one reweighted gradient, for
KNRM and a 2-layer BERT; ``MetaLTRTrainer``'s first steps), ReInfoSelect
(``DataSelectionPolicy``, ``sample_actions``, ``policy_loss``,
``gumbel_keep_log_probs``, ``select_pairs`` fed JAX's Gumbel noise, one
refresh gradient with each sign of the reward, a zero-kept batch's two
counters), the weight trees both ways, and the ``train_mlm``,
``meta_train`` and ``train_v1 -reinfoselect`` drivers end to end.

Weights are numpy-seeded Flax trees carried into the port with
``jax_convert``. Tolerances: weights within 1e-5 absolute; losses,
log-probabilities within 1e-5 x max|JAX|; gradients within 1e-5 x the
largest |JAX gradient| of the tree, compared before the optimizer (Adam
scales rounding noise on near-zero gradients up to full steps); after one
Adam step, parameters within 1e-4 x max|JAX|; actions, masks and labels
exactly.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from openmatch_tpu.config import TrainingArguments as JaxTrainingArguments
from openmatch_tpu.models.bert import BertConfig as JaxBertConfig
from openmatch_tpu.parallel.mesh import make_mesh
from openmatch_tpu.research import meta_ltr as jmeta
from openmatch_tpu.research import mlm as jmlm
from openmatch_tpu.research import reinfoselect as jris
from openmatch_tpu.train import meta_trainer as jmeta_trainer
from openmatch_tpu.train import reinfoselect_trainer as jris_trainer
from openmatch_tpu.train import state as jstate
from openmatch_tpu.v1 import models as jmodels
from openmatch_tpu_torch.config import TrainingArguments
from openmatch_tpu_torch.drivers import meta_train as pmeta_train
from openmatch_tpu_torch.drivers import train_mlm as ptrain_mlm
from openmatch_tpu_torch.drivers import train_v1 as ptrain_v1
from openmatch_tpu_torch.models.bert import BertConfig
from openmatch_tpu_torch.models.jax_convert import (mlm_params_from_jax,
                                                    mlm_params_to_jax,
                                                    policy_params_from_jax,
                                                    policy_params_to_jax,
                                                    v1_params_from_jax,
                                                    v1_params_to_jax)
from openmatch_tpu_torch.research import meta_ltr as pmeta
from openmatch_tpu_torch.research import mlm as pmlm
from openmatch_tpu_torch.research import reinfoselect as pris
from openmatch_tpu_torch.train import meta_trainer as pmeta_trainer
from openmatch_tpu_torch.train import reinfoselect_trainer as pris_trainer
from openmatch_tpu_torch.train import v1_trainer as pv1
from openmatch_tpu_torch.v1 import models as pmodels

torch.set_num_threads(2)

W_ATOL = 1e-5
REL = 1e-5
PARAM_REL = 1e-4
V, E, KD = 40, 16, 8
B, QL, DL = 8, 5, 12
BERT = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=64)


def assert_close(got, want, rel=REL, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    tol = rel * max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= tol, f"{what}: max|diff| {err} > {tol}"


def seeded_tree(tree, seed):
    """Every leaf replaced by a seeded draw: LayerNorm scales near 1,
    biases small, kernels N(0, 1/fan_in), embeddings N(0, 1)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = tuple(leaf.shape)
        x = rng.standard_normal(shape).astype(np.float32)
        if name.endswith("['scale']"):
            x = 1.0 + 0.2 * x
        elif name.endswith("['bias']") or "decoder_bias" in name:
            x = 0.1 * x
        elif "kernel" in name:
            split_in = len(shape) > 2 and "conv" not in name \
                and "['out']" not in name
            x = x / np.sqrt(shape[0] if split_in else np.prod(shape[:-1]))
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


def leaves(tree):
    return jax.tree_util.tree_leaves_with_path(jax.device_get(tree))


def assert_trees_close(got, want, rel, what=""):
    got, want = leaves(got), leaves(want)
    assert [k for k, _ in got] == [k for k, _ in want], what
    for (path, g), (_, w) in zip(got, want):
        assert_close(g, w, rel, what + jax.tree_util.keystr(path))


def assert_grads_close(got, want, what="grad"):
    """Each gradient leaf within REL x the largest |JAX gradient| of the
    tree: rounding errors scale with the largest terms summed, and some
    leaves (a ranking head's bias under a pos - neg loss) nearly cancel."""
    got, want = leaves(got), leaves(want)
    assert [k for k, _ in got] == [k for k, _ in want], what
    scale = max(np.abs(np.asarray(w)).max() for _, w in want)
    for (path, g), (_, w) in zip(got, want):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        assert g.shape == w.shape and np.isfinite(g).all()
        err = np.abs(g - w).max()
        assert err <= REL * scale, \
            f"{what}{jax.tree_util.keystr(path)}: {err} > {REL * scale}"


def to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ---- v1 models and batches --------------------------------------------------


def word_view(rng, n):
    def ids(length):
        x = rng.randint(1, V, size=(n, length)).astype(np.int32)
        lengths = rng.randint(2, length + 1, size=n)
        mask = (np.arange(length)[None] < lengths[:, None]).astype(np.float32)
        return x * mask.astype(np.int32), mask

    q, qm = ids(QL)
    d, dm = ids(DL)
    return q, qm, d, dm


def ranking_batch(kind, seed, n=B):
    rng = np.random.RandomState(seed)
    if kind == "bert":
        out = {}
        for side in ("pos", "neg"):
            ids = rng.randint(5, BERT["vocab_size"], size=(n, 12)).astype(
                np.int32)
            lengths = rng.randint(4, 13, size=n)
            mask = (np.arange(12) < lengths[:, None]).astype(np.int32)
            segs = ((np.arange(12) >= lengths[:, None] // 2) * mask).astype(
                np.int32)
            out.update({f"{side}_input_ids": ids * mask,
                        f"{side}_input_mask": mask,
                        f"{side}_segment_ids": segs})
        return out
    q, qm, d, dm = word_view(rng, n)
    _, _, d2, dm2 = word_view(rng, n)
    return {"query_idx": q, "query_mask": qm, "doc_pos_idx": d,
            "doc_pos_mask": dm, "doc_neg_idx": d2, "doc_neg_mask": dm2}


def model_pair(kind, task="ranking", seed=0):
    """(JAX module, seeded params, port module) on the same weights."""
    if kind == "knrm":
        jm = jmodels.KNRM(vocab_size=V, embed_dim=E, task=task)
        pm = pmodels.KNRM(V, E, task=task)
    elif kind == "cknrm":
        jm = jmodels.ConvKNRM(vocab_size=V, embed_dim=E, kernel_dim=KD,
                              task=task)
        pm = pmodels.ConvKNRM(V, E, kernel_dim=KD, task=task)
    else:
        jm = jmodels.BertRanker(config=JaxBertConfig(**BERT), task=task)
        pm = pmodels.BertRanker(BertConfig(**BERT), task=task)
    pos, _ = pv1._default_pos_neg_split(ranking_batch(kind, 0, 1))
    args = [jnp.asarray(pos[k]) for k in pm.INPUTS]
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *args)["params"]
    params = seeded_tree(shapes, seed)
    pm.load_state_dict(v1_params_from_jax(params), strict=True)
    return jm, params, pm


def jax_score_fn(jm, pm):
    def score(p, batch):
        return jm.apply({"params": p}, *(batch[k] for k in pm.INPUTS))[0]
    return score


def jax_loss_fns(jm, pm, kind="margin_loss"):
    score = jax_score_fn(jm, pm)

    def per_example(p, batch):
        pos, neg = jris_trainer._default_pos_neg_split(batch)
        return jris_trainer.per_pair_ranking_loss(score(p, pos),
                                                  score(p, neg), kind)

    return per_example, lambda p, b: per_example(p, b).mean()


def port_trainer(cls, pm, tmp_path, **kw):
    args = TrainingArguments(output_dir=str(tmp_path), learning_rate=1e-2,
                             warmup_ratio=0.1, logging_steps=100,
                             save_steps=0)
    return cls(pm, args, 10, device="cpu", **kw)


# ---- MLM --------------------------------------------------------------------


def mlm_pair(seed=0, **over):
    cfg = dict(BERT, **over)
    jm = jmlm.MLMModel(JaxBertConfig(**cfg))
    ids = jnp.zeros((1, 8), jnp.int32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), ids,
                            jnp.ones_like(ids))["params"]
    params = seeded_tree(shapes, seed)
    pm = pmlm.MLMModel(BertConfig(**cfg))
    pm.load_state_dict(mlm_params_from_jax(params), strict=True)
    return jm, params, pm.eval()


def mlm_inputs(seed, b=4, s=16):
    rng = np.random.RandomState(seed)
    ids = rng.randint(5, BERT["vocab_size"], size=(b, s)).astype(np.int32)
    ids[:, 0] = 2  # a [CLS]-like special id
    mask = np.ones((b, s), np.int32)
    mask[1, 10:] = 0
    mask[3, 5:] = 0
    return ids * mask, mask


def jax_mask_draws(key, shape, vocab):
    """The three draws JAX mask_tokens makes from ``key``."""
    r_select, r_action, r_random = jax.random.split(key, 3)
    return (np.asarray(jax.random.uniform(r_select, shape)),
            np.asarray(jax.random.uniform(r_action, shape)),
            np.asarray(jax.random.randint(r_random, shape, 0, vocab)))


SPECIAL = (0, 1, 2, 3)


def test_mask_tokens_with_jax_draws_equal_jax():
    ids, mask = mlm_inputs(1)
    key = jax.random.PRNGKey(3)
    want = jmlm.mask_tokens(key, jnp.asarray(ids), jnp.asarray(mask), 4,
                            BERT["vocab_size"], SPECIAL, 0.3)
    draws = tuple(torch.tensor(x) for x in
                  jax_mask_draws(key, ids.shape, BERT["vocab_size"]))
    got = pmlm.mask_tokens(torch.from_numpy(ids), torch.from_numpy(mask), 4,
                           BERT["vocab_size"], SPECIAL, 0.3, draws=draws)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert (got[1].numpy() != -100).any()


def test_mask_tokens_laws():
    """15% of the eligible tokens selected, none special or padding, and
    80/10/10 [MASK] / random / kept, each within 3 sigma; deterministic in
    the generator."""
    rng = np.random.RandomState(2)
    n = (64, 256)
    ids = rng.randint(0, 1000, size=n)
    mask = (rng.rand(*n) > 0.1).astype(np.int64)
    ids, mask = torch.from_numpy(ids), torch.from_numpy(mask)
    special = (0, 101, 102, 103)
    g = torch.Generator().manual_seed(0)
    masked, labels = pmlm.mask_tokens(ids, mask, 103, 1000, special,
                                      generator=g)
    again = pmlm.mask_tokens(ids, mask, 103, 1000, special,
                             generator=torch.Generator().manual_seed(0))
    assert torch.equal(masked, again[0]) and torch.equal(labels, again[1])
    selected = labels != -100
    eligible = (mask > 0) & ~torch.isin(ids, torch.tensor(special))
    assert not (selected & ~eligible).any()
    assert torch.equal(labels[selected], ids[selected])
    assert torch.equal(masked[~selected], ids[~selected])

    def within_3_sigma(k, n, p):
        return abs(k - n * p) <= 3 * np.sqrt(n * p * (1 - p))

    n_el, n_sel = int(eligible.sum()), int(selected.sum())
    assert within_3_sigma(n_sel, n_el, 0.15)
    is_mask = int((masked[selected] == 103).sum())
    kept = int((masked[selected] == ids[selected]).sum())
    assert within_3_sigma(is_mask, n_sel, 0.8)
    # a random id can equal the original (1 in 1000) or be 103
    assert within_3_sigma(kept, n_sel, 0.1 + 0.1 / 1000)
    assert within_3_sigma(n_sel - is_mask - kept, n_sel, 0.1 * 0.998)


def test_mlm_logits_and_loss_match_jax():
    jm, params, pm = mlm_pair(4)
    ids, mask = mlm_inputs(5)
    key = jax.random.PRNGKey(6)
    masked, labels = jmlm.mask_tokens(key, jnp.asarray(ids),
                                      jnp.asarray(mask), 4,
                                      BERT["vocab_size"], SPECIAL, 0.3)

    def jloss(p):
        return jmlm.mlm_loss(jmlm.mlm_logits(jm, p, masked,
                                             jnp.asarray(mask)), labels)

    want_logits = np.asarray(jmlm.mlm_logits(jm, params, masked,
                                             jnp.asarray(mask)))
    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(params)
    t_masked = torch.tensor(np.asarray(masked))
    t_labels = torch.tensor(np.asarray(labels))
    logits = pmlm.mlm_logits(pm, t_masked, torch.from_numpy(mask))
    assert logits.dtype == torch.float32
    assert_close(logits.detach().numpy(), want_logits, what="logits")
    loss = pmlm.mlm_loss(logits, t_labels)
    loss.backward()
    assert_close(float(loss.detach()), float(want_loss), what="loss")
    grads = mlm_params_to_jax({n: p.grad for n, p in pm.named_parameters()},
                              BERT["num_attention_heads"])
    assert_grads_close(grads, want_grads)
    # an all-unselected row counts nothing: zero logits give log(vocab)
    lone = pmlm.mlm_loss(torch.zeros(1, 3, 5), torch.tensor([[-100, 2,
                                                               -100]]))
    assert float(lone) == pytest.approx(np.log(5), rel=1e-6)


def test_mlm_refuses_factorized_embeddings():
    pm = pmlm.MLMModel(BertConfig(**dict(BERT, embedding_size=16)))
    ids, mask = mlm_inputs(7)
    with pytest.raises(ValueError, match="embedding_size"):
        pmlm.mlm_logits(pm, torch.from_numpy(ids), torch.from_numpy(mask))


def test_mlm_tree_round_trip():
    _, params, pm = mlm_pair(8)
    back = mlm_params_to_jax(pm.state_dict(), BERT["num_attention_heads"])
    got, want = leaves(back), leaves(params)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w, jax.tree_util.keystr(path))


# ---- Meta-LTR ---------------------------------------------------------------


VIRTUAL_LR = 0.5


@pytest.mark.parametrize("kind", ["knrm", "bert"])
def test_meta_reweight_step_matches_jax(kind, tmp_path):
    """Weights and the weighted loss of one virtual step, and the real
    update's gradient, against JAX on the same params and batches."""
    jm, params, pm = model_pair(kind, seed=10)
    train, dev = ranking_batch(kind, 11), ranking_batch(kind, 12)
    per_example, dev_loss = jax_loss_fns(jm, pm)

    def jloss(p):
        w, loss = jmeta.meta_reweight_step(p, per_example, dev_loss,
                                           to_jax(train), to_jax(dev),
                                           VIRTUAL_LR)
        return loss, w

    (want_loss, want_w), want_grads = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(params)
    assert float(np.asarray(want_w).sum()) == pytest.approx(1.0, abs=1e-5)

    trainer = port_trainer(pmeta_trainer.MetaLTRTrainer, pm, tmp_path)
    seen = {}

    class Recorder:
        def zero_grad(self, set_to_none=True):
            for p in pm.parameters():
                p.grad = None

        def step(self):
            seen.update({n: p.grad.clone() for n, p in
                         pm.named_parameters() if p.grad is not None})

    step = pmeta.make_meta_train_step(trainer.per_example_loss,
                                      trainer.target_loss, VIRTUAL_LR)
    loss, w = step(pm, Recorder(), 0, to_torch(train), to_torch(dev))
    assert w.shape == (B,) and (w >= 0).all()
    np.testing.assert_allclose(w.numpy(), np.asarray(want_w), rtol=0,
                               atol=W_ATOL)
    assert_close(float(loss), float(want_loss), what="loss")
    grads = {n: seen.get(n, torch.zeros_like(p))
             for n, p in pm.named_parameters()}
    assert_grads_close(v1_params_to_jax(grads, pm.num_heads), want_grads)


def test_meta_weights_zero_when_no_example_helps(tmp_path):
    """A dev loss that every example's step raises: all weights 0, not
    uniform, and so is the loss."""
    _, _, pm = model_pair("knrm", seed=13)
    trainer = port_trainer(pmeta_trainer.MetaLTRTrainer, pm, tmp_path)
    batch = to_torch(ranking_batch("knrm", 14))
    params = dict(pm.named_parameters())
    w, loss = pmeta.meta_reweight_step(
        params, trainer.per_example_loss,
        lambda p, b: -trainer.target_loss(p, b), batch, batch, VIRTUAL_LR)
    assert float(w.sum()) in (0.0, 1.0)
    w0, loss0 = pmeta.meta_reweight_step(
        params, trainer.per_example_loss, trainer.target_loss, batch, batch,
        0.0)  # the first warmup step: the virtual step is the identity
    assert not w0.any() and float(loss0.detach()) == 0.0


def test_meta_trainer_steps_match_jax(tmp_path):
    """Two MetaLTRTrainer steps of both packages on the same batches: the
    first (warmup lr 0) has zero weights and moves nothing, the second
    reweights at the live lr from the same parameters. (Later steps start
    from parameters after an Adam update, which magnifies rounding noise:
    the gradient comparison above covers the update.)"""
    jm, params, pm = model_pair("knrm", seed=15)
    common = dict(output_dir=str(tmp_path), learning_rate=0.5,
                  warmup_steps=2, logging_steps=100, save_steps=0)
    jt = jmeta_trainer.MetaLTRTrainer(
        jax_score_fn(jm, pm), params, JaxTrainingArguments(**common), 6,
        mesh=make_mesh(1, 1, devices=jax.devices()[:1]))
    pt = pmeta_trainer.MetaLTRTrainer(pm, TrainingArguments(**common), 6,
                                      device="cpu")
    for step in range(2):
        train, target = ranking_batch("knrm", 20 + step), \
            ranking_batch("knrm", 30 + step)
        want_loss, want_w = jt.train_step(dict(train), dict(target))
        loss, w = pt.train_step(train, target)
        np.testing.assert_allclose(w.numpy(), np.asarray(want_w), rtol=0,
                                   atol=W_ATOL, err_msg=f"step {step}")
        assert_close(float(loss), float(want_loss), what=f"loss {step}")
        assert bool(w.any()) == (step == 1)
    assert pt.step == int(jt.state.step) == 2


def test_cycling_iterator_restarts_and_refuses_empty():
    made = []

    def make():
        made.append(1)
        return iter([1, 2])

    it = pmeta_trainer.CyclingIterator(make)
    assert [next(it) for _ in range(5)] == [1, 2, 1, 2, 1]
    assert len(made) == 3
    empty = pmeta_trainer.CyclingIterator(lambda: iter([]))
    with pytest.raises(ValueError, match="target"):
        next(empty)


# ---- ReInfoSelect -----------------------------------------------------------


def test_policy_mlp_and_sampling_match_jax():
    jp = jris.DataSelectionPolicy(hidden_dim=8)
    feats = np.random.RandomState(16).randn(B, 5).astype(np.float32)
    shapes = jax.eval_shape(jp.init, jax.random.PRNGKey(0),
                            jnp.asarray(feats))["params"]
    params = seeded_tree(shapes, 17)
    pp = pris.DataSelectionPolicy(5, hidden_dim=8)
    pp.load_state_dict(policy_params_from_jax(params), strict=True)
    assert_trees_close(policy_params_to_jax(pp.state_dict()), params, 0.0)
    want = np.asarray(jp.apply({"params": params}, jnp.asarray(feats)))
    got = pp(torch.from_numpy(feats))
    assert_close(got.detach().numpy(), want, what="log_probs")
    key = jax.random.PRNGKey(18)
    want_a = np.asarray(jris.sample_actions(key, jnp.asarray(want)))
    noise = torch.from_numpy(np.asarray(
        jax.random.gumbel(key, want.shape)))
    actions = pris.sample_actions(got.detach(), noise=noise)
    np.testing.assert_array_equal(actions.numpy(), want_a)
    reward = 0.37
    want_l = float(jris.policy_loss(jnp.asarray(want), jnp.asarray(want_a),
                                    jnp.float32(reward)))
    loss = pris.policy_loss(got, actions, reward).detach()
    assert_close(float(loss), want_l, what="policy_loss")


def test_gumbel_selection_with_jax_noise_equals_jax():
    rng = np.random.RandomState(19)
    logits = rng.randn(64, 2).astype(np.float32) * 2
    key = jax.random.PRNGKey(20)
    g_key, a_key = jax.random.split(key)
    noise = np.asarray(jax.random.gumbel(g_key, logits.shape))
    action_noise = np.asarray(jax.random.gumbel(a_key, logits.shape))
    for tau in (1.0, 0.5):
        want = np.asarray(jris.gumbel_keep_log_probs(
            g_key, jnp.asarray(logits), tau))
        got = pris.gumbel_keep_log_probs(torch.from_numpy(logits), tau,
                                         torch.from_numpy(noise))
        assert_close(got.numpy(), want, what=f"log_probs tau {tau}")
        want_a = np.asarray(jris.select_pairs(key, jnp.asarray(logits), tau))
        got_a, got_noise = pris.select_pairs(
            torch.from_numpy(logits), tau, noise=torch.from_numpy(noise),
            action_noise=torch.from_numpy(action_noise))
        np.testing.assert_array_equal(got_a.numpy(), want_a)
        assert torch.equal(got_noise, torch.from_numpy(noise))


def test_selection_laws_under_a_generator():
    """Deterministic in the generator; a keep-favouring logit keeps more;
    noise is standard Gumbel (mean ~0.5772)."""
    logits = torch.tensor([[0.0, 2.0]]).repeat(4096, 1)

    def draw(seed):
        return pris.select_pairs(logits, 1.0,
                                 torch.Generator().manual_seed(seed))

    a, n = draw(0)
    b, m = draw(0)
    assert torch.equal(a, b) and torch.equal(n, m)
    assert set(a.unique().tolist()) <= {0, 1}
    assert a.float().mean() > 0.7
    assert abs(float(n.mean()) - 0.5772) < 0.05


def capture_tx():
    """An optax transformation whose new state is the gradient itself and
    whose update is zero: the JAX refresh then returns its gradient."""
    def update(grads, state, params=None):
        return jax.tree.map(jnp.zeros_like, grads), grads

    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p), update)


class GradRecorder:
    def __init__(self, module):
        self.module, self.grads = module, None

    def zero_grad(self, set_to_none=True):
        for p in self.module.parameters():
            p.grad = None

    def step(self):
        self.grads = {n: (p.grad if p.grad is not None
                          else torch.zeros_like(p)).clone()
                      for n, p in self.module.named_parameters()}


@pytest.mark.parametrize("reward", [0.25, -0.5])
def test_refresh_gradient_matches_jax(reward):
    """The REINFORCE refresh over three buffered steps (a KNRM
    classification policy), both signs of the reward, the same noise."""
    jm, params, pm = model_pair("knrm", task="classification", seed=21)
    tau = 0.7
    score = jax_score_fn(jm, pm)
    select = jax.jit(lambda p, x, key: jris.select_pairs(key, score(p, x),
                                                         tau))
    steps = []
    for s in range(3):
        pos, _ = pv1._default_pos_neg_split(ranking_batch("knrm", 40 + s))
        key = jax.random.PRNGKey(50 + s)
        steps.append((pos, key, np.asarray(select(params, to_jax(pos),
                                                  key))))
    refresh = jris.make_policy_refresh(score, capture_tx(), tau)
    stack = lambda xs: jnp.stack([jnp.asarray(x) for x in xs])  # noqa: E731
    _, want = refresh(params, capture_tx().init(params),
                      {k: stack([p[k] for p, _, _ in steps])
                       for k in steps[0][0]},
                      jnp.stack([k for _, k, _ in steps]),
                      stack([a for _, _, a in steps]), reward)
    buffer = []
    for pos, key, actions in steps:
        g_key, _ = jax.random.split(key)
        noise = np.asarray(jax.random.gumbel(g_key, (B, 2)))
        buffer.append((to_torch(pos), torch.from_numpy(noise),
                       torch.from_numpy(actions)))
    rec = GradRecorder(pm)
    pris.make_policy_refresh(lambda x: pm.score_batch(x)[0], rec, tau)(
        buffer, reward)
    assert_grads_close(v1_params_to_jax(rec.grads, pm.num_heads), want,
                       "refresh grad")


def drop_or_keep_policy(query_idx):
    """Drops every pair of a batch whose first query token is 1, keeps
    every pair otherwise."""
    keep = (query_idx[:, :1] != 1) * 2.0 - 1.0
    return keep * np.array([[-1e4, 1e4]], np.float32)


def test_zero_kept_batch_counters_match_jax(tmp_path):
    """A zero-kept batch advances the trainer's step but not the
    optimizer's count (so the schedule lags the step by one after it) and
    leaves the ranker as it was; a kept batch then takes the first update.
    Both packages, the same batches."""
    jm, params, pm = model_pair("knrm", seed=22)
    drop, keep = ranking_batch("knrm", 60), ranking_batch("knrm", 61)
    drop["query_idx"][:, 0] = 1
    keep["query_idx"][:, 0] = 2
    common = dict(output_dir=str(tmp_path), learning_rate=0.05,
                  warmup_ratio=0.0, logging_steps=1000, save_steps=0)
    jt = jris_trainer.ReInfoSelectTrainer(
        jax_score_fn(jm, pm), params,
        lambda p, x: jnp.asarray(drop_or_keep_policy(x["query_idx"])),
        {"unused": jnp.zeros(1)}, JaxTrainingArguments(**common), 5,
        ranking_loss_kind="triplet_loss",
        mesh=make_mesh(1, 1, devices=jax.devices()[:1]))
    pt = pris_trainer.ReInfoSelectTrainer(
        pm, torch.nn.Linear(1, 1), TrainingArguments(**common), 5,
        ranking_loss_kind="triplet_loss", device="cpu",
        policy_score_fn=lambda x: torch.from_numpy(
            drop_or_keep_policy(x["query_idx"].numpy())))
    before = v1_params_to_jax(pm.state_dict(), pm.num_heads)
    for batch, kept in ((drop, 0), (drop, 0), (keep, 1)):
        want_loss = jt._step_fn(jt.state, jt.policy_params, to_jax(batch),
                                jax.random.PRNGKey(0))
        jt.state = want_loss[0]
        loss, actions = pt.train_step(batch)
        assert int(actions.sum()) == kept * B
        assert_close(float(loss), float(want_loss[2]), what="loss")
        if not kept:
            assert_trees_close(v1_params_to_jax(pm.state_dict(),
                                                pm.num_heads), before, 0.0)
    opt_count = int(jt.state.opt_state[1][0].count)
    assert (pt.step, pt.optimizer.param_groups[0]["count"]) == \
        (int(jt.state.step), opt_count) == (3, 1)
    assert pt.scheduler.last_epoch == 1
    assert_trees_close(v1_params_to_jax(pm.state_dict(), pm.num_heads),
                       jt.state.params, PARAM_REL, "params")


def test_policy_inputs_mapping_matches_jax():
    word = ranking_batch("knrm", 62)
    bert = ranking_batch("bert", 63)
    edrm = {"query_wrd_idx": 1, "query_wrd_mask": 2, "doc_pos_wrd_idx": 3,
            "doc_pos_wrd_mask": 4, "doc_neg_wrd_idx": 5}
    cls = {"query_idx": 1, "query_mask": 2, "doc_idx": 3, "doc_mask": 4}
    for batch in (word, bert, edrm, cls):
        want = jris_trainer.policy_inputs_from_batch(batch)
        got = pris_trainer.policy_inputs_from_batch(batch)
        assert got.keys() == want.keys()
        assert all(got[k] is want[k] for k in want)


@pytest.mark.parametrize("kind", ["margin_loss", "CE_loss", "triplet_loss"])
def test_per_pair_losses_match_jax(kind):
    rng = np.random.RandomState(64)
    pos, neg = rng.randn(2, B).astype(np.float32)
    want = np.asarray(jris_trainer.per_pair_ranking_loss(
        jnp.asarray(pos), jnp.asarray(neg), kind))
    got = pris_trainer.per_pair_ranking_loss(torch.from_numpy(pos),
                                             torch.from_numpy(neg), kind)
    assert_close(got.numpy(), want, what=kind)


# ---- the drivers ------------------------------------------------------------

WORDS = ["apple", "banana", "cherry", "grape", "melon", "fruit", "stone",
         "rock"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A word vocab, a tiny HF BERT with its tokenizer, source pairs (even
    rows clean, odd rows with pos and neg swapped), clean target pairs, a
    dev set with qrels, and an MLM text file."""
    from transformers import BertConfig as HFBertConfig, BertModel
    from transformers import BertTokenizerFast

    d = tmp_path_factory.mktemp("research")
    (d / "vocab.txt").write_text("\n".join(WORDS))
    torch.manual_seed(0)
    BertModel(HFBertConfig(**BERT)).save_pretrained(d / "hf")
    (d / "bert_vocab.txt").write_text("\n".join(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS
        + [f"w{i}" for i in range(BERT["vocab_size"] - 13)]))
    tok = BertTokenizerFast(vocab_file=str(d / "bert_vocab.txt"))
    tok.save_pretrained(d / "hf")

    def row(i, swap=False):
        f = WORDS[i % 4]
        pos, neg = f"{f} {f} fruit", "stone rock"
        if swap:
            pos, neg = neg, pos
        return {"query": f"{f} fruit", "doc_pos": pos, "doc_neg": neg}

    (d / "source.jsonl").write_text("".join(
        json.dumps(row(i, i % 2 == 1)) + "\n" for i in range(16)))
    (d / "target.jsonl").write_text("".join(
        json.dumps(row(i)) + "\n" for i in range(8)))
    with open(d / "dev.jsonl", "w") as f, open(d / "qrels", "w") as q:
        for j, fruit in enumerate(WORDS[:4]):
            other = WORDS[(j + 1) % 4]
            docs = [(f"{fruit} {fruit} fruit", 1), ("stone rock", 0),
                    (f"{other} fruit melon", 0), (f"{fruit} rock stone", 0),
                    ("fruit fruit melon", 0)]
            for k, (doc, label) in enumerate(docs):
                f.write(json.dumps({
                    "query_id": f"q{j}", "doc_id": f"d{j}_{k}",
                    "label": label, "retrieval_score": 1.0,
                    "query": f"{fruit} fruit", "doc": doc}) + "\n")
                q.write(f"q{j} 0 d{j}_{k} {label}\n")
    (d / "texts.txt").write_text("".join(
        f"{WORDS[i % 8]} fruit {WORDS[(i * 3) % 8]} w{i % 40} rock\n"
        for i in range(24)))
    return d, tok


def word_flags(d):
    return ["-vocab", str(d / "vocab.txt"), "-embed_dim", "8",
            "-max_query_len", "4", "-max_doc_len", "8"]


def bert_flags(d):
    return ["-model", "bert", "-pretrain", str(d / "hf"), "-max_query_len",
            "4", "-max_doc_len", "8"]


def test_meta_train_main_end_to_end(files, tmp_path, capsys):
    from openmatch_tpu.train.v1_trainer import V1Trainer as JaxV1Trainer

    d, _ = files
    save = tmp_path / "run"
    out = pmeta_train.main(["-model", "knrm", "-task", "ranking",
                            "-ranking_loss", "triplet_loss",
                            "-train", str(d / "source.jsonl"),
                            "-target", str(d / "target.jsonl"),
                            "-dev", str(d / "dev.jsonl"),
                            "-qrels", str(d / "qrels"),
                            "-save_folder", str(save), "-epoch", "2",
                            "-train_batch_size", "8",
                            "-target_batch_size", "8", "-lr", "0.05",
                            "-n_warmup_steps", "1", "-eval_every", "2",
                            "-eval_during_train", "-log_weights",
                            "--device", "cpu"] + word_flags(d))
    assert "mean weight" in capsys.readouterr().out
    assert out["final_step"] == 4
    lines = (save / "weights.txt").read_text().splitlines()
    assert len(lines) == 4 and all(len(x.split("\t")) == 9 for x in lines)
    for w in out["weights"]:
        assert (w >= 0).all() and float(w.sum()) in (
            pytest.approx(0.0), pytest.approx(1.0, abs=1e-5))
    for sub in ("best", "final"):
        assert (save / sub / "train_state.msgpack").exists()
    assert (save / "latest_dev.trec").exists()
    # the JAX package restores the final checkpoint as its own
    jm = jmodels.KNRM(vocab_size=9, embed_dim=8)
    z = jnp.zeros((1, 4), jnp.int32)
    tree = jm.init(jax.random.PRNGKey(0), z, jnp.ones((1, 4)), z,
                   jnp.ones((1, 4)))["params"]
    jt = JaxV1Trainer(lambda p, b: 0.0, tree, JaxTrainingArguments(), 4,
                      mesh=make_mesh(1, 1, devices=jax.devices()[:1]))
    state = jstate.load_train_state(str(save / "final"), jt.state)
    assert int(state.step) == 4


def test_meta_train_main_bert(files, tmp_path):
    d, tok = files
    out = pmeta_train.main(bert_flags(d) + [
        "-task", "ranking", "-train", str(d / "source.jsonl"),
        "-target", str(d / "target.jsonl"), "-save_folder",
        str(tmp_path / "bert"), "-epoch", "1", "-train_batch_size", "8",
        "-target_batch_size", "8", "-lr", "0.001", "-n_warmup_steps", "1",
        "--device", "cpu"], tokenizer=tok)
    assert out["final_step"] == 2
    assert (tmp_path / "bert" / "final" / "train_state.msgpack").exists()


@pytest.mark.parametrize("model", ["knrm", "bert"])
def test_train_v1_reinfoselect_end_to_end(files, tmp_path, capsys, model):
    d, tok = files
    save = tmp_path / "ckpt"
    flags = (bert_flags(d) if model == "bert"
             else ["-model", "knrm"] + word_flags(d))
    seen = []
    real = pris_trainer.ReInfoSelectTrainer.refresh_policy

    def refresh(self, reward):
        before = [p.detach().clone() for p in self.policy.parameters()]
        real(self, reward)
        seen.append((reward, any(not torch.equal(a, b) for a, b in
                                 zip(before, self.policy.parameters()))))

    pris_trainer.ReInfoSelectTrainer.refresh_policy = refresh
    try:
        out = ptrain_v1.main(flags + [
            "-task", "ranking", "-ranking_loss", "triplet_loss",
            "-reinfoselect", "-reset", "-train", str(d / "source.jsonl"),
            "-dev", str(d / "dev.jsonl"), "-qrels", str(d / "qrels"),
            "-save", str(save), "-res", str(tmp_path / "res.trec"),
            "-epoch", "3", "-batch_size", "8", "-lr",
            "0.05" if model == "bert" else "0.5", "-eval_every", "2",
            "-tau", "1.0", "--device", "cpu"],
            tokenizer=tok if model == "bert" else None)
    finally:
        pris_trainer.ReInfoSelectTrainer.refresh_policy = real
    assert "keep-rate" in capsys.readouterr().out
    assert out["final_step"] == 6 and len(out["keep_rates"]) == 6
    assert all(0.0 <= r <= 1.0 for r in out["keep_rates"])
    # the policy stays until a refresh has a reward, and moves at every
    # refresh from then on (Adam's moments carry it)
    assert len(seen) == 3
    first = [reward != 0 for reward, _ in seen].index(True)
    assert [moved for _, moved in seen] == [i >= first for i in range(3)]
    lines = (tmp_path / "res.trec").read_text().splitlines()
    assert lines and all(len(x.split()) == 6 for x in lines)
    args = ptrain_v1.argparse.ArgumentParser()
    ptrain_v1.add_model_args(args)
    parsed = args.parse_args(flags)
    model_ = ptrain_v1.build_v1_model(parsed, tok if model == "bert" else
                                      ptrain_v1.build_v1_tokenizer(parsed))
    pv1.load_v1_params(model_, str(save / "best"))


def test_train_mlm_main_end_to_end(files, tmp_path):
    """train_mlm on a tiny HF BERT: finite losses; train_state.msgpack
    restores through the JAX package's load_train_state to the port's
    weights; the exported encoder loads in both packages and encodes as
    the trained encoder does."""
    from openmatch_tpu.models.dr_model import DRModel as JaxDRModel
    from openmatch_tpu_torch.models.dr_model import DRModel

    d, tok = files
    out_dir = tmp_path / "mlm"
    out = ptrain_mlm.main([
        "--model_name_or_path", str(d / "hf"), "--train_path",
        str(d / "texts.txt"), "--output_dir", str(out_dir), "--max_steps",
        "4", "--per_device_train_batch_size", "4", "--p_max_len", "12",
        "--learning_rate", "1e-3", "--logging_steps", "2", "--device",
        "cpu"], tokenizer=tok)
    assert out["final_step"] == 4 and len(out["losses"]) == 2
    assert np.isfinite(out["losses"]).all()
    model = out["model"]

    jm = jmlm.MLMModel(JaxBertConfig(**dict(BERT, add_pooler=True)))
    ids = jnp.zeros((1, 8), jnp.int32)
    template = jm.init(jax.random.PRNGKey(0), ids, jnp.ones_like(ids))[
        "params"]
    state = jstate.load_train_state(str(out_dir), jstate.TrainState.create(
        template, jstate.make_optimizer(JaxTrainingArguments(), 4)))
    assert int(state.step) == 4
    assert int(state.opt_state[1][0].count) == 4
    assert_trees_close(state.params, mlm_params_to_jax(
        model.state_dict(), BERT["num_attention_heads"]), 0.0)

    ids, mask = mlm_inputs(65, s=10)
    with torch.no_grad():
        want = model.bert(torch.from_numpy(ids), torch.from_numpy(mask))[
            "last_hidden_state"][:, 0]
        dr = DRModel.load(str(out_dir), device="cpu")
        got = dr.encode_passage(torch.from_numpy(ids), torch.from_numpy(mask))
    assert torch.equal(got, want)
    jdr, jparams = JaxDRModel.load(str(out_dir))
    jrep = jdr.encode_passage(jparams, jnp.asarray(ids), jnp.asarray(mask))
    assert_close(np.asarray(jrep), want.numpy(), what="JAX encode")
