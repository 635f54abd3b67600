"""The port's training path against the JAX package on the same inputs and
weights (CPU, fp32, tiny shapes: 2 layers, hidden 64, 4 heads, vocab 128;
dropout 0 unless a test says otherwise):

- losses: value and gradient with respect to the reps, rtol 1e-6 plus an
  absolute 1e-6 x (1 + max|value|) (``close``);
- optimizers: ``make_optimizer`` adamw and lamb, with warmup and a clip that
  triggers, 5 updates against the optax chain, within ``close``;
- one ``DRTrainer`` step pair against the JAX ``DRTrainer`` on a one-device
  mesh (losses and every updated parameter within 1e-5; Adam's epsilon is
  1e-4 there, see ``train_kw``);
- GradCache against the plain step (1e-5) and JAX's
  ``grad_cache_value_and_grad`` (1e-5); with dropout, against a plain
  gradient drawn with the same per-chunk generator states (1e-5);
- resume: 4 steps straight equal 2 + checkpoint + resume + 2, exactly; the
  ``train_state.msgpack`` of either package resumes in the other (AdamW
  and LAMB), the next step within 1e-5 of the writer's;
- data: collators, pair encodings and train datasets over 2 epochs, exact;
- defaults: the trainer and the driver run on the card unless told.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import openmatch_tpu.losses as jlosses
from openmatch_tpu.config import DataArguments as JaxDataArguments
from openmatch_tpu.config import TrainingArguments as JaxTrainingArguments
from openmatch_tpu.data import collators as jcollators
from openmatch_tpu.data import tokenization as jtokenization
from openmatch_tpu.data import train_dataset as jtrain_dataset
from openmatch_tpu.drivers import common as jcommon
from openmatch_tpu.models.bert import BertConfig as JaxBertConfig
from openmatch_tpu.models.dr_model import DRModel as JaxDRModel
from openmatch_tpu.parallel.grad_cache import grad_cache_value_and_grad
from openmatch_tpu.parallel.mesh import make_mesh
from openmatch_tpu.train.dr_trainer import DRTrainer as JaxDRTrainer
from openmatch_tpu.train.state import make_optimizer as jax_make_optimizer
from openmatch_tpu_torch import losses
from openmatch_tpu_torch.config import DataArguments, TrainingArguments
from openmatch_tpu_torch.data import collators, tokenization, train_dataset
from openmatch_tpu_torch.drivers import common
from openmatch_tpu_torch.models.bert import BertConfig
from openmatch_tpu_torch.models.dr_model import DRModel
from openmatch_tpu_torch.models.jax_convert import (params_from_jax,
                                                    params_to_jax)
from openmatch_tpu_torch.parallel.grad_cache import (grad_cache_backward,
                                                     split_batch)
from openmatch_tpu_torch.train.dr_trainer import DRTrainer
from openmatch_tpu_torch.train.state import make_optimizer

torch.set_num_threads(2)
SMALL = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=128,
             max_position_embeddings=40)
DROPOUT = dict(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)


def grads_of(fn, *arrays):
    """Port: value and gradients of fn with respect to each array."""
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    value = fn(*ts)
    value.backward()
    return value.detach().numpy(), [t.grad.numpy() for t in ts]


def close(got, want):
    """rtol 1e-6, plus 1e-6 x (1 + max|want|) absolute: gradient entries are
    sums of O(max|want|) fp32 terms taken in another order, which cancel."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-6,
                               atol=1e-6 * (1 + np.abs(want).max()))


# ---- losses ---------------------------------------------------------------


def reps(seed, n_q=4, n_p=12, d=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n_q, d), dtype=np.float32),
            rng.standard_normal((n_p, d), dtype=np.float32))


def test_contrastive_targets_stride():
    np.testing.assert_array_equal(losses.contrastive_targets(4, 12).numpy(),
                                  np.asarray(jlosses.contrastive_targets(4, 12)))


@pytest.mark.parametrize("temperature", [1.0, 0.05])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_simple_contrastive_loss_matches_jax(reduction, temperature):
    q, p = reps(1)
    w = np.random.default_rng(2).standard_normal(4).astype(np.float32)

    def reduce(x, lib):
        return (x * (w if lib is jnp else torch.from_numpy(w))).sum() \
            if reduction == "none" else x

    def jfn(a, b):
        return reduce(jlosses.simple_contrastive_loss(
            a, b, reduction=reduction, temperature=temperature), jnp)

    def pfn(a, b):
        return reduce(losses.simple_contrastive_loss(
            a, b, reduction=reduction, temperature=temperature), torch)

    want, want_g = jax.value_and_grad(jfn, argnums=(0, 1))(q, p)
    got, got_g = grads_of(pfn, q, p)
    close(got, want)
    for a, b in zip(got_g, want_g):
        close(a, b)


@pytest.mark.parametrize("temperature", [1.0, 0.05])
def test_dual_contrastive_loss_matches_jax(temperature):
    q, p = reps(3)

    def jfn(a, b):
        return jlosses.dual_contrastive_loss(a, b, 0.3, temperature)

    want, want_g = jax.value_and_grad(jfn, argnums=(0, 1))(q, p)
    got, got_g = grads_of(lambda a, b: losses.dual_contrastive_loss(
        a, b, 0.3, temperature), q, p)
    close(got, want)
    for a, b in zip(got_g, want_g):
        close(a, b)


def test_contrastive_loss_with_scores_matches_jax():
    q, p = reps(4)
    want_loss, want_scores = jlosses.contrastive_loss_with_scores(q, p)
    got_loss, got_scores = losses.contrastive_loss_with_scores(
        torch.from_numpy(q), torch.from_numpy(p))
    close(got_loss, want_loss)
    close(got_scores, want_scores)
    want, want_g = jax.value_and_grad(
        lambda a, b: jlosses.contrastive_loss_with_scores(a, b)[0],
        argnums=(0, 1))(q, p)
    got, got_g = grads_of(
        lambda a, b: losses.contrastive_loss_with_scores(a, b)[0], q, p)
    for a, b in zip(got_g, want_g):
        close(a, b)


@pytest.mark.parametrize("name", sorted(jlosses.rr_loss_functions))
def test_rr_losses_match_jax(name):
    rng = np.random.default_rng(5)
    shape = (6, 2) if name == "ce" else (6,)
    pos = rng.standard_normal(shape, dtype=np.float32)
    neg = rng.standard_normal(shape, dtype=np.float32)
    want, want_g = jax.value_and_grad(jlosses.rr_loss_functions[name],
                                      argnums=(0, 1))(pos, neg)
    got, got_g = grads_of(losses.rr_loss_functions[name], pos, neg)
    close(got, want)
    for a, b in zip(got_g, want_g):
        close(a, b)


# ---- optimizers -----------------------------------------------------------


@pytest.mark.parametrize("name", ["adamw", "lamb"])
def test_optimizer_matches_optax(name):
    kw = dict(learning_rate=0.05, weight_decay=0.01, max_grad_norm=1.0,
              warmup_steps=2, optimizer=name, adam_epsilon=1e-6)
    rng = np.random.default_rng(6)
    params0 = [rng.standard_normal((4, 3), dtype=np.float32),
               rng.standard_normal(5, dtype=np.float32),
               np.zeros(3, np.float32),  # LAMB's zero-norm trust ratio
               rng.standard_normal(2, dtype=np.float32)]  # never a gradient
    tx = jax_make_optimizer(JaxTrainingArguments(**kw), total_steps=5)
    jparams = [jnp.asarray(x) for x in params0]
    state = tx.init(jparams)
    ps = [torch.nn.Parameter(torch.tensor(x)) for x in params0]
    opt, sched = make_optimizer(ps, TrainingArguments(**kw), total_steps=5)
    clipped = 0
    for step in range(5):
        scale = 3.0 if step % 2 else 0.1  # the clip triggers on odd steps
        grads = [scale * rng.standard_normal(x.shape, dtype=np.float32)
                 for x in params0[:3]] + [np.zeros(2, np.float32)]
        clipped += optax.global_norm(grads) >= 1.0
        updates, state = tx.update([jnp.asarray(g) for g in grads], state,
                                   jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, g in zip(ps[:3], grads):
            p.grad = torch.tensor(g)
        ps[3].grad = None
        opt.step()
        sched.step()
        if step == 0:  # optax's schedule at count 0 under warmup: lr 0
            for p, x in zip(ps, params0):
                assert torch.equal(p.detach(), torch.from_numpy(x))
        for p, want in zip(ps, jparams):
            close(p.detach().numpy(), want)
    assert clipped >= 2


# ---- one train step against the JAX trainer -------------------------------


def jax_and_port(seed=0, cfg=SMALL, **kw):
    jm = JaxDRModel(encoder_config=JaxBertConfig(**cfg), dtype=jnp.float32,
                    **kw)
    params = jax.tree.map(lambda x: np.asarray(x, np.float32),
                          jm.init_params(jax.random.PRNGKey(seed)))
    pm = DRModel(BertConfig(**cfg), **kw)
    pm.load_state_dict(params_from_jax(params), strict=True)
    return jm, params, pm


def qp_batch(seed=7, n_q=4, n_psg=2, sq=8, sp=12):
    rng = np.random.RandomState(seed)

    def part(n, s):
        ids = rng.randint(5, 128, size=(n, s)).astype(np.int32)
        lengths = rng.randint(3, s + 1, size=n)
        mask = (np.arange(s)[None] < lengths[:, None]).astype(np.int32)
        return {"input_ids": ids * mask, "attention_mask": mask}

    return {"query": part(n_q, sq), "passage": part(n_q * n_psg, sp)}


def train_kw(**extra):
    # adam_epsilon 1e-4: a gradient that is 0 but for float noise (the key
    # bias's: softmax ignores a shift shared by a row's logits) would
    # otherwise be scaled by Adam to a full +-lr step of random sign; the
    # update rule itself is held to optax by test_optimizer_matches_optax
    return dict(dict(learning_rate=1e-3, weight_decay=0.01, warmup_steps=0,
                     adam_epsilon=1e-4,
                     warmup_ratio=0.0, seed=0, per_device_train_batch_size=4,
                     logging_steps=1, save_steps=0), **extra)


STEPS = {
    "tied": ({}, {}),
    "untied": (dict(tied=False), {}),
    "head": (dict(has_head=True, head_in_dim=64, head_out_dim=32), {}),
    "normalize_temperature": (dict(normalize=True),
                              dict(score_temperature=0.05)),
    "dual": ({}, dict(dual_learning=True, dual_weight=0.5)),
    "grad_cache": ({}, dict(grad_cache=True, gc_q_chunk_size=2,
                            gc_p_chunk_size=4)),
}


@pytest.mark.parametrize("name", sorted(STEPS))
def test_train_step_matches_jax_trainer(name):
    model_kw, args_kw = STEPS[name]
    jm, params, pm = jax_and_port(1, **model_kw)
    mesh = make_mesh(1, 1, devices=jax.devices()[:1])
    jt = JaxDRTrainer(jm, params, JaxTrainingArguments(**train_kw(**args_kw)),
                      total_steps=10, mesh=mesh)
    pt = DRTrainer(pm, TrainingArguments(**train_kw(**args_kw)),
                   total_steps=10, device="cpu")
    # the first update has lr 0 (optax's count), the second moves the params
    for seed in (7, 8):
        b = qp_batch(seed)
        want = float(jt.train_step(b))
        got = float(pt.train_step(b))
        assert got == pytest.approx(want, rel=1e-5, abs=1e-5)
    want_tree = jax.tree.map(np.asarray, jt.state.params)
    got_tree = params_to_jax(pm.state_dict(), SMALL["num_attention_heads"])
    got_leaves = jax.tree_util.tree_leaves_with_path(got_tree)
    want_leaves = jax.tree_util.tree_leaves_with_path(want_tree)
    assert [k for k, _ in got_leaves] == [k for k, _ in want_leaves]
    for (path, got), (_, want) in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))
    moved = [not np.array_equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(got_tree), jax.tree_util.tree_leaves(params))]
    assert all(moved)  # weight decay moves even the unused leaves
    assert pt.step == int(jt.state.step) == 2


# ---- GradCache ------------------------------------------------------------


def port_grads(model):
    return {n: (p.grad.clone() if p.grad is not None
                else torch.zeros_like(p))
            for n, p in model.named_parameters()}


def torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def encoders(model):
    return (lambda b, g=None: model.encode_query(b["input_ids"],
                                                 b["attention_mask"], g),
            lambda b, g=None: model.encode_passage(b["input_ids"],
                                                   b["attention_mask"], g))


def test_grad_cache_matches_plain_and_jax():
    jm, params, pm = jax_and_port(2, tied=False)
    b = qp_batch(9)
    q, p = torch_batch(b["query"]), torch_batch(b["passage"])
    enc_q, enc_p = encoders(pm)
    loss = losses.simple_contrastive_loss(enc_q(q), enc_p(p))
    loss.backward()
    plain = port_grads(pm)
    pm.zero_grad(set_to_none=True)
    gc_loss = grad_cache_backward(enc_q, enc_p,
                                  losses.simple_contrastive_loss, q, p,
                                  q_chunks=2, p_chunks=4)
    gc = port_grads(pm)
    assert float(gc_loss) == pytest.approx(float(loss.detach()), rel=1e-5)
    for n in plain:
        np.testing.assert_allclose(gc[n].numpy(), plain[n].numpy(),
                                   atol=1e-5, err_msg=n)
    vg = grad_cache_value_and_grad(
        lambda pr, x: jm.encode_query(pr, x["input_ids"],
                                      x["attention_mask"]),
        lambda pr, x: jm.encode_passage(pr, x["input_ids"],
                                        x["attention_mask"]),
        jlosses.simple_contrastive_loss, q_chunks=2, p_chunks=4)
    j_loss, j_grads = vg(params, b["query"], b["passage"])
    assert float(gc_loss) == pytest.approx(float(j_loss), rel=1e-5)
    got = jax.tree_util.tree_leaves(params_to_jax(gc, 4))
    want = jax.tree_util.tree_leaves(j_grads)
    assert len(got) == len(want)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(w), atol=1e-5)


def test_grad_cache_replays_dropout_masks():
    pm = DRModel(BertConfig(**SMALL, **DROPOUT)).train()
    assert pm.dropout_active
    b = qp_batch(10)
    q, p = torch_batch(b["query"]), torch_batch(b["passage"])
    enc_q, enc_p = encoders(pm)
    g = torch.Generator()
    # plain gradient with the generator states the chunks see in GradCache
    g.manual_seed(5)
    q_reps = torch.cat([enc_q(c, g) for c in split_batch(q, 2)])
    p_reps = torch.cat([enc_p(c, g) for c in split_batch(p, 4)])
    loss = losses.simple_contrastive_loss(q_reps, p_reps)
    loss.backward()
    plain = port_grads(pm)
    pm.zero_grad(set_to_none=True)
    g.manual_seed(5)
    gc_loss = grad_cache_backward(enc_q, enc_p,
                                  losses.simple_contrastive_loss, q, p, 2, 4,
                                  generator=g)
    assert float(gc_loss) == pytest.approx(float(loss.detach()), rel=1e-5)
    for n, v in port_grads(pm).items():
        np.testing.assert_allclose(v.numpy(), plain[n].numpy(), atol=1e-5,
                                   err_msg=n)

    def step_loss(seed, model):
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return float(losses.simple_contrastive_loss(
                model.encode_query(q["input_ids"], q["attention_mask"], gen),
                model.encode_passage(p["input_ids"], p["attention_mask"],
                                     gen)))

    no_dropout = DRModel(BertConfig(**SMALL)).train()
    no_dropout.load_state_dict(pm.state_dict())
    assert step_loss(3, pm) == step_loss(3, pm)
    assert step_loss(3, pm) != step_loss(4, pm)
    assert step_loss(3, pm) != step_loss(3, no_dropout)
    with torch.no_grad():  # eval mode and no generator: the serving graph
        pm.eval()
        want = no_dropout.eval().encode_query(q["input_ids"],
                                              q["attention_mask"])
        assert torch.equal(pm.encode_query(q["input_ids"],
                                           q["attention_mask"],
                                           torch.Generator()), want)


# ---- resume ---------------------------------------------------------------


def test_resume_equals_straight_run(tmp_path):
    cfg = dict(SMALL, **DROPOUT)
    _, _, base = jax_and_port(3, cfg)
    batches = [qp_batch(s) for s in range(11, 15)]

    def trainer(out):
        m = DRModel(BertConfig(**cfg))
        m.load_state_dict(base.state_dict())
        return DRTrainer(m, TrainingArguments(**train_kw(
            output_dir=str(out), warmup_steps=1, grad_cache=True,
            gc_q_chunk_size=2, gc_p_chunk_size=4)), total_steps=4,
            device="cpu")

    straight = trainer(tmp_path / "a")
    for b in batches:
        straight.train_step(b)
    first = trainer(tmp_path / "b")
    for b in batches[:2]:
        first.train_step(b)
    first.save_checkpoint()
    resumed = trainer(tmp_path / "b")
    assert resumed.maybe_resume()
    assert resumed.step == 2
    for b in batches[2:]:
        resumed.train_step(b)
    assert resumed.step == straight.step == 4
    for (n, a), (_, w) in zip(resumed.model.state_dict().items(),
                              straight.model.state_dict().items()):
        assert torch.equal(a, w), n
    assert json.loads((tmp_path / "b" / "checkpoint-2" /
                       "train_state.json").read_text()) == {"step": 2}


def assert_params_match(pm, jax_params, rtol=0.0, atol=0.0):
    got = jax.tree_util.tree_leaves_with_path(
        params_to_jax(pm.state_dict(), SMALL["num_attention_heads"]))
    want = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, jax_params))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("optimizer", ["adamw", "lamb"])
def test_checkpoint_resumes_across_packages(tmp_path, optimizer):
    """DR checkpoints are the JAX package's ``train_state.msgpack``: the
    port's resumes in JAX's ``DRTrainer.maybe_resume`` (``load_train_state``
    takes its tree as it is) with the port's parameters exactly, and JAX's
    resumes in the port; either way the next step then equals the writer's
    own next step (1e-5). LAMB's chain state differs from AdamW's."""
    mesh = make_mesh(1, 1, devices=jax.devices()[:1])
    jm, params, pm = jax_and_port(4)
    first, nxt = [qp_batch(s) for s in (7, 8)], qp_batch(9)

    def args(out, lib):
        kw = train_kw(output_dir=str(out), warmup_steps=1,
                      optimizer=optimizer)
        return (TrainingArguments if lib == "port"
                else JaxTrainingArguments)(**kw)

    def port(out):
        m = DRModel(BertConfig(**SMALL))
        m.load_state_dict(pm.state_dict())
        return DRTrainer(m, args(out, "port"), total_steps=10, device="cpu")

    def jaxt(out):
        return JaxDRTrainer(jm, params, args(out, "jax"), total_steps=10,
                            mesh=mesh)

    # the port writes, JAX resumes
    writer = port(tmp_path / "a")
    for b in first:
        writer.train_step(b)
    writer.save_checkpoint()
    reader = jaxt(tmp_path / "a")
    assert reader.maybe_resume() and int(reader.state.step) == 2
    assert_params_match(writer.model, reader.state.params)
    want = float(writer.train_step(nxt))
    assert float(reader.train_step(nxt)) == pytest.approx(want, rel=1e-5,
                                                          abs=1e-5)
    assert_params_match(writer.model, reader.state.params, 1e-5, 1e-5)

    # JAX writes, the port resumes
    writer = jaxt(tmp_path / "b")
    for b in first:
        writer.train_step(b)
    writer.save_checkpoint()
    reader = port(tmp_path / "b")
    assert reader.maybe_resume() and reader.step == 2
    assert reader.optimizer.param_groups[0]["count"] == 2
    assert_params_match(reader.model, writer.state.params)
    want = float(writer.train_step(nxt))
    assert float(reader.train_step(nxt)) == pytest.approx(want, rel=1e-5,
                                                          abs=1e-5)
    assert_params_match(reader.model, writer.state.params, 1e-5, 1e-5)


# ---- data -----------------------------------------------------------------


@pytest.fixture(scope="module")
def tokenizer(tmp_path_factory):
    from transformers import BertTokenizerFast

    d = tmp_path_factory.mktemp("tok")
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [
        f"w{i}" for i in range(40)]
    (d / "vocab.txt").write_text("\n".join(vocab))
    return BertTokenizerFast(vocab_file=str(d / "vocab.txt"))


def test_collators_match_jax():
    rng = np.random.RandomState(1)
    ids = lambda n: list(rng.randint(5, 40, size=n))  # noqa: E731
    feats = [{"query": ids(3), "passages": [ids(6), ids(2), ids(9)]},
             {"query": ids(12), "passages": [ids(1), ids(4), ids(20)]}]
    for mine, theirs in ((collators.QPCollator(0, 8, 10),
                          jcollators.QPCollator(0, 8, 10)),):
        got, want = mine(feats), theirs(feats)
        for side in want:
            for k in want[side]:
                np.testing.assert_array_equal(got[side][k], want[side][k])
    pairs = [{"pos_pair": ids(7), "neg_pair": ids(30),
              "pos_segs": [0] * 3 + [1] * 4, "neg_segs": [0] * 30},
             {"pos_pair": ids(2), "neg_pair": ids(5),
              "pos_segs": [0, 1], "neg_segs": [0] * 2 + [1] * 3}]
    got = collators.PairCollator(0, 4, 10)(pairs)
    want = jcollators.PairCollator(0, 4, 10)(pairs)
    assert collators.PairCollator(0, 4, 10).max_len == 16
    for side in want:
        assert set(got[side]) == set(want[side])
        for k in want[side]:
            np.testing.assert_array_equal(got[side][k], want[side][k])


@pytest.mark.parametrize("fn", ["encode_pair", "encode_pair_with_segments"])
def test_pair_encodings_match_jax(tokenizer, fn):
    cases = [("w1 w2 w3", "w4 w5 w6 w7 w8 w9", 8),
             ([9, 10, 11, 12, 13], [14, 15, 16], 7),
             ("w1 w2", [20, 21, 22, 23, 24, 25, 26], 9),
             ([5] * 20, "w3 w4", 12)]
    for tk in (tokenizer, RaisingSegments(tokenizer)):
        for a, b, n in cases:
            got = getattr(tokenization, fn)(tk, a, b, n)
            want = getattr(jtokenization, fn)(tk, a, b, n)
            assert got == want
    # a tokenizer whose segment ids raise gives zeros on the id-list route
    got = tokenization.encode_pair_with_segments(
        RaisingSegments(tokenizer), [9, 10, 11], [14, 15], 9)
    assert got[1] == [0] * len(got[0])


class RaisingSegments:
    """The fixture's tokenizer, but ``create_token_type_ids_from_sequences``
    raises (as some tokenizers' do)."""

    def __init__(self, tokenizer):
        self._tokenizer = tokenizer

    def __getattr__(self, name):
        return getattr(self._tokenizer, name)

    def create_token_type_ids_from_sequences(self, a, b):
        raise NotImplementedError("no segment ids")


def write_train_jsonl(path, n=9, seed=0):
    rng = np.random.RandomState(seed)
    words = lambda k: " ".join(f"w{i}" for i in rng.randint(0, 40, k))  # noqa: E731
    with open(path, "w") as f:
        for i in range(n):
            ex = {"query": words(4) if i % 2 else list(map(int, rng.randint(
                      5, 40, 6))),
                  "positives": [words(8), words(5)][: 1 + i % 2],
                  "negatives": [words(7) for _ in range(2 + i % 4)]}
            f.write(json.dumps(ex) + "\n")


@pytest.mark.parametrize("kind", ["DRTrainDataset", "RRTrainDataset"])
def test_train_datasets_match_jax(tokenizer, tmp_path, kind):
    path = tmp_path / "train.jsonl"
    write_train_jsonl(path)
    kw = dict(train_path=str(path), q_max_len=6, p_max_len=9,
              train_n_passages=4)
    mine = getattr(train_dataset, kind)(tokenizer, DataArguments(**kw),
                                        shuffle_seed=3)
    theirs = getattr(jtrain_dataset, kind)(tokenizer, JaxDataArguments(**kw),
                                           shuffle_seed=3)
    assert len(mine) == len(theirs) == 9
    for epoch in (0, 1):
        for seed in (None, 17):
            assert list(mine.epoch_iterator(epoch, seed)) \
                == list(theirs.epoch_iterator(epoch, seed))
    if kind == "DRTrainDataset":
        col = collators.QPCollator(0, 6, 9)
        got = list(common.epochs_iterator(mine, col, 2, 2, 42))
        want = list(jcommon.epochs_iterator(theirs, jcollators.QPCollator(
            0, 6, 9), 2, 2, 42))
        assert len(got) == len(want) == 8
        for a, b in zip(got, want):
            for side in b:
                for k in b[side]:
                    np.testing.assert_array_equal(a[side][k], b[side][k])


# ---- defaults -------------------------------------------------------------


def test_trainer_and_driver_default_to_the_card(monkeypatch, tmp_path):
    from openmatch_tpu_torch.drivers import train_dr

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pm = DRModel(BertConfig(**SMALL))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DRTrainer(pm, TrainingArguments(), total_steps=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_dr.main(["--model_name_or_path", str(tmp_path),
                       "--train_path", str(tmp_path / "t.jsonl"),
                       "--output_dir", str(tmp_path / "out")],
                      tokenizer=object())
    trainer = DRTrainer(pm, TrainingArguments(), total_steps=1, device="cpu")
    assert next(trainer.model.parameters()).device.type == "cpu"


def test_trainer_refuses_multi_device_settings():
    """One process is a mesh of one rank: more ranks on either axis are
    refused with the JAX make_mesh's messages (tests/test_torch_mesh.py
    trains over 2 and 4 ranks)."""
    pm = DRModel(BertConfig(**SMALL))
    for kw, msg in ((dict(dp_size=2), r"dp\(2\) \* tp\(1\) != devices\(1\)"),
                    (dict(tp_size=2, negatives_x_device=True),
                     r"1 devices not divisible by tp=2")):
        with pytest.raises(ValueError, match=msg):
            DRTrainer(pm, TrainingArguments(**kw), total_steps=1,
                      device="cpu")
