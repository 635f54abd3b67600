"""The port's v1 rerankers against the JAX package's on the same weights and
inputs: ``KernelMatcher`` (values and gradients), KNRM, Conv-KNRM, TK,
EDRM, BertRanker and BertMaxP, the ranking and classification losses,
``V1Trainer``'s first steps, ``predict_scores``, ``train_state.msgpack``
crossing both ways through the ``inference_v1`` drivers, ``gen_feature``'s
lines, the copied tokenizer, datasets and collators, and ``DictOrStr``.

Weights are numpy-seeded Flax trees carried into the port with
``v1_params_from_jax``. Tolerances: fp32 values within 1e-5 x max|JAX|
(gradients, losses, scores, features); after five optimizer steps each
parameter within 1e-4 x its max|JAX|, because Adam divides each gradient
by its own running norm and so magnifies float-rounding differences of
small gradient entries.
"""

import argparse
import functools
import json
import os

import numpy as np
import pytest
import torch

from openmatch_tpu_torch.config import TrainingArguments
from openmatch_tpu_torch.drivers import common as pcommon
from openmatch_tpu_torch.drivers import gen_feature as pgen_feature
from openmatch_tpu_torch.drivers import inference_v1 as pinference_v1
from openmatch_tpu_torch.drivers import train_v1 as ptrain_v1
from openmatch_tpu_torch.models.bert import BertConfig
from openmatch_tpu_torch.models.jax_convert import (v1_params_from_jax,
                                                    v1_params_to_jax)
from openmatch_tpu_torch.parallel.mesh import Mesh
from openmatch_tpu_torch.train import v1_trainer as pv1
from openmatch_tpu_torch.v1 import dataset as pdataset
from openmatch_tpu_torch.v1 import kernel_matcher as pkm
from openmatch_tpu_torch.v1 import long_doc as plong_doc
from openmatch_tpu_torch.v1 import models as pmodels
from openmatch_tpu_torch.v1 import tokenizer as ptokenizer

try:
    import jax
    import jax.numpy as jnp

    from openmatch_tpu.config import TrainingArguments as JaxTrainingArguments
    from openmatch_tpu.drivers import common as jcommon
    from openmatch_tpu.drivers import gen_feature as jgen_feature
    from openmatch_tpu.drivers import inference_v1 as jinference_v1
    from openmatch_tpu.drivers import train_v1 as jtrain_v1
    from openmatch_tpu.models.bert import BertConfig as JaxBertConfig
    from openmatch_tpu.parallel.mesh import make_mesh
    from openmatch_tpu.train import state as jstate
    from openmatch_tpu.train import v1_trainer as jv1
    from openmatch_tpu.v1 import dataset as jdataset
    from openmatch_tpu.v1 import kernel_matcher as jkm
    from openmatch_tpu.v1 import long_doc as jlong_doc
    from openmatch_tpu.v1 import models as jmodels
    from openmatch_tpu.v1 import tokenizer as jtokenizer
except ImportError:  # only the cuda-marked test runs without JAX
    jax = None

torch.set_num_threads(2)

REL = 1e-5
PARAM_REL = 1e-4
V, E, KD = 50, 16, 8  # vocabulary, embed_dim, kernel_dim
B, QL, DL = 8, 6, 24  # batch, query and doc length
ENT_V, N_ENT, DES = 12, 3, 6
BERT = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=128)
MODELS = ("knrm", "cknrm", "tk", "edrm", "bert", "maxp")
WORDS = [f"w{i}" for i in range(V - 1)]


def assert_close(got, want, rel=REL, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    tol = rel * max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= tol, f"{what}: max|diff| {err} > {tol}"


def seeded_tree(tree, seed):
    """Every leaf of a Flax tree (of arrays or shapes) replaced by a seeded
    draw of its shape."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = tuple(leaf.shape)
        x = rng.standard_normal(shape).astype(np.float32)
        if name.endswith("['scale']"):
            x = 1.0 + 0.2 * x
        elif name.endswith("['bias']"):
            x = 0.1 * x
        elif "mixer" in name:
            x = 0.5 + 0.1 * x
        elif "kernel" in name:  # over fan-in; DenseGeneral q/k/v: [D, ...]
            split_in = len(shape) > 2 and "conv" not in name \
                and "['out']" not in name
            x = x / np.sqrt(shape[0] if split_in else np.prod(shape[:-1]))
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


# ---- models -----------------------------------------------------------------


def word_batch(seed, n=B):
    rng = np.random.RandomState(seed)

    def ids(length):
        x = rng.randint(1, V, size=(n, length)).astype(np.int32)
        lengths = rng.randint(1, length + 1, size=n)
        lengths[-1] = length
        mask = (np.arange(length)[None] < lengths[:, None]).astype(
            np.float32)
        return x * mask.astype(np.int32), mask

    out = {}
    out["query_idx"], out["query_mask"] = ids(QL)
    out["doc_idx"], out["doc_mask"] = ids(DL)
    out["doc_idx"][0] = 0  # an all-pad doc
    out["doc_mask"][0] = 0
    return out


def edrm_batch(seed, n=B):
    rng = np.random.RandomState(seed)
    w = word_batch(seed, n)
    out = {"query_wrd_idx": w["query_idx"], "query_wrd_mask": w["query_mask"],
           "doc_wrd_idx": w["doc_idx"], "doc_wrd_mask": w["doc_mask"]}
    for side in ("query", "doc"):
        ent = rng.randint(0, ENT_V, size=(n, N_ENT)).astype(np.int32)
        out[f"{side}_ent_idx"] = ent
        out[f"{side}_ent_mask"] = (ent != 0).astype(np.float32)
        out[f"{side}_des_idx"] = rng.randint(0, V, size=(n, N_ENT * DES)
                                             ).astype(np.int32)
    return out


def bert_batch(seed, n=B, passages=None, s=16):
    rng = np.random.RandomState(seed)
    shape = (n, s) if passages is None else (n, passages, s)
    ids = rng.randint(5, BERT["vocab_size"], size=shape).astype(np.int32)
    lengths = rng.randint(4, s + 1, size=shape[:-1])
    mask = (np.arange(s) < lengths[..., None]).astype(np.int32)
    segs = ((np.arange(s) >= lengths[..., None] // 2) * mask).astype(np.int32)
    return {"input_ids": ids * mask, "input_mask": mask, "segment_ids": segs}


def make_batch(kind, seed, n=B):
    if kind == "edrm":
        return edrm_batch(seed, n)
    if kind == "bert":
        return bert_batch(seed, n)
    if kind == "maxp":
        return bert_batch(seed, n, passages=3)
    return word_batch(seed, n)


def model_pair(kind, task="ranking", seed=0):
    """(JAX module, seeded params, port module) with the same weights."""
    if kind == "knrm":
        jm = jmodels.KNRM(vocab_size=V, embed_dim=E, task=task)
        pm = pmodels.KNRM(V, E, task=task)
    elif kind == "cknrm":
        jm = jmodels.ConvKNRM(vocab_size=V, embed_dim=E, kernel_dim=KD,
                              task=task)
        pm = pmodels.ConvKNRM(V, E, kernel_dim=KD, task=task)
    elif kind == "tk":
        jm = jmodels.TK(vocab_size=V, embed_dim=E, head_num=4, hidden_dim=20,
                        layer_num=2, task=task)
        pm = pmodels.TK(V, E, head_num=4, hidden_dim=20, layer_num=2,
                        task=task)
    elif kind == "edrm":
        kw = dict(wrd_vocab_size=V, ent_vocab_size=ENT_V, wrd_embed_dim=E,
                  ent_embed_dim=KD, max_des_len=DES, max_ent_num=N_ENT,
                  kernel_dim=KD, task=task)
        jm, pm = jmodels.EDRM(**kw), pmodels.EDRM(**kw)
    elif kind == "bert":
        jm = jmodels.BertRanker(config=JaxBertConfig(**BERT), task=task)
        pm = pmodels.BertRanker(BertConfig(**BERT), task=task)
    else:
        jm = jmodels.BertMaxP(config=JaxBertConfig(**BERT), num_passages=3,
                              task=task)
        pm = pmodels.BertMaxP(BertConfig(**BERT), num_passages=3, task=task)
    example = make_batch(kind, 0, 1)
    args = [jnp.asarray(example[k]) for k in pm.INPUTS]
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *args)["params"]
    params = seeded_tree(shapes, seed)
    pm.load_state_dict(v1_params_from_jax(params), strict=True)
    return jm, params, pm.eval()


@functools.lru_cache(maxsize=None)
def jitted_apply(jm):
    return jax.jit(lambda p, *args: jm.apply({"params": p}, *args))


def jax_apply(jm, params, batch):
    order = {jmodels.EDRM: pmodels.EDRM.INPUTS,
             jmodels.BertRanker: pmodels.BERT_INPUTS,
             jmodels.BertMaxP: pmodels.BERT_INPUTS}.get(type(jm),
                                                         pmodels.WORD_INPUTS)
    return jitted_apply(jm)(params, *(jnp.asarray(batch[k]) for k in order))


def to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.mark.parametrize("task", ["ranking", "classification"])
@pytest.mark.parametrize("kind", MODELS)
def test_model_matches_jax(kind, task):
    jm, params, pm = model_pair(kind, task, seed=1)
    batch = make_batch(kind, 2)
    want_score, want_feats = jax_apply(jm, params, batch)
    with torch.no_grad():
        score, feats = pm.score_batch(to_torch(batch))
    assert score.shape == ((B,) if task == "ranking" else (B, 2))
    assert_close(score.numpy(), want_score, what=f"{kind} score")
    assert_close(feats.numpy(), want_feats, what=f"{kind} feats")


@pytest.mark.parametrize("kind", MODELS)
def test_v1_tree_round_trip(kind):
    _, params, pm = model_pair(kind, seed=3)
    back = v1_params_to_jax(pm.state_dict(), pm.num_heads)
    got = jax.tree_util.tree_leaves_with_path(back)
    want = jax.tree_util.tree_leaves_with_path(params)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(path))


def test_embedder_zeroes_row_zero_in_forward():
    _, params, pm = model_pair("knrm", seed=4)
    assert np.abs(params["embedder"]["embedding"][0]).max() > 0
    ids = torch.tensor([[0, 3, 0]])
    out = pm.embedder(ids)
    assert torch.equal(out[0, 0], torch.zeros(E))
    out.sum().backward()
    assert torch.equal(pm.embedder.embedding.grad[0], torch.zeros(E))


# ---- the kernel matcher ------------------------------------------------------


def matcher_inputs(seed):
    rng = np.random.RandomState(seed)
    k = rng.randn(3, 5, E).astype(np.float32)
    v = rng.randn(3, 9, E).astype(np.float32)
    k_mask = (rng.rand(3, 5) > 0.3).astype(np.float32)
    v_mask = (rng.rand(3, 9) > 0.3).astype(np.float32)
    k[0, 1] = 0.0  # zero rows under a live mask and under a dead one
    v[1, 2] = 0.0
    k_mask[2] = 0.0
    w = rng.randn(3, 21).astype(np.float32)
    return k, k_mask, v, v_mask, w


def test_kernel_matcher_values_and_gradients():
    np.testing.assert_array_equal(pkm.kernel_mus_sigmas(11)[0],
                                  jkm.kernel_mus_sigmas(11)[0])
    np.testing.assert_array_equal(pkm.kernel_mus_sigmas(11)[1],
                                  jkm.kernel_mus_sigmas(11)[1])
    k, km, v, vm, w = matcher_inputs(5)
    jmatch = jkm.KernelMatcher(21)

    def jloss(k, v):
        return (jmatch(k, jnp.asarray(km), v, jnp.asarray(vm)) * w).sum()

    want = jax.jit(jmatch)(jnp.asarray(k), jnp.asarray(km), jnp.asarray(v),
                           jnp.asarray(vm))
    want_gk, want_gv = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jnp.asarray(k), jnp.asarray(v))
    pmatch = pkm.KernelMatcher(21)
    tk = torch.from_numpy(k).requires_grad_()
    tv = torch.from_numpy(v).requires_grad_()
    got = pmatch(tk, torch.from_numpy(km), tv, torch.from_numpy(vm))
    assert_close(got.detach().numpy(), want, what="matcher")
    gk, gv = torch.autograd.grad((got * torch.from_numpy(w)).sum(),
                                 (tk, tv), create_graph=True)
    assert_close(gk.detach().numpy(), want_gk, what="d/dk")
    assert_close(gv.detach().numpy(), want_gv, what="d/dv")
    # zero rows: a zero gradient, not NaN, at first and second order
    assert torch.equal(gk[0, 1].detach(), torch.zeros(E))
    assert torch.equal(gv[1, 2].detach(), torch.zeros(E))
    gk2, gv2 = torch.autograd.grad((gk ** 2).sum() + (gv ** 2).sum(),
                                   (tk, tv))
    assert torch.isfinite(gk2).all() and torch.isfinite(gv2).all()


def test_ieee_context_keeps_either_flag_api():
    """The matcher's TF32 switch turns TF32 off inside and leaves the flags
    as it found them, whichever API set them: the legacy ``allow_tf32``,
    ``fp32_precision``, or both in the order where the legacy getter
    raises."""
    matmul = torch.backends.cuda.matmul

    def state():
        try:
            legacy = matmul.allow_tf32
        except RuntimeError:
            legacy = "raises"
        return matmul.fp32_precision, legacy

    setups = [lambda: setattr(matmul, "allow_tf32", True),
              lambda: setattr(matmul, "fp32_precision", "tf32"),
              lambda: (setattr(matmul, "allow_tf32", True),
                       setattr(matmul, "fp32_precision", "ieee"))]
    try:
        for setup in setups:
            setup()
            before = state()
            with pkm._ieee_fp32():
                assert matmul.fp32_precision == "ieee"
            assert state() == before
        assert "raises" in before  # the last setup exercised that branch
    finally:
        matmul.allow_tf32 = False


@pytest.mark.cuda
def test_match_matrix_is_fp32_under_tf32():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: TF32 exists only there")
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(4, 64, 300, generator=gen)
    b = torch.randn(4, 300, 256, generator=gen)
    want = torch.bmm(a.double(), b.double())
    scale = want.abs().max()
    matmul = torch.backends.cuda.matmul
    try:
        for allow in ("legacy", "fp32_precision"):
            if allow == "legacy":
                matmul.allow_tf32 = True
            else:
                matmul.fp32_precision = "tf32"
            got = pkm.ieee_bmm(a.to(dev), b.to(dev)).cpu().double()
            tf32 = torch.bmm(a.to(dev), b.to(dev)).cpu().double()
            assert (got - want).abs().max() <= 1e-6 * scale, allow
            # the check can see TF32: the product under the flag is coarser
            assert (tf32 - want).abs().max() > 1e-5 * scale, allow
    finally:
        matmul.allow_tf32 = False


# ---- losses -----------------------------------------------------------------


@pytest.mark.parametrize("kind", ["margin_loss", "CE_loss", "triplet_loss"])
def test_ranking_loss_matches_jax(kind):
    rng = np.random.RandomState(6)
    pos, neg = rng.randn(2, 16).astype(np.float32) * 3
    want = jv1.ranking_loss(jnp.asarray(pos), jnp.asarray(neg), kind, 1.0)
    got = pv1.ranking_loss(torch.from_numpy(pos), torch.from_numpy(neg), kind,
                           1.0)
    assert_close(got.numpy(), want, what=kind)
    with pytest.raises(ValueError, match="Unknown ranking loss"):
        pv1.ranking_loss(torch.from_numpy(pos), torch.from_numpy(neg), "x")


def test_classification_loss_matches_optax():
    import optax

    rng = np.random.RandomState(7)
    logits = rng.randn(16, 2).astype(np.float32) * 3
    labels = rng.randint(0, 2, 16).astype(np.int32)
    want = optax.softmax_cross_entropy_with_integer_labels(
        jnp.asarray(logits), jnp.asarray(labels)).mean()
    got = pv1.classification_loss(torch.from_numpy(logits),
                                  torch.from_numpy(labels))
    assert_close(got.numpy(), want, what="CE")


# ---- the trainer ------------------------------------------------------------


def train_batch(kind, seed, task):
    if task == "classification":
        b = make_batch(kind, seed)
        b["label"] = np.random.RandomState(seed).randint(0, 2, B).astype(
            np.int32)
        return b
    pos, neg = make_batch(kind, seed), make_batch(kind, seed + 100)
    out = {}
    for k in pos:
        if k.startswith("doc_"):
            out[k.replace("doc_", "doc_pos_", 1)] = pos[k]
            out[k.replace("doc_", "doc_neg_", 1)] = neg[k]
        elif k.startswith("query_"):
            out[k] = pos[k]
        else:  # cross-encoder inputs
            out[f"pos_{k}"] = pos[k]
            out[f"neg_{k}"] = neg[k]
    return out


# margin_loss for ranking: under CE_loss and triplet_loss the head's bias
# has an exactly cancelling gradient, whose rounding noise Adam would scale
# up to full steps (the losses themselves are compared above)
TRAIN_CASES = [("knrm", "ranking", "margin_loss"),
               ("cknrm", "ranking", "margin_loss"),
               ("tk", "ranking", "margin_loss"),
               ("edrm", "ranking", "margin_loss"),
               ("bert", "classification", None),
               ("maxp", "ranking", "margin_loss")]


@pytest.mark.parametrize("kind,task,loss", TRAIN_CASES)
def test_trainer_steps_match_jax(tmp_path, kind, task, loss):
    jm, params, pm = model_pair(kind, task, seed=8)
    common = dict(output_dir=str(tmp_path), learning_rate=1e-2,
                  warmup_ratio=0.1, logging_steps=100, save_steps=0)

    def jscore(p, batch):
        return jax_apply(jm, p, batch)[0]

    jt = jv1.V1Trainer(jscore, params, JaxTrainingArguments(**common), 10,
                       task=task, ranking_loss_kind=loss or "margin_loss",
                       mesh=make_mesh(1, 1, devices=jax.devices()[:1]))
    pt = pv1.V1Trainer(pm, TrainingArguments(**common), 10, task=task,
                       ranking_loss_kind=loss or "margin_loss", device="cpu")
    for step in range(5):
        batch = train_batch(kind, 10 + step, task)
        want = float(jt.train_step({k: v.copy() for k, v in batch.items()}))
        got = float(pt.train_step(batch))
        assert_close(got, want, what=f"loss {step}")
    assert pt.step == int(jt.state.step) == 5
    got = v1_params_to_jax(pm.state_dict(), pm.num_heads)
    for (path, g), (_, w) in zip(
            jax.tree_util.tree_leaves_with_path(got),
            jax.tree_util.tree_leaves_with_path(
                jax.device_get(jt.state.params))):
        name = jax.tree_util.keystr(path)
        live = live_entries(name, np.asarray(w))
        if live.any():
            assert_close(g[live], w[live], PARAM_REL, name)


def live_entries(name: str, leaf: np.ndarray) -> np.ndarray:
    """The entries of a parameter whose gradient is not zero by
    construction. An attention key bias adds one constant to every logit of
    a softmax row, so its gradient is zero up to rounding, and Adam scales
    that rounding noise up to full steps in either package: TK's ``k``
    biases and the key third of BERT's fused ``qkv`` bias are left out."""
    live = np.ones(leaf.shape, bool)
    if name.endswith("['k']['bias']"):
        live[...] = False
    elif name.endswith("['qkv']['bias']"):
        live[1] = False
    return live


def test_trainer_refuses_more_than_one_process():
    """A ``dp_size`` the job's ranks do not have raises JAX ``make_mesh``'s
    message (one process here); ``tp_size > 1`` is refused, the parameters
    being replicated. Training over ranks: ``test_torch_v1_mesh.py``."""
    pm = pmodels.KNRM(V, E)
    with pytest.raises(ValueError, match=r"dp\(2\) \* tp\(1\) != devices\(1\)"):
        pv1.V1Trainer(pm, TrainingArguments(output_dir="x", dp_size=2), 5,
                      device="cpu")
    with pytest.raises(ValueError, match="tp_size > 1"):
        pv1.V1Trainer(pm, TrainingArguments(output_dir="x"), 5,
                      device="cpu", mesh=Mesh(dp=1, tp=2))


@pytest.mark.parametrize("task", ["ranking", "classification"])
def test_predict_scores_matches_jax(task):
    jm, params, pm = model_pair("knrm", task, seed=9)

    def batches():
        for seed in (20, 21):
            b = word_batch(seed)
            b["query_id"] = [f"q{i % 3}" for i in range(B)]
            b["doc_id"] = [f"d{i % 5}" for i in range(B)]  # repeats: max
            b["retrieval_score"] = np.ones(B, np.float32)
            yield b

    want = jv1.predict_scores(lambda p, b: jax_apply(jm, p, b)[0], params,
                              batches(), task)
    got = pv1.predict_scores(pm, batches(), task)
    assert got.keys() == want.keys()
    for q in want:
        assert got[q].keys() == want[q].keys()
        assert_close([got[q][d] for d in want[q]],
                     [want[q][d] for d in want[q]], what=q)


# ---- drivers and checkpoints --------------------------------------------------


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A word vocab, an entity vocab, a tiny HF BERT with its tokenizer, and
    train (ranking jsonl), dev (jsonl with ids) and qrels files."""
    from transformers import BertConfig as HFBertConfig, BertModel
    from transformers import BertTokenizerFast

    d = tmp_path_factory.mktemp("v1files")
    (d / "vocab.txt").write_text("\n".join(WORDS) + "\n")
    (d / "ents.txt").write_text("\n".join(f"e{i}" for i in range(ENT_V - 1))
                                + "\n")
    torch.manual_seed(0)
    BertModel(HFBertConfig(**BERT)).save_pretrained(d / "hf")
    (d / "bert_vocab.txt").write_text("\n".join(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS[:59]))
    BertTokenizerFast(vocab_file=str(d / "bert_vocab.txt")).save_pretrained(
        d / "hf")
    rng = np.random.RandomState(11)

    def text(n):
        return " ".join(WORDS[j] for j in rng.randint(0, 40, n))

    def ents(n):
        return [f"e{j}" for j in rng.randint(0, ENT_V, n)]

    with open(d / "train.jsonl", "w") as f:
        for _ in range(16):
            row = {"query": text(4), "doc_pos": text(20), "doc_neg": text(20),
                   "query_ent": ents(2), "query_des": [text(5), text(3)]}
            for side in ("doc_pos", "doc_neg"):
                row[f"{side}_ent"] = ents(3)
                row[f"{side}_des"] = [text(4), text(6), text(2)]
            f.write(json.dumps(row) + "\n")
    with open(d / "dev.jsonl", "w") as f, open(d / "qrels", "w") as qf:
        for q in range(4):
            query = text(4)
            for j in range(5):
                f.write(json.dumps({
                    "query_id": f"q{q}", "doc_id": f"d{q}_{j}",
                    "label": int(j == 0), "retrieval_score": 10.0 - j,
                    "query": query, "doc": text(18), "query_ent": ents(2),
                    "doc_ent": ents(3), "doc_des": [text(4)]}) + "\n")
                qf.write(f"q{q} 0 d{q}_{j} {int(j == 0)}\n")
    return d


def model_flags(kind, d):
    flags = ["-max_query_len", "4", "-max_doc_len", "12"]
    if kind in ("bert", "maxp"):
        flags += ["-model", "bert", "-pretrain", str(d / "hf")]
        return flags + (["-maxp"] if kind == "maxp" else [])
    flags += ["-model", kind, "-vocab", str(d / "vocab.txt"), "-embed_dim",
              str(E), "-kernel_dim", str(KD), "-max_des_len", str(DES)]
    if kind == "edrm":
        flags += ["-ent_vocab", str(d / "ents.txt")]
    return flags


def read_run(path):
    run = {}
    for line in open(path):
        q, _, did, _, score, _ = line.split()
        run.setdefault(q, {})[did] = float(score)
    return run


def assert_runs_close(got_path, want_path):
    got, want = read_run(got_path), read_run(want_path)
    assert got.keys() == want.keys()
    for q in want:
        assert got[q].keys() == want[q].keys()
        assert_close([got[q][d] for d in want[q]],
                     [want[q][d] for d in want[q]], what=q)


def train_flags(d, save):
    return ["-train", str(d / "train.jsonl"), "-save", save, "-epoch", "1",
            "-batch_size", "8", "-lr", "0.01", "-eval_every", "1",
            "-ranking_loss", "triplet_loss"]


@pytest.mark.parametrize("kind", MODELS)
def test_train_state_crosses_both_ways(tmp_path, kind):
    """Each model's train_state.msgpack: the JAX package's, written by its
    save_train_state, loads into the port and scores as JAX's params do;
    the port's, written by V1Trainer.save_checkpoint, restores through the
    JAX package's load_train_state to the port's weights."""
    jm, params, pm = model_pair(kind, seed=12)
    tx = jstate.make_optimizer(JaxTrainingArguments(), 1)
    jax_state = jstate.TrainState.create(jax.tree.map(jnp.asarray, params),
                                         tx)
    jstate.save_train_state(jax_state, str(tmp_path / "jax"))
    loaded = pv1.load_v1_params(model_pair(kind, seed=13)[2],
                                str(tmp_path / "jax"))
    batch = make_batch(kind, 14)
    with torch.no_grad():
        got = loaded.score_batch(to_torch(batch))[0]
        assert torch.equal(got, pm.score_batch(to_torch(batch))[0])

    trainer = pv1.V1Trainer(pm, TrainingArguments(output_dir=str(tmp_path)),
                            4, device="cpu")
    trainer.save_checkpoint(str(tmp_path / "port"))
    state = jstate.load_train_state(str(tmp_path / "port"), jax_state)
    assert int(state.step) == 0
    for (path, g), (_, w) in zip(
            jax.tree_util.tree_leaves_with_path(jax.device_get(state.params)),
            jax.tree_util.tree_leaves_with_path(params)):
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("kind", ["knrm"])
def test_jax_checkpoint_through_port_inference(files, tmp_path, kind):
    save = str(tmp_path / "jax_ckpt")
    jtrain_v1.main(model_flags(kind, files) + train_flags(files, save))
    infer = ["-test", str(files / "dev.jsonl"), "-mode", "dev",
             "-checkpoint", save, "-batch_size", "8"]
    jinference_v1.main(model_flags(kind, files) + infer
                       + ["-res", str(tmp_path / "jax.trec")])
    pinference_v1.main(model_flags(kind, files) + infer
                       + ["-res", str(tmp_path / "port.trec"),
                          "--device", "cpu"])
    assert_runs_close(tmp_path / "port.trec", tmp_path / "jax.trec")


@pytest.mark.parametrize("kind", ["bert"])
def test_port_checkpoint_through_jax_inference(files, tmp_path, kind):
    save = str(tmp_path / "port_ckpt")
    seen = []
    real = pv1.V1Trainer.save_checkpoint

    def keep(self, out=None):
        seen.append(self)
        return real(self, out)

    pv1.V1Trainer.save_checkpoint = keep
    try:
        out = ptrain_v1.main(model_flags(kind, files) + train_flags(
            files, save) + ["--device", "cpu"])
    finally:
        pv1.V1Trainer.save_checkpoint = real
    assert out["final_step"] == 2 and len(out["losses"]) == 2
    assert np.isfinite(out["losses"]).all()
    assert json.load(open(os.path.join(save, "train_state.json"))) == {
        "step": 2}
    infer = ["-test", str(files / "dev.jsonl"), "-mode", "dev",
             "-checkpoint", save, "-batch_size", "8"]
    jinference_v1.main(model_flags(kind, files) + infer
                       + ["-res", str(tmp_path / "jax.trec")])
    pinference_v1.main(model_flags(kind, files) + infer
                       + ["-res", str(tmp_path / "port.trec"),
                          "--device", "cpu"])
    assert_runs_close(tmp_path / "port.trec", tmp_path / "jax.trec")

    # the JAX package's load_train_state takes the port's opt_state, and the
    # moments and counts are the port optimizer's
    trainer = seen[-1]
    tree = v1_params_to_jax(trainer.model.state_dict(), trainer.model.num_heads)
    template = jstate.TrainState.create(
        jax.tree.map(jnp.asarray, tree),
        jstate.make_optimizer(JaxTrainingArguments(), 1))
    state = jstate.load_train_state(save, template)
    assert int(state.step) == 2
    adam = state.opt_state[1][0]
    assert int(adam.count) == 2 and int(state.opt_state[1][2].count) == 2
    opt = trainer.optimizer
    mu = {n: opt.state[p]["mu"] for n, p in trainer.model.named_parameters()}
    for (path, g), (_, w) in zip(
            jax.tree_util.tree_leaves_with_path(jax.device_get(adam.mu)),
            jax.tree_util.tree_leaves_with_path(
                v1_params_to_jax(mu, trainer.model.num_heads))):
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(path))


def parse_feature_line(line):
    body, did = line.split(" # ")
    label, qid, *vals = body.split()
    return label, qid, did, [float(v.split(":")[1]) for v in vals], \
        [v.split(":")[0] for v in vals]


@pytest.mark.parametrize("kind", ["knrm", "bert"])
def test_gen_feature_matches_jax(files, tmp_path, kind):
    save = str(tmp_path / "ckpt")
    jtrain_v1.main(model_flags(kind, files) + train_flags(files, save))
    flags = model_flags(kind, files) + ["-dev", str(files / "dev.jsonl"),
                                        "-checkpoint", save]
    jgen_feature.main(flags + ["-out", str(tmp_path / "jax.txt")])
    n = pgen_feature.main(flags + ["-out", str(tmp_path / "port.txt"),
                                   "--device", "cpu"])
    want = (tmp_path / "jax.txt").read_text().splitlines()
    got = (tmp_path / "port.txt").read_text().splitlines()
    assert n == len(got) == len(want) == 20
    for g, w in zip(got, want):
        gl, gq, gd, gv, gk = parse_feature_line(g)
        wl, wq, wd, wv, wk = parse_feature_line(w)
        assert (gl, gq, gd, gk) == (wl, wq, wd, wk)
        assert_close(gv, wv, what=w[:20])


def test_reinfoselect_refused(files, tmp_path):
    """-reinfoselect is no longer refused: it trains (keep rates in [0, 1],
    a best checkpoint that loads) and refuses only a run without -dev and
    -qrels, whose metric is its reward."""
    flags = model_flags("knrm", files) + train_flags(
        files, str(tmp_path / "x")) + ["-reinfoselect", "--device", "cpu"]
    with pytest.raises(ValueError, match="-dev and -qrels"):
        ptrain_v1.main(flags)
    out = ptrain_v1.main(flags + ["-dev", str(files / "dev.jsonl"),
                                  "-qrels", str(files / "qrels"), "-res",
                                  str(tmp_path / "res.trec")])
    assert out["final_step"] == 2 and len(out["keep_rates"]) == 2
    assert all(0.0 <= r <= 1.0 for r in out["keep_rates"])
    args = argparse.ArgumentParser()
    ptrain_v1.add_model_args(args)
    parsed = args.parse_args(model_flags("knrm", files))
    pv1.load_v1_params(ptrain_v1.build_v1_model(
        parsed, ptrain_v1.build_v1_tokenizer(parsed)),
        str(tmp_path / "x" / "best"))


# ---- the copied data modules ---------------------------------------------------


def test_word_tokenizer_matches_jax(files, tmp_path):
    glove = tmp_path / "glove.txt"
    rng = np.random.RandomState(12)
    glove.write_text("\n".join(
        w + " " + " ".join(f"{x:.5f}" for x in rng.randn(8))
        for w in WORDS[:10]) + "\n")
    text = "W1 w2, the w3; running w44 unknown w2. " * 3
    for kw in (dict(vocab=str(files / "vocab.txt")),
               dict(vocab=str(files / "vocab.txt"), if_swr=False,
                    if_stem=False),
               dict(pretrained=str(glove))):
        jt, pt = jtokenizer.WordTokenizer(**kw), ptokenizer.WordTokenizer(**kw)
        for max_len in (3, 30):
            assert pt.process(text, max_len) == jt.process(text, max_len)
        assert pt.get_vocab_size() == jt.get_vocab_size()
        assert pt.get_embed_dim() == jt.get_embed_dim()
        assert pt.get_embed_matrix() == jt.get_embed_matrix()


def assert_batches_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], list):
            assert got[k] == want[k], k
        else:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_collators_match_jax(files):
    from transformers import AutoTokenizer

    hf = AutoTokenizer.from_pretrained(str(files / "hf"))
    wkw = dict(vocab=str(files / "vocab.txt"))
    jw, pw = jtokenizer.WordTokenizer(**wkw), ptokenizer.WordTokenizer(**wkw)
    ekw = dict(vocab=str(files / "ents.txt"), if_swr=False, if_stem=False)
    je, pe = jtokenizer.WordTokenizer(**ekw), ptokenizer.WordTokenizer(**ekw)
    for mode, path in (("train", "train.jsonl"), ("dev", "dev.jsonl")):
        jset = jdataset.V1Dataset(str(files / path), mode=mode)
        pset = pdataset.V1Dataset(str(files / path), mode=mode)
        assert list(pset) == list(jset)
        rows = list(pset)[:8]
        pairs = [
            (jdataset.WordCollator(jw, 4, 12, mode=mode),
             pdataset.WordCollator(pw, 4, 12, mode=mode)),
            (jdataset.BertPairCollator(hf, 4, 12, mode=mode),
             pdataset.BertPairCollator(hf, 4, 12, mode=mode)),
            (jlong_doc.BertMaxPCollator(hf, 4, 5, num_passages=3, mode=mode),
             plong_doc.BertMaxPCollator(hf, 4, 5, num_passages=3, mode=mode)),
            (jlong_doc.EDRMCollator(jw, je, 4, 12, N_ENT, DES, mode=mode),
             plong_doc.EDRMCollator(pw, pe, 4, 12, N_ENT, DES, mode=mode)),
        ]
        for jc, pc in pairs:
            assert_batches_equal(pc(rows), jc(rows))
    assert plong_doc.split_doc_tokens(list(range(11)), 4, 3) \
        == jlong_doc.split_doc_tokens(list(range(11)), 4, 3)


def test_id_spec_and_tsv_datasets_match_jax(tmp_path):
    (tmp_path / "q.tsv").write_text("q1\tw1 w2\nq2\tw3\n")
    (tmp_path / "d.tsv").write_text("d1\tw1 doc\nd2\tw2 doc\nd3\tw3\n")
    (tmp_path / "qrels").write_text("q1 0 d1 2\nq2 0 d3 1\n")
    (tmp_path / "run.trec").write_text(
        "q1 Q0 d1 1 9.0 x\nq1 Q0 d2 2 5.0 x\nq2 Q0 d3 1 3.5 x\n")
    (tmp_path / "triples").write_text("q1 d1 d2\nq2 d3 d1\n")
    (tmp_path / "train.tsv").write_text("a q\tpos d\tneg d\n")
    (tmp_path / "cls.tsv").write_text("a q\td\t1\n")
    spec = {"queries": str(tmp_path / "q.tsv"),
            "docs": str(tmp_path / "d.tsv"), "qrels": str(tmp_path / "qrels"),
            "trec": str(tmp_path / "run.trec")}
    cases = [(spec, "dev", "ranking"), (spec, "test", "ranking"),
             (dict(spec, trec=str(tmp_path / "triples")), "train", "ranking"),
             (str(tmp_path / "train.tsv"), "train", "ranking"),
             (str(tmp_path / "cls.tsv"), "train", "classification")]
    for data, mode, task in cases:
        assert list(pdataset.V1Dataset(data, mode=mode, task=task)) \
            == list(jdataset.V1Dataset(data, mode=mode, task=task))


@pytest.mark.parametrize("value", [
    "queries=q.tsv,docs=d.tsv,trec=run.trec",
    "queries=q.tsv,docs=d.tsv,trec=run.trec,qrels=x=y",
    "/data/run=3/x.jsonl", "run=3/x.jsonl", "plain.jsonl",
    "queries=q.tsv,other=1"])
def test_dict_or_str_matches_jax(value):
    def parse(action):
        parser = argparse.ArgumentParser()
        parser.add_argument("-dev", action=action)
        return parser.parse_args(["-dev", value]).dev

    assert parse(pcommon.DictOrStr) == parse(jcommon.DictOrStr)


def test_device_flag_leaves_single_dash_flags():
    device, rest = pcommon.split_device_flag(
        ["-dev", "d.jsonl", "-model", "knrm", "--device", "cpu"])
    assert device == torch.device("cpu")
    assert rest == ["-dev", "d.jsonl", "-model", "knrm"]


def test_cross_equals_the_pairwise_matcher():
    """Conv-KNRM's and EDRM's batched all-pairs matching against one
    ``forward`` per pair, values and gradients."""
    rng = np.random.RandomState(15)
    lengths_k, lengths_v = (6, 5, 4, 3), (24, 23, 22, 3)
    ks = [torch.from_numpy(rng.randn(B, n, KD).astype(np.float32))
          .requires_grad_() for n in lengths_k]
    vs = [torch.from_numpy(rng.randn(B, n, KD).astype(np.float32))
          .requires_grad_() for n in lengths_v]
    km = [torch.from_numpy((rng.rand(B, 6) > 0.3).astype(np.float32))
          for _ in ks]
    vm = [torch.from_numpy((rng.rand(B, 24) > 0.3).astype(np.float32))
          for _ in vs]
    matcher = pkm.KernelMatcher(21)
    want = torch.cat([matcher(k, m[:, : k.shape[1]], v, n[:, : v.shape[1]])
                      for k, m in zip(ks, km) for v, n in zip(vs, vm)], 1)
    got = matcher.cross(ks, km, vs, vm)
    assert_close(got.detach().numpy(), want.detach().numpy(), 1e-6, "cross")
    w = torch.from_numpy(rng.randn(*want.shape).astype(np.float32))
    grads_want = torch.autograd.grad((want * w).sum(), ks + vs)
    grads_got = torch.autograd.grad((got * w).sum(), ks + vs)
    for g, wg in zip(grads_got, grads_want):
        assert_close(g.numpy(), wg.numpy(), 1e-5, "cross gradient")
