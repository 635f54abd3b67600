"""The port's rerank stage against the JAX package's on the same weights:
``RRModel`` (BERT head, monoT5, T5 encoder), its checkpoints, ``Reranker``,
``RRTrainer``, the ``rerank`` and ``train_rr`` drivers, and ``/rerank``.

Weights are numpy-seeded Flax trees carried into the port with
``jax_convert`` (JAX draws a new head from ``PRNGKey(0)``, which torch
cannot reproduce, so no freshly built head is compared). Tolerances: fp32
scores, losses and log-probabilities within 1e-5 x max|JAX|; one train
step's loss within 1e-5 relative and each parameter within 1e-4 x its max.
"""

import json
import sys
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmatch_tpu.config import DataArguments as JaxDataArguments
from openmatch_tpu.config import InferenceArguments as JaxInferenceArguments
from openmatch_tpu.config import ModelArguments as JaxModelArguments
from openmatch_tpu.config import TrainingArguments as JaxTrainingArguments
from openmatch_tpu.models import t5 as jt5
from openmatch_tpu.models.bert import BertConfig as JaxBertConfig
from openmatch_tpu.models.dr_model import DRModel as JaxDRModel
from openmatch_tpu.models.rr_model import RRModel as JaxRRModel
from openmatch_tpu.parallel.mesh import make_mesh
from openmatch_tpu.retriever.reranker import Reranker as JaxReranker
from openmatch_tpu.train.rr_trainer import RRTrainer as JaxRRTrainer
from openmatch_tpu_torch.config import (DataArguments, InferenceArguments,
                                        ModelArguments, TrainingArguments)
from openmatch_tpu_torch.drivers import serve
from openmatch_tpu_torch.models import t5
from openmatch_tpu_torch.models.bert import BertConfig
from openmatch_tpu_torch.models.jax_convert import (params_from_jax,
                                                    params_to_jax)
from openmatch_tpu_torch.models.rr_model import RRModel
from openmatch_tpu_torch.retriever.reranker import Reranker, encode_pair
from openmatch_tpu_torch.train.rr_trainer import RRTrainer

torch.set_num_threads(2)

WORDS = [f"w{i}" for i in range(40)]
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "true", "false",
         "about", "document", "query"] + WORDS
BERT = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=512)
T5 = dict(vocab_size=120, d_model=32, d_kv=8, d_ff=64, num_layers=2,
          num_decoder_layers=2, num_heads=4, relative_attention_num_buckets=8,
          relative_attention_max_distance=20)
BACKBONES = ("bert", "t5", "t5enc")
REL = 1e-5


@pytest.fixture(scope="module")
def tok(tmp_path_factory):
    from transformers import BertTokenizerFast

    d = tmp_path_factory.mktemp("rr_tok")
    (d / "vocab.txt").write_text("\n".join(VOCAB))
    tokenizer = BertTokenizerFast(vocab_file=str(d / "vocab.txt"))
    tokenizer.save_pretrained(str(d))
    tokenizer.path = str(d)
    return tokenizer


def seeded_tree(tree, seed):
    """Every leaf of a Flax tree replaced by a seeded draw of its shape."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = np.shape(leaf)
        x = rng.standard_normal(shape).astype(np.float32)
        if name.endswith("['weight']") or name.endswith("['scale']"):
            x = 1.0 + 0.2 * x
        elif name.endswith("['bias']"):
            x = 0.1 * x
        elif "kernel" in name:
            x = x / np.sqrt(shape[0])
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


def configs(backbone, **bert_kw):
    if backbone == "bert":
        cfg = dict(BERT, **bert_kw)
        return JaxBertConfig(**cfg), BertConfig(**cfg)
    return jt5.T5Config(**T5), t5.T5Config(**T5)


def rr_pair(backbone, seed=0, **bert_kw):
    """(JAX model, params, port model) with the same seeded weights."""
    jcfg, pcfg = configs(backbone, **bert_kw)
    tokens = dict(pos_token_id=5, neg_token_id=6)
    jm = JaxRRModel(encoder_config=jcfg, backbone_type=backbone,
                    head_in_dim=32, **tokens)
    params = seeded_tree(jax.tree.map(
        np.asarray, jm.init_params(jax.random.PRNGKey(0))), seed)
    pm = RRModel(pcfg, backbone_type=backbone, head_in_dim=32, **tokens)
    pm.load_state_dict(params_from_jax(params), strict=True)
    return jm, params, pm.eval()


def pair_batch(seed, n=4, s=14):
    rng = np.random.RandomState(seed)
    ids = rng.randint(5, 64, size=(n, s)).astype(np.int32)
    lengths = rng.randint(4, s + 1, size=n)
    mask = (np.arange(s)[None] < lengths[:, None]).astype(np.int32)
    segs = ((np.arange(s)[None] >= lengths[:, None] // 2) * mask).astype(
        np.int32)
    return {"input_ids": ids * mask, "attention_mask": mask,
            "token_type_ids": segs}


def to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def assert_close(got, want, rel=REL, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    tol = rel * max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= tol, f"{what}: max|diff| {err} > {tol}"


# ---- RRModel ---------------------------------------------------------------


@pytest.mark.parametrize("backbone", BACKBONES)
def test_score_and_logprob_match_jax(backbone):
    jm, params, pm = rr_pair(backbone)
    b = pair_batch(1)
    want = np.asarray(jm.score(params, **to_jax(b)))
    with torch.no_grad():
        got = pm.score(**to_torch(b))
    assert got.shape == ((4, 2) if backbone == "t5" else (4, 1))
    assert_close(got.numpy(), want, what="score")
    assert_close(pm.relevance_logprob(got).numpy(),
                 np.asarray(jm.relevance_logprob(jnp.asarray(want))),
                 what="relevance_logprob")


@pytest.mark.parametrize("loss_fn", ["mr", "smr", "bce", "ce"])
@pytest.mark.parametrize("backbone", BACKBONES)
def test_loss_matches_jax(backbone, loss_fn):
    jm, params, pm = rr_pair(backbone, seed=3)
    jm.loss_fn_str = loss_fn if backbone != "t5" else jm.loss_fn_str
    if backbone != "t5":
        pm.loss_fn_str = loss_fn
    pos, neg = pair_batch(4), pair_batch(5)
    if backbone != "t5" and loss_fn == "ce":  # one column: refused by both
        with pytest.raises(ValueError, match="2-column"):
            jm.loss(params, to_jax(pos), to_jax(neg))
        with pytest.raises(ValueError, match="2-column"):
            pm.loss(to_torch(pos), to_torch(neg))
        return
    assert pm.loss_fn_str == jm.loss_fn_str
    want, (wp, wn) = jm.loss(params, to_jax(pos), to_jax(neg))
    with torch.no_grad():
        got, (gp, gn) = pm.loss(to_torch(pos), to_torch(neg))
    assert_close(got.numpy(), want, what="loss")
    assert_close(gp.numpy(), wp, what="pos scores")
    assert_close(gn.numpy(), wn, what="neg scores")


def test_monot5_forces_ce():
    pm = RRModel(t5.T5Config(**T5), backbone_type="t5", loss_fn_str="bce",
                 pos_token_id=5, neg_token_id=6)
    assert pm.loss_fn_str == "ce" and pm.head is None


@pytest.mark.parametrize("backbone", BACKBONES)
def test_checkpoints_cross_both_ways(tmp_path, monkeypatch, backbone):
    jm, params, pm = rr_pair(backbone, seed=7)
    monkeypatch.setitem(sys.modules, "msgpack", None)
    pm.save(str(tmp_path / "port"))
    reloaded = RRModel.load(str(tmp_path / "port"), device="cpu")
    monkeypatch.delitem(sys.modules, "msgpack")
    jm.save(params, str(tmp_path / "jax"))
    assert (tmp_path / "port" / "params.msgpack").read_bytes() \
        == (tmp_path / "jax" / "params.msgpack").read_bytes()
    assert json.loads((tmp_path / "port" / "openmatch_config.json")
                      .read_text()) == json.loads(
        (tmp_path / "jax" / "openmatch_config.json").read_text())
    jl, jparams = JaxRRModel.load(str(tmp_path / "port"))
    from_jax = RRModel.load(str(tmp_path / "jax"), device="cpu")
    b = pair_batch(8)
    want = np.asarray(jl.score(jparams, **to_jax(b)))
    with torch.no_grad():
        assert_close(reloaded.score(**to_torch(b)).numpy(), want,
                     what="port save -> JAX load")
        assert torch.equal(from_jax.score(**to_torch(b)),
                           pm.score(**to_torch(b)))
    assert (from_jax.pos_token_id, from_jax.neg_token_id) == (5, 6)


def test_rr_tree_round_trip():
    _, params, pm = rr_pair("bert", seed=9)
    back = params_to_jax(pm.state_dict(), BERT["num_attention_heads"])
    got = jax.tree_util.tree_leaves_with_path(back)
    want = jax.tree_util.tree_leaves_with_path(params)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(path))


def hf_t5(path):
    from transformers import T5Config as HFT5Config
    from transformers import T5ForConditionalGeneration

    torch.manual_seed(0)
    T5ForConditionalGeneration(HFT5Config(
        **T5, decoder_start_token_id=0)).save_pretrained(str(path))
    return str(path)


def test_monot5_builds_from_hf_as_jax(tmp_path, tok):
    path = hf_t5(tmp_path / "monot5-tiny")
    flags = dict(model_name_or_path=path, dtype="float32", pos_token="true",
                 neg_token="false")
    jm, jparams = JaxRRModel.build(JaxModelArguments(**flags), tokenizer=tok)
    pm = RRModel.build(ModelArguments(**flags), tokenizer=tok, device="cpu")
    assert (pm.backbone_type, pm.pos_token_id, pm.neg_token_id) == (
        jm.backbone_type, jm.pos_token_id, jm.neg_token_id) == ("t5", 5, 6)
    b = pair_batch(10)
    with torch.no_grad():
        assert_close(pm.score(**to_torch(b)).numpy(),
                     np.asarray(jm.score(jparams, **to_jax(b))),
                     what="monoT5 built from HF")
    enc = RRModel.build(ModelArguments(model_name_or_path=path,
                                       encoder_only=True), device="cpu")
    assert enc.backbone_type == "t5enc" and enc.head is not None
    assert enc.head.linear.weight.shape == (1, 32)


def test_build_refusals(tmp_path, tok):
    path = hf_t5(tmp_path / "t5-tiny")
    with pytest.raises(ValueError, match="single-token"):
        RRModel.build(ModelArguments(model_name_or_path=path,
                                     pos_token="about w1",
                                     neg_token="false"),
                      tokenizer=tok, device="cpu")
    with pytest.raises(ValueError, match="pos_token"):
        RRModel.build(ModelArguments(model_name_or_path=path), tokenizer=tok,
                      device="cpu")
    dr = JaxDRModel(encoder_config=JaxBertConfig(**BERT))
    dr.save(dr.init_params(jax.random.PRNGKey(0)), str(tmp_path / "dr"))
    with pytest.raises(ValueError, match="dense-retrieval"):
        RRModel.load(str(tmp_path / "dr"), device="cpu")


@pytest.mark.parametrize("entry", ["load", "build"])
def test_rr_model_defaults_to_the_card(tmp_path, monkeypatch, entry):
    _, _, pm = rr_pair("bert")
    pm.save(str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def call(**kw):
        if entry == "load":
            return RRModel.load(str(tmp_path), **kw)
        return RRModel.build(ModelArguments(model_name_or_path=str(tmp_path)),
                             **kw)

    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call(**kw)
    assert {p.device.type for p in call(device="cpu").parameters()} == {"cpu"}


# ---- Reranker --------------------------------------------------------------


def rerank_data(seed=0, n_q=4, n_d=14):
    rng = np.random.default_rng(seed)

    def text(lo, hi):
        return " ".join(rng.choice(WORDS, rng.integers(lo, hi)))

    queries = {f"q{i}": {"text": text(2, 8)} for i in range(n_q)}
    corpus = {f"d{i}": {"text": text(3, 20) if i % 2 else text(120, 200)}
              for i in range(n_d)}
    run = {qid: {f"d{j}": float(rng.standard_normal())
                 for j in rng.choice(n_d, 8, replace=False)}
           for qid in queries}
    run["q0"]["missing_doc"] = 9.0  # skipped: not in the corpus
    run["missing_query"] = {"d1": 1.0}  # skipped: not in the queries
    return queries, corpus, run


RERANK = {"bert_buckets": ("bert", {}, 62, 190),
          "bert_160_positions": ("bert", dict(max_position_embeddings=160),
                                 40, 108),
          "monot5": ("t5", {}, 62, 190)}


@pytest.mark.parametrize("name", sorted(RERANK))
def test_reranker_matches_jax(tok, name):
    backbone, bert_kw, q_len, p_len = RERANK[name]
    jm, params, pm = rr_pair(backbone, seed=11, **bert_kw)
    queries, corpus, run = rerank_data()
    jr = JaxReranker(jm, params, tok, JaxDataArguments(
        q_max_len=q_len, p_max_len=p_len),
        JaxInferenceArguments(per_device_eval_batch_size=3))
    pr = Reranker(pm, tok, DataArguments(q_max_len=q_len, p_max_len=p_len),
                  InferenceArguments(per_device_eval_batch_size=3))
    assert pr.bucket_lens == jr.bucket_lens == (
        [150] if name == "bert_160_positions" else [128, 256])
    lengths = {len(f["input_ids"]) for f in pr._pair_stream(queries, corpus,
                                                           run)}
    assert min(lengths) <= 128 < max(lengths)  # both buckets are used
    for depth in (None, 5):
        want = jr.rerank(queries, corpus, run, depth=depth)
        got = pr.rerank(queries, corpus, run, depth=depth)
        assert set(got) == set(want) == {"q0", "q1", "q2", "q3"}
        scale = max(abs(s) for d in want.values() for s in d.values())
        for qid in want:
            top = sorted(run[qid], key=run[qid].get, reverse=True)[:depth]
            assert set(got[qid]) == set(want[qid]) == set(top) & set(corpus)
            for did, s in want[qid].items():
                assert abs(got[qid][did] - s) <= REL * scale, (qid, did)
            order_w = sorted(want[qid], key=want[qid].get, reverse=True)
            order_g = sorted(got[qid], key=got[qid].get, reverse=True)
            for a, b in zip(order_w, order_g):  # the same order but at ties
                assert a == b or abs(want[qid][a] - want[qid][b]) \
                    <= 2 * REL * scale


def test_reranker_refuses_a_mesh(tok):
    """A mesh is taken now: its global batch is per-device x dp, and on a
    one-rank mesh the scores are those without one (2-rank runs against
    JAX's mesh Reranker: tests/test_torch_mesh.py)."""
    from openmatch_tpu_torch.parallel.mesh import Mesh, make_mesh

    _, _, pm = rr_pair("bert")
    args = InferenceArguments(per_device_eval_batch_size=2)
    assert Reranker(pm, tok, DataArguments(), args,
                    mesh=Mesh(dp=2, tp=1)).batch_size == 4
    queries = {"q": {"text": "w1 w2 w3"}}
    corpus = {f"d{i}": {"text": " ".join(WORDS[i:i + 6])} for i in range(5)}
    run = {"q": {d: 1.0 for d in corpus}}
    want = Reranker(pm, tok, DataArguments(), args).rerank(queries, corpus,
                                                          run)
    got = Reranker(pm, tok, DataArguments(), args,
                   mesh=make_mesh(device="cpu")).rerank(queries, corpus, run)
    assert got == want and len(got["q"]) == 5


def test_pair_segments_are_cut_and_zero_padded(tok):
    _, _, pm = rr_pair("bert")
    pr = Reranker(pm, tok, DataArguments(q_max_len=4, p_max_len=6),
                  InferenceArguments(per_device_eval_batch_size=2))
    feats = list(pr._pair_stream({"q": {"text": "w1 w2 w3 w4 w5"}},
                                 {"d": {"text": " ".join(WORDS[:20])}},
                                 {"q": {"d": 1.0}}))
    (keys, batch, n_valid), = list(pr._batches(iter(feats)))
    ids, segs = encode_pair(tok, "w1 w2 w3 w4 w5", " ".join(WORDS[:20]), 12)
    assert len(ids) == 12 and n_valid == 1 and keys == [("q", "d")] * 2
    assert batch["input_ids"].shape == (2, 128)
    np.testing.assert_array_equal(batch["token_type_ids"][0, :12], segs)
    assert not batch["token_type_ids"][:, 12:].any()


# ---- the trainer -----------------------------------------------------------


def train_kw(**extra):
    # adam_epsilon 1e-4, as in tests/test_torch_train.py: a gradient of
    # float noise alone would otherwise become a full +-lr step
    return dict(dict(learning_rate=1e-3, weight_decay=0.01, warmup_steps=0,
                     warmup_ratio=0.0, adam_epsilon=1e-4, seed=0,
                     per_device_train_batch_size=4, logging_steps=1,
                     save_steps=0), **extra)


@pytest.mark.parametrize("backbone,loss_fn", [("bert", "bce"), ("bert", "mr"),
                                              ("t5", "ce"), ("t5enc", "smr")])
def test_train_step_matches_jax_trainer(backbone, loss_fn):
    jm, params, pm = rr_pair(backbone, seed=13)
    jm.loss_fn_str = pm.loss_fn_str = ("ce" if backbone == "t5" else loss_fn)
    mesh = make_mesh(1, 1, devices=jax.devices()[:1])
    jt = JaxRRTrainer(jm, params, JaxTrainingArguments(**train_kw()),
                      total_steps=10, mesh=mesh)
    pt = RRTrainer(pm, TrainingArguments(**train_kw()), total_steps=10,
                   device="cpu")
    for seed in (21, 22):  # the first update has lr 0, the second moves
        batch = {"pos_pairs": pair_batch(seed), "neg_pairs": pair_batch(
            seed + 50)}
        want = float(jt.train_step(batch))
        got = float(pt.train_step(batch))
        assert got == pytest.approx(want, rel=1e-5)
    want_tree = jax.tree.map(np.asarray, jt.state.params)
    got_tree = params_to_jax(pm.state_dict(), 4)
    got_leaves = jax.tree_util.tree_leaves_with_path(got_tree)
    want_leaves = jax.tree_util.tree_leaves_with_path(want_tree)
    assert [k for k, _ in got_leaves] == [k for k, _ in want_leaves]
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        tol = 1e-4 * max(np.abs(w).max(), 1e-30)
        assert np.abs(g - w).max() <= tol, jax.tree_util.keystr(path)
    assert pt.step == int(jt.state.step) == 2


def test_trainer_refuses_multi_device_settings():
    """RRTrainer refuses tensor parallelism, with JAX's message; one
    process refuses dp_size=2 as make_mesh does (the 2-rank runs are in
    tests/test_torch_mesh.py)."""
    from openmatch_tpu_torch.parallel.mesh import Mesh

    _, _, pm = rr_pair("bert")
    with pytest.raises(ValueError, match="does not implement tensor "
                                         "parallelism"):
        RRTrainer(pm, TrainingArguments(), total_steps=1, device="cpu",
                  mesh=Mesh(dp=1, tp=2))
    with pytest.raises(ValueError, match=r"dp\(2\) \* tp\(1\) != "
                                         r"devices\(1\)"):
        RRTrainer(pm, TrainingArguments(dp_size=2), total_steps=1,
                  device="cpu")


def test_trainer_resumes_its_checkpoint(tmp_path):
    _, _, pm = rr_pair("bert", seed=15)
    args = TrainingArguments(**train_kw(output_dir=str(tmp_path)))
    batches = [{"pos_pairs": pair_batch(s), "neg_pairs": pair_batch(s + 50)}
               for s in range(30, 34)]
    straight = RRTrainer(pm, args, total_steps=4, device="cpu")
    init = {k: v.clone() for k, v in pm.state_dict().items()}
    for b in batches[:2]:
        straight.train_step(b)
    straight.save_checkpoint()
    for b in batches[2:]:
        straight.train_step(b)
    done = {k: v.clone() for k, v in pm.state_dict().items()}

    fresh = RRModel(BertConfig(**BERT), head_in_dim=32)
    fresh.load_state_dict(init)
    resumed = RRTrainer(fresh, args, total_steps=4, device="cpu")
    assert resumed.maybe_resume() and resumed.step == 2
    for b in batches[2:]:
        resumed.train_step(b)
    for k, v in fresh.state_dict().items():
        torch.testing.assert_close(v, done[k], rtol=0, atol=1e-6)


# ---- drivers ---------------------------------------------------------------


def write_rerank_files(root, queries, corpus, run):
    with open(root / "queries.jsonl", "w") as f:
        for qid, q in queries.items():
            f.write(json.dumps({"id": qid, "text": q["text"]}) + "\n")
    with open(root / "corpus.jsonl", "w") as f:
        for did, d in corpus.items():
            f.write(json.dumps({"id": did, "text": d["text"]}) + "\n")
    with open(root / "run.trec", "w") as f:
        for qid, docs in run.items():
            ranked = sorted(docs.items(), key=lambda kv: -kv[1])
            for r, (did, s) in enumerate(ranked):
                f.write(f"{qid} Q0 {did} {r + 1} {s} run\n")


def read_trec(path):
    out = {}
    with open(path) as f:
        for line in f:
            qid, _, did, _, score, _ = line.split()
            out.setdefault(qid, {})[did] = float(score)
    return out


@pytest.mark.parametrize("backbone", ["bert", "t5"])
def test_rerank_driver_matches_jax(tmp_path, tok, backbone):
    from openmatch_tpu.drivers import rerank as jrerank
    from openmatch_tpu_torch.drivers import rerank

    _, _, pm = rr_pair(backbone, seed=17)
    pm.save(str(tmp_path / "rr"))
    write_rerank_files(tmp_path, *rerank_data(3))
    common = ["--model_name_or_path", str(tmp_path / "rr"),
              "--query_path", str(tmp_path / "queries.jsonl"),
              "--corpus_path", str(tmp_path / "corpus.jsonl"),
              "--trec_run_path", str(tmp_path / "run.trec"),
              "--q_max_len", "16", "--p_max_len", "100",
              "--per_device_eval_batch_size", "4", "--reranking_depth", "6",
              "--dtype", "float32"]
    jrerank.main(common + ["--tokenizer_name", tok.path, "--trec_save_path",
                           str(tmp_path / "jax.trec")])
    result = rerank.main(common + ["--device", "cpu", "--trec_save_path",
                                   str(tmp_path / "port.trec")],
                         tokenizer=tok)
    want, got = read_trec(tmp_path / "jax.trec"), read_trec(
        tmp_path / "port.trec")
    assert set(got) == set(want) == set(result)
    scale = max(abs(s) for d in want.values() for s in d.values())
    for qid in want:
        assert set(got[qid]) == set(want[qid])
        assert len(got[qid]) == (5 if qid == "q0" else 6)  # q0: one missing
        for did in want[qid]:
            assert abs(got[qid][did] - want[qid][did]) <= REL * scale + 1e-6


def test_train_rr_driver_trains_and_saves(tmp_path, tok):
    from openmatch_tpu_torch.drivers import train_rr

    from transformers import BertConfig as HFBertConfig
    from transformers import BertModel

    torch.manual_seed(0)
    BertModel(HFBertConfig(**BERT)).save_pretrained(str(tmp_path / "hf"))
    rng = np.random.default_rng(0)
    with open(tmp_path / "train.jsonl", "w") as f:
        for _ in range(12):
            f.write(json.dumps({
                "query": " ".join(rng.choice(WORDS, 4)),
                "positives": [" ".join(rng.choice(WORDS, 12))],
                "negatives": [" ".join(rng.choice(WORDS, 12))
                              for _ in range(3)]}) + "\n")
    out = tmp_path / "out"
    result = train_rr.main([
        "--model_name_or_path", str(tmp_path / "hf"), "--output_dir",
        str(out), "--train_path", str(tmp_path / "train.jsonl"),
        "--q_max_len", "8", "--p_max_len", "16", "--dtype", "float32",
        "--per_device_train_batch_size", "4", "--max_steps", "5",
        "--save_steps", "3", "--logging_steps", "1", "--loss_fn", "mr",
        "--projection_in_dim", "32",
        "--device", "cpu"], tokenizer=tok)
    assert result["final_step"] == 5 and len(result["losses"]) == 5
    assert np.isfinite(result["losses"]).all()
    assert (out / "checkpoint-3" / "train_state.msgpack").exists()
    loaded = RRModel.load(str(out), device="cpu")
    jl, jparams = JaxRRModel.load(str(out))
    b = pair_batch(40)
    with torch.no_grad():
        assert_close(loaded.score(**to_torch(b)).numpy(),
                     np.asarray(jl.score(jparams, **to_jax(b))),
                     what="trained model in JAX")


def test_drivers_default_to_the_card(tmp_path, monkeypatch):
    from openmatch_tpu_torch.drivers import rerank, train_rr

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in (
            (rerank.main, ["--model_name_or_path", str(tmp_path)]),
            (train_rr.main, ["--model_name_or_path", str(tmp_path),
                             "--output_dir", str(tmp_path / "o")]),
            (serve.main, ["--rr_model_name_or_path", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(argv, tokenizer=object())
    _, _, pm = rr_pair("bert")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RRTrainer(pm, TrainingArguments(), total_steps=1)


# ---- /rerank ---------------------------------------------------------------


@pytest.fixture(scope="module")
def rerank_service(tok):
    jm, params, pm = rr_pair("bert", seed=19)
    svc = serve.RerankService(pm, tok, q_max_len=62, p_max_len=190,
                              max_batch=3)
    yield svc, jm, params
    svc.close()


def direct_score(svc, query, text):
    ids, segs = encode_pair(svc.tokenizer, query, text, svc.max_len)
    with torch.no_grad():
        s = svc.model.score(torch.tensor([ids]), torch.ones(1, len(ids),
                                                            dtype=torch.long),
                            torch.tensor([segs]))
    return float(svc.model.relevance_logprob(s)[0])


# odd docs are longer than 128 tokens, even ones shorter
DOCS = [{"id": f"d{i}", "text": " ".join((WORDS * 5)[i:i + 3 + 150 * (i % 2)])}
        for i in range(7)]


def test_rerank_service_matches_direct_and_jax(rerank_service, tok):
    from openmatch_tpu.drivers.serve import RerankService as JaxRerankService

    svc, jm, params = rerank_service
    results = svc.rerank("w3 w4", DOCS)  # 3 chunks of max_batch 3
    assert sorted(r["id"] for r in results) == sorted(d["id"] for d in DOCS)
    scores = [r["score"] for r in results]
    assert scores == sorted(scores, reverse=True)
    jsvc = JaxRerankService(jm, params, tok, q_max_len=62, p_max_len=190,
                            max_batch=3)
    want = {r["id"]: r["score"] for r in jsvc.rerank("w3 w4", DOCS)}
    scale = max(abs(s) for s in want.values())
    for r in results:
        assert abs(r["score"] - direct_score(svc, "w3 w4",
                                             DOCS[int(r["id"][1:])]["text"])) \
            <= REL * scale
        assert abs(r["score"] - want[r["id"]]) <= REL * scale
    one_chunk = {r["id"]: r["score"] for r in svc.rerank("w3 w4", DOCS[:3])}
    for r in results:
        if r["id"] in one_chunk:
            assert abs(one_chunk[r["id"]] - r["score"]) <= REL * scale
    assert svc.rerank("w3 w4", []) == []


def test_rerank_service_pads_chunks_to_128_multiples(rerank_service,
                                                     monkeypatch):
    svc, _, _ = rerank_service
    shapes = []
    real = serve.score_batch

    def recording(model, batch, device):
        shapes.append(batch["input_ids"].shape)
        return real(model, batch, device)

    monkeypatch.setattr(serve, "score_batch", recording)
    svc.warmup()
    assert (3, 128) in shapes and (3, 256) in shapes
    shapes.clear()
    svc.rerank("w1", [DOCS[0], DOCS[2], DOCS[4], DOCS[1]])  # short, then long
    assert shapes == [(3, 128), (3, 256)]


def post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def serving(handler):
    server = serve.ServingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread, f"http://127.0.0.1:{server.server_address[1]}"


def test_rerank_http(rerank_service):
    svc, _, _ = rerank_service
    server, thread, base = serving(serve.make_handler(None, 4, svc))
    try:
        with urllib.request.urlopen(base + "/health", timeout=30) as resp:
            assert json.loads(resp.read())["endpoints"] == ["/rerank"]
        status, body = post(base + "/rerank", {"query": "w3 w4",
                                               "docs": DOCS})
        assert status == 200
        assert body["results"] == svc.rerank("w3 w4", DOCS)
        for bad, field in (({"query": 1, "docs": DOCS}, "query"),
                           ({"query": "q", "docs": []}, "docs"),
                           ({"query": "q", "docs": [{"text": "no id"}]},
                            "docs"),
                           ({"query": "q", "docs": [{"id": 1, "text": 2}]},
                            "docs")):
            status, body = post(base + "/rerank", bad)
            assert status == 400 and field in body["error"]
        status, body = post(base + "/search", {"queries": ["q"]})
        assert status == 404 and "not enabled" in body["error"]
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


def test_rerank_404_when_disabled():
    server, thread, base = serving(serve.make_handler(None, 4, None))
    try:
        status, body = post(base + "/rerank", {"query": "q", "docs": [
            {"id": "a", "text": "t"}]})
        assert status == 404 and "not enabled" in body["error"]
        with urllib.request.urlopen(base + "/health", timeout=30) as resp:
            assert json.loads(resp.read())["endpoints"] == []
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


def test_rerank_only_main(tmp_path, tok, monkeypatch):
    _, _, pm = rr_pair("t5", seed=23)
    pm.save(str(tmp_path / "rr"))
    started = []

    def serve_in_background(self):
        thread = threading.Thread(target=serve.ThreadingHTTPServer
                                  .serve_forever, args=(self,), daemon=True)
        thread.start()
        started.append((self, thread))

    monkeypatch.setattr(serve.ServingHTTPServer, "serve_forever",
                        serve_in_background)
    monkeypatch.setattr(serve.ServingHTTPServer, "allow_reuse_address", True)
    serve.main(["--rr_model_name_or_path", str(tmp_path / "rr"), "--port",
                "0", "--max_batch", "4", "--q_max_len", "8", "--p_max_len",
                "24", "--device", "cpu"], rr_tokenizer=tok)
    (server, thread), = started
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/health", timeout=30) as resp:
            assert json.loads(resp.read())["endpoints"] == ["/rerank"]
        status, body = post(base + "/rerank", {"query": "w1", "docs": DOCS})
        assert status == 200 and len(body["results"]) == len(DOCS)
        assert all(r["score"] <= 0 for r in body["results"])  # log P(rel)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    with pytest.raises(ValueError, match="nothing to serve"):
        serve.main(["--device", "cpu"])


def test_close_stops_the_worker(tok):
    _, _, pm = rr_pair("bert")
    svc = serve.RerankService(pm, tok, q_max_len=8, p_max_len=16,
                              max_batch=2)
    assert svc.rerank("w1", DOCS[:1])[0]["id"] == "d0"
    svc.close()
    assert not svc._thread.is_alive()
