"""The port's T5 seq2seq half and query generation against the JAX
package's on the same weights: ``T5Seq2Seq`` logits (tied and untied
heads, with and without a decoder mask), ``shift_right``,
``seq2seq_loss``, ``greedy_generate`` (equal ids on these seeds, and the
teacher-forcing check that holds whatever the seed: each generated token's
logit, read back through JAX's ``T5Seq2Seq``, is within the tolerance of
its row's maximum), ``QGModel``'s loss and gradient, its HF loader, the
ContrastQG helpers and ``qg_synthesis``'s output file, which feeds the
port's ``train_dr``; and the twins of ``scripts/gtr/convert_gtr_ckpt.py``
and ``scripts/scale_t5_weights.py``, whose files equal the JAX scripts'
(run here in this process): byte for byte for ``params.msgpack`` and the
side files, tensor for tensor and key order for ``pytorch_model.bin``.

Weights are numpy-seeded Flax trees carried into the port with
``jax_convert``, or tiny HF checkpoints saved here. Tolerances: fp32 values
within 1e-5 absolute; each gradient leaf within 1e-5 x the largest |JAX
gradient| of the tree; token ids exactly.
"""

import functools
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmatch_tpu.drivers import qg_synthesis as jqg_synthesis
from openmatch_tpu.models import t5 as jt5
from openmatch_tpu.research import qg as jqg
from openmatch_tpu_torch.drivers import qg_synthesis as pqg_synthesis
from openmatch_tpu_torch.models import t5
from openmatch_tpu_torch.models.jax_convert import (params_from_jax,
                                                    params_to_jax)
from openmatch_tpu_torch.research import qg as pqg

torch.set_num_threads(2)

ATOL = 1e-5
GRAD_REL = 1e-5
TIE_TOL = 1e-5  # teacher forcing: chosen logit >= row max - TIE_TOL
TINY = dict(d_model=16, d_kv=4, d_ff=32, num_layers=2, num_decoder_layers=2,
            num_heads=4, relative_attention_num_buckets=8,
            relative_attention_max_distance=20, decoder_start_token_id=0,
            pad_token_id=0)
HEADS = {"tied": dict(feed_forward_proj="relu", tie_word_embeddings=True),
         "untied": dict(feed_forward_proj="gated-gelu",
                        tie_word_embeddings=False)}


def configs(head="tied", vocab=64, layers=2):
    kw = dict(TINY, vocab_size=vocab, num_layers=layers,
              num_decoder_layers=layers, **HEADS[head])
    return jt5.T5Config(**kw), t5.T5Config(**kw)


def seeded_tree(tree, seed):
    """Every leaf of a Flax tree replaced by a seeded draw: norms near 1,
    tables and embeddings N(0, 1), kernels N(0, 1/fan_in)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = np.shape(leaf)
        x = rng.standard_normal(shape).astype(np.float32)
        if name.endswith("['weight']"):
            x = 1.0 + 0.2 * x
        elif "kernel" in name:
            x = x / np.sqrt(shape[0])
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


def seq2seq_pair(head="tied", seed=1, vocab=64, layers=2):
    """(JAX T5Seq2Seq, its seeded tree, the port's T5Seq2Seq)."""
    jcfg, pcfg = configs(head, vocab, layers)
    jmod = jt5.T5Seq2Seq(jcfg, dtype=jnp.float32)
    ids = jnp.zeros((1, 4), jnp.int32)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), ids,
                            jnp.ones_like(ids), ids)["params"]
    tree = seeded_tree(shapes, seed)
    port = t5.T5Seq2Seq(pcfg)
    port.load_state_dict(params_from_jax(tree), strict=True)
    return jmod, tree, port.eval()


def inputs(seed=0, b=3, s=9, t=6, vocab=64):
    rng = np.random.RandomState(seed)
    ids = rng.randint(3, vocab, size=(b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[1, 6:] = 0
    mask[2, 3:] = 0
    dec = rng.randint(2, vocab, size=(b, t)).astype(np.int32)
    dec[:, 0] = 0
    dec_mask = np.ones((b, t), np.int32)
    dec_mask[1, 4:] = 0
    return ids * mask, mask, dec, dec_mask


@functools.lru_cache(maxsize=None)
def jitted_logits(jmod):
    return jax.jit(lambda p, *args: jmod.apply({"params": p}, *args)[
        "logits"])


def jax_logits(jmod, tree, ids, mask, dec, dec_mask=None):
    args = [jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(dec)]
    if dec_mask is not None:
        args.append(jnp.asarray(dec_mask))
    return np.asarray(jitted_logits(jmod)(tree, *args))


def port_logits(port, ids, mask, dec, dec_mask=None):
    with torch.no_grad():
        return port(torch.from_numpy(ids), torch.from_numpy(mask),
                    torch.from_numpy(dec),
                    None if dec_mask is None else torch.from_numpy(dec_mask)
                    )["logits"].numpy()


def assert_allclose(got, want, what, atol=ATOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= atol, f"{what}: max|diff| {err} > {atol}"


# ---- T5Seq2Seq --------------------------------------------------------------


@pytest.mark.parametrize("dec_masked", [False, True])
@pytest.mark.parametrize("head", sorted(HEADS))
def test_seq2seq_logits_match_jax(head, dec_masked):
    jmod, tree, port = seq2seq_pair(head)
    ids, mask, dec, dec_mask = inputs()
    dm = dec_mask if dec_masked else None
    want = jax_logits(jmod, tree, ids, mask, dec, dm)
    got = port_logits(port, ids, mask, dec, dm)
    assert np.isfinite(got).all()
    assert_allclose(got, want, f"{head} logits")


def test_seq2seq_tree_is_the_encdec_tree():
    """The JAX T5Seq2Seq tree is T5EncoderDecoderStep's; the port's
    T5Seq2Seq takes the encdec state strictly, and its state goes back to
    the same tree."""
    jcfg, pcfg = configs("untied")
    ids = jnp.zeros((1, 4), jnp.int32)
    seq = jax.eval_shape(jt5.T5Seq2Seq(jcfg).init, jax.random.PRNGKey(0),
                         ids, jnp.ones_like(ids), ids)["params"]
    step = jax.eval_shape(jt5.T5EncoderDecoderStep(jcfg).init,
                          jax.random.PRNGKey(0), ids,
                          jnp.ones_like(ids))["params"]
    assert jax.tree.structure(seq) == jax.tree.structure(step)
    tree = seeded_tree(step, 3)
    port = t5.T5Seq2Seq(pcfg)
    port.load_state_dict(params_from_jax(tree), strict=True)
    assert set(port.state_dict()) == set(
        t5.T5EncoderDecoderStep(pcfg).state_dict())
    back = params_to_jax(port.state_dict(), pcfg.num_heads)
    for (path, g), (_, w) in zip(jax.tree_util.tree_leaves_with_path(back),
                                 jax.tree_util.tree_leaves_with_path(tree)):
        np.testing.assert_array_equal(g, w, jax.tree_util.keystr(path))


def test_seq2seq_decoder_step_zero_is_the_encdec_step():
    """Decoding the start token alone gives T5EncoderDecoderStep's output
    on the same weights."""
    _, _, port = seq2seq_pair("tied")
    step = t5.T5EncoderDecoderStep(port.config)
    step.load_state_dict(port.state_dict(), strict=True)
    ids, mask, _, _ = inputs()
    start = torch.zeros((3, 1), dtype=torch.long)
    with torch.no_grad():
        got = port(torch.from_numpy(ids), torch.from_numpy(mask), start)
        want = step.eval()(torch.from_numpy(ids), torch.from_numpy(mask))
    for k in ("logits", "decoder_hidden", "last_hidden_state"):
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


def test_training_after_inference_mode_use():
    """A bucket table first built under inference_mode (a rerank or an
    encode) is cached; a later training step must still take gradients
    through the position-bias tables."""
    _, _, port = seq2seq_pair("tied", seed=2)
    t5._bucket_table.cache_clear()
    ids, mask, dec, _ = inputs(seed=3)
    args = (torch.from_numpy(ids), torch.from_numpy(mask),
            torch.from_numpy(dec))
    with torch.inference_mode():
        port(*args)
    port.train()
    port(*args)["logits"].sum().backward()
    assert port.enc_rel_bias.grad.abs().sum() > 0
    assert port.dec_rel_bias.grad.abs().sum() > 0


def test_shift_right_matches_jax():
    rng = np.random.RandomState(4)
    labels = rng.randint(1, 50, size=(4, 7)).astype(np.int64)
    labels[1, 5:] = -100
    labels[2, 2:] = 0
    want = np.asarray(jt5.shift_right(jnp.asarray(labels), 0, 0))
    got = t5.shift_right(torch.from_numpy(labels), 0, 0).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        t5.shift_right(torch.tensor([[5, 6, 7]]), 0).numpy(), [[0, 5, 6]])


def test_seq2seq_loss_matches_jax():
    rng = np.random.RandomState(5)
    logits = rng.randn(3, 6, 40).astype(np.float32) * 3
    labels = rng.randint(0, 40, size=(3, 6)).astype(np.int64)
    labels[0, 4:] = -100  # clamped at 0 by both
    mask = (rng.rand(3, 6) > 0.3).astype(np.int32)
    want = float(jt5.seq2seq_loss(jnp.asarray(logits), jnp.asarray(labels),
                                  jnp.asarray(mask)))
    got = float(t5.seq2seq_loss(torch.from_numpy(logits),
                                torch.from_numpy(labels),
                                torch.from_numpy(mask)))
    assert_allclose(got, want, "loss")
    # pads are left out: zero logits over 4 classes give log(4)
    loss = t5.seq2seq_loss(torch.zeros(1, 3, 4), torch.tensor([[2, 1, 0]]),
                           torch.tensor([[1, 1, 0]]))
    assert float(loss) == pytest.approx(np.log(4), rel=1e-6)


# ---- greedy_generate --------------------------------------------------------


def teacher_forcing_gap(jmod, tree, ids, mask, gen, start=0):
    """Each generated token's JAX logit below its row's maximum, read by
    teacher forcing the generated ids through JAX's T5Seq2Seq; rows after
    eos are not read."""
    dec = np.concatenate([np.full((gen.shape[0], 1), start, np.int32),
                          gen[:, :-1].astype(np.int32)], axis=1)
    logits = jax_logits(jmod, tree, ids, mask, dec)
    chosen = np.take_along_axis(logits, gen[..., None].astype(np.int64),
                                -1)[..., 0]
    return logits.max(-1) - chosen


@pytest.mark.parametrize("eos", [1, -1])
@pytest.mark.parametrize("head", sorted(HEADS))
def test_greedy_generate_matches_jax(head, eos):
    jmod, tree, port = seq2seq_pair(head, seed=6)
    ids, mask, _, _ = inputs(seed=7)
    want = np.asarray(jt5.greedy_generate(
        jmod, tree, jnp.asarray(ids), jnp.asarray(mask), 8, eos))
    got = t5.greedy_generate(port, torch.from_numpy(ids),
                             torch.from_numpy(mask), 8, eos).numpy()
    assert got.shape == (3, 8)
    np.testing.assert_array_equal(got, want)
    gap = teacher_forcing_gap(jmod, tree, ids, mask, got)
    live = np.cumsum(got == eos, axis=1) - (got == eos) == 0  # to eos
    assert (gap[live] <= TIE_TOL).all(), gap


def test_greedy_generate_pads_after_eos():
    """With a token the free run emits as eos, each row is the free run up
    to its first eos and eos after it."""
    _, _, port = seq2seq_pair("untied", seed=8)
    ids, mask, _, _ = inputs(seed=9)
    ids, mask = torch.from_numpy(ids), torch.from_numpy(mask)
    free = t5.greedy_generate(port, ids, mask, 12, -1).numpy()
    eos = int(free[0, 2])
    gen = t5.greedy_generate(port, ids, mask, 12, eos).numpy()
    assert (gen == eos).any(axis=1)[0]
    for row, ref in zip(gen, free):
        hits = np.flatnonzero(ref == eos)
        end = hits[0] if hits.size else len(ref)
        np.testing.assert_array_equal(row[: end + 1], ref[: end + 1])
        assert (row[end:] == eos).all()


def test_temperature_sampling_laws():
    """Deterministic under a seed, inside the vocabulary, different from
    greedy at a high temperature; without a generator it is greedy, as in
    JAX, which gates sampling on a key."""
    _, _, port = seq2seq_pair("tied", seed=10)
    ids, mask, _, _ = inputs(seed=11)
    ids, mask = torch.from_numpy(ids), torch.from_numpy(mask)

    def sample(seed):
        g = torch.Generator().manual_seed(seed)
        return t5.greedy_generate(port, ids, mask, 10, -1, 5.0, g)

    a, b = sample(0), sample(0)
    assert torch.equal(a, b)
    assert ((a >= 0) & (a < 64)).all()
    greedy = t5.greedy_generate(port, ids, mask, 10, -1)
    assert not torch.equal(a, greedy)
    assert not torch.equal(a, sample(1))
    assert torch.equal(t5.greedy_generate(port, ids, mask, 10, -1, 5.0),
                       greedy)


# ---- QGModel ----------------------------------------------------------------


def qg_pair(seed=12, vocab=64):
    jmod, tree, port = seq2seq_pair("tied", seed=seed, vocab=vocab)
    jq = jqg.QGModel(jmod.config, tree)
    pq = pqg.QGModel(port.config, port.state_dict(), device="cpu")
    return jq, pq


def qg_batch(seed=13, vocab=64):
    ids, mask, dec, dec_mask = inputs(seed, vocab=vocab)
    labels = np.concatenate([dec[:, 1:], np.ones((3, 1), np.int32)], 1)
    return {"input_ids": ids, "attention_mask": mask,
            "labels": labels * dec_mask, "label_mask": dec_mask}


def test_qg_loss_and_gradient_match_jax():
    jq, pq = qg_pair()
    batch = qg_batch()
    want, grads = jax.jit(jax.value_and_grad(jq.loss))(
        jq.params, {k: jnp.asarray(v) for k, v in batch.items()})
    pq.model.train()
    got = pq.loss(batch)
    got.backward()
    assert_allclose(float(got.detach()), float(want), "loss")
    named = {n: p.grad for n, p in pq.model.named_parameters()}
    back = jax.tree_util.tree_leaves_with_path(
        params_to_jax(named, pq.config.num_heads))
    want = jax.tree_util.tree_leaves_with_path(jax.device_get(grads))
    assert [k for k, _ in back] == [k for k, _ in want]
    # rounding errors scale with the largest terms summed; a key kernel's
    # gradient nearly cancels (softmax), so the scale is the tree's
    scale = max(np.abs(np.asarray(w)).max() for _, w in want)
    for (path, g), (_, w) in zip(back, want):
        assert_allclose(g, np.asarray(w), jax.tree_util.keystr(path),
                        GRAD_REL * scale)


def test_qg_train_step_learns():
    """The port's optimizer through make_train_step: a fixed source maps to
    a fixed target and greedy generation reproduces it (JAX
    tests/test_qg.py's overfit check)."""
    from openmatch_tpu_torch.train.state import OptaxAdam

    _, pcfg = configs("tied", vocab=32, layers=1)
    qg = pqg.QGModel(pcfg, device="cpu")
    qg.init_params(0)
    batch = {"input_ids": np.array([[5, 6, 7, 8]]),
             "attention_mask": np.ones((1, 4), np.int64),
             "labels": np.array([[9, 10, 11, 1]]),
             "label_mask": np.ones((1, 4), np.int64)}
    step = qg.make_train_step(OptaxAdam(qg.model.parameters(), lr=5e-3))
    losses = [float(step(batch)) for _ in range(300)]
    assert losses[-1] < 0.1 < losses[0]
    gen = qg.generate(batch["input_ids"], batch["attention_mask"], 4, 1)
    np.testing.assert_array_equal(gen[0].numpy(), [9, 10, 11, 1])


def hf_t5_dir(path, vocab, seed):
    from transformers import T5Config as HFT5Config
    from transformers import T5ForConditionalGeneration

    torch.manual_seed(seed)
    kw = {k: v for k, v in TINY.items() if k != "pad_token_id"}
    cfg = HFT5Config(vocab_size=vocab, **kw)
    T5ForConditionalGeneration(cfg).save_pretrained(str(path))
    return str(path)


def test_from_pretrained_matches_jax(tmp_path, monkeypatch):
    path = hf_t5_dir(tmp_path / "qg", 64, 0)
    jq = jqg.QGModel.from_pretrained(path)
    monkeypatch.setitem(sys.modules, "transformers", None)
    pq = pqg.QGModel.from_pretrained(path, device="cpu")
    assert pq.config.to_dict() == jq.config.to_dict()
    ids, mask, dec, _ = inputs(seed=14)
    want = jax_logits(jq.model, jq.params, ids, mask, dec)
    assert_allclose(port_logits(pq.model, ids, mask, dec), want, "logits")


# ---- the ContrastQG helpers and the pipeline --------------------------------

TOPICS = [f"topic{i}" for i in range(8)]
WORDS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "document", "query",
         "positive", "negative", ":"] + TOPICS


@pytest.fixture(scope="module")
def qg_files(tmp_path_factory):
    """A BERT word-piece tokenizer over WORDS (as JAX tests/test_qg.py),
    an 8-doc corpus in which every word but the topic appears in every doc,
    and two tiny HF T5 checkpoints (seed QG and ContrastQG)."""
    from transformers import BertTokenizerFast

    d = tmp_path_factory.mktemp("qg")
    (d / "vocab.txt").write_text("\n".join(WORDS))
    tok = BertTokenizerFast(vocab_file=str(d / "vocab.txt"))
    tok.save_pretrained(str(d / "tok"))
    (d / "docs.jsonl").write_text("\n".join(
        json.dumps({"id": f"d{i}", "title": "t" if i == 3 else "",
                    "text": f"document query positive negative {t}"})
        for i, t in enumerate(TOPICS)) + "\n")
    # seeds whose random models emit a word of every doc (seed QG) and a
    # non-special word (ContrastQG): a model that emits [PAD] or one
    # doc's topic first synthesizes nothing, in either package
    hf_t5_dir(d / "qg", tok.vocab_size, 8)
    hf_t5_dir(d / "cqg", tok.vocab_size, 13)
    return d, tok


def test_decode_and_contrast_input_match_jax(qg_files):
    _, tok = qg_files
    for ids in ([5, 6, 1, 7], [5, 6], [2, 5, 3, 1]):
        assert pqg._decode_generated(tok, ids) == \
            jqg._decode_generated(tok, ids)
    assert pqg.make_contrast_input(tok, "document topic1", "query topic2",
                                   6) == \
        jqg.make_contrast_input(tok, "document topic1", "query topic2", 6)


@pytest.mark.parametrize("band", [(5, 10), (50, 100)])
def test_contrast_pairs_match_jax(band):
    rng = np.random.RandomState(15)
    run = {f"q{j}": {f"d{i}": float(rng.rand()) for i in range(12)}
           for j in range(6)}
    run["q5"] = {}
    seeds = {f"q{j}": f"d{j}" for j in range(4)}
    assert list(pqg.build_contrast_pairs(run, seeds, neg_rank_range=band,
                                         seed=3)) == \
        list(jqg.build_contrast_pairs(run, seeds, neg_rank_range=band,
                                      seed=3))


def test_seed_queries_match_jax(qg_files):
    d, tok = qg_files
    corpus = pqg_synthesis.load_corpus(str(d / "docs.jsonl"))
    assert corpus == jqg_synthesis.load_corpus(str(d / "docs.jsonl"))
    jq = jqg.QGModel.from_pretrained(str(d / "qg"))
    pq = pqg.QGModel.from_pretrained(str(d / "qg"), device="cpu")
    kw = dict(max_src_len=12, max_new_tokens=4, batch_size=3,
              eos_token_id=-1)
    assert pqg.generate_seed_queries(pq, tok, corpus, **kw) == \
        jqg.generate_seed_queries(jq, tok, corpus, **kw)
    # sampling without a generator seeds one: the same queries twice
    a = pqg.generate_seed_queries(pq, tok, corpus, temperature=2.0, **kw)
    assert a == pqg.generate_seed_queries(pq, tok, corpus, temperature=2.0,
                                          **kw)
    assert a.keys() <= corpus.keys()


def test_qg_synthesis_matches_jax_and_trains(qg_files, tmp_path):
    """Both packages' main write the same jsonl, which feeds the port's DR
    training stack."""
    d, tok = qg_files
    flags = ["--corpus_path", str(d / "docs.jsonl"), "--qg_model_path",
             str(d / "qg"), "--cqg_model_path", str(d / "cqg"),
             "--tokenizer_name", str(d / "tok"), "--max_src_len", "16",
             "--max_new_tokens", "4", "--batch_size", "4", "--bm25_topk",
             "8", "--neg_rank_lo", "2", "--neg_rank_hi", "6"]
    jqg_synthesis.main(flags + ["--output_path", str(tmp_path / "jax.jsonl")])
    n = pqg_synthesis.main(flags + ["--output_path",
                                    str(tmp_path / "port.jsonl"),
                                    "--device", "cpu"], tokenizer=tok)
    got = (tmp_path / "port.jsonl").read_text()
    assert got == (tmp_path / "jax.jsonl").read_text()
    rows = [json.loads(line) for line in got.splitlines()]
    assert len(rows) == n >= 4
    corpus = pqg_synthesis.load_corpus(str(d / "docs.jsonl"))
    for r in rows:
        assert r["query"] and r["positives"][0] in corpus.values()
        assert r["negatives"][0] in corpus.values()
        assert r["positives"][0] != r["negatives"][0]

    from openmatch_tpu_torch.config import DataArguments, TrainingArguments
    from openmatch_tpu_torch.data.collators import QPCollator
    from openmatch_tpu_torch.data.loader import batched
    from openmatch_tpu_torch.data.train_dataset import DRTrainDataset
    from openmatch_tpu_torch.models.bert import BertConfig
    from openmatch_tpu_torch.models.dr_model import DRModel
    from openmatch_tpu_torch.train.dr_trainer import DRTrainer

    torch.manual_seed(2)
    model = DRModel(BertConfig(vocab_size=tok.vocab_size, hidden_size=16,
                               num_hidden_layers=1, num_attention_heads=2,
                               intermediate_size=32,
                               max_position_embeddings=32))
    data_args = DataArguments(train_path=str(tmp_path / "port.jsonl"),
                              train_n_passages=2, q_max_len=8, p_max_len=8)
    trainer = DRTrainer(model, TrainingArguments(
        output_dir=str(tmp_path / "dr"), learning_rate=1e-3,
        warmup_ratio=0.0, logging_steps=1000, save_steps=0), total_steps=1,
        device="cpu")
    collator = QPCollator(pad_token_id=tok.pad_token_id, q_max_len=8,
                          p_max_len=8)
    batch = next(iter(batched(DRTrainDataset(tok, data_args).epoch_iterator(
        0, None), n, collator)))
    assert np.isfinite(float(trainer.train_step(batch)))


# ---- the T5 checkpoint tools ------------------------------------------------

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_jax_script(rel_path, argv, monkeypatch):
    """``main()`` of a script under ``scripts/``, in this process, with
    ``argv`` as its command line."""
    import importlib.util

    path = os.path.join(REPO, rel_path)
    spec = importlib.util.spec_from_file_location(
        "jax_script_" + os.path.basename(path)[:-3], path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    monkeypatch.setattr(sys, "argv", [path] + argv)
    module.main()


def gtr_dir(path, dense_fmt, head=True):
    """A sentence-transformers GTR layout: an HF T5 encoder, and a
    ``2_Dense`` linear head 16 -> 12 without bias."""
    from transformers import T5Config as HFT5Config
    from transformers import T5EncoderModel

    torch.manual_seed(3)
    kw = {k: v for k, v in TINY.items() if k != "pad_token_id"}
    T5EncoderModel(HFT5Config(vocab_size=64, **kw)).save_pretrained(
        str(path))
    if head:
        dense = path / "2_Dense"
        dense.mkdir()
        (dense / "config.json").write_text(json.dumps({
            "in_features": 16, "out_features": 12, "bias": False,
            "activation_function": "torch.nn.modules.linear.Identity"}))
        w = {"linear.weight": torch.randn(12, 16)}
        if dense_fmt == "bin":
            torch.save(w, dense / "pytorch_model.bin")
        else:
            from safetensors.torch import save_file

            save_file(w, str(dense / "model.safetensors"))
    return str(path)


@pytest.mark.parametrize("dense_fmt", ["bin", "safetensors", "none"])
def test_convert_gtr_twin_writes_jax_bytes(tmp_path, monkeypatch, dense_fmt):
    from openmatch_tpu_torch.models.dr_model import DRModel
    from openmatch_tpu_torch.scripts.gtr import convert_gtr_ckpt

    src = gtr_dir(tmp_path / "gtr", dense_fmt, head=dense_fmt != "none")
    run_jax_script("scripts/gtr/convert_gtr_ckpt.py",
                   ["--input", src, "--output", str(tmp_path / "jax")],
                   monkeypatch)
    monkeypatch.setitem(sys.modules, "transformers", None)
    monkeypatch.setitem(sys.modules, "safetensors", None)
    convert_gtr_ckpt.main(["--input", src, "--output", str(tmp_path / "port")])
    for name in ("params.msgpack", "openmatch_config.json"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    model = DRModel.load(str(tmp_path / "port"), device="cpu")
    ids, mask, _, _ = inputs(seed=16)
    with torch.no_grad():
        reps = model.encode_passage(torch.from_numpy(ids),
                                    torch.from_numpy(mask))
    assert reps.shape == (3, 12 if dense_fmt != "none" else 16)
    torch.testing.assert_close(reps.norm(dim=-1), torch.ones(3), rtol=0,
                               atol=1e-6)


def om_checkpoint(path, backbone):
    """An OpenMatch T5 checkpoint (encoder-only or encoder-decoder, untied
    towers) written by the port's DRModel.save from seeded weights."""
    from openmatch_tpu_torch.models.dr_model import DRModel

    _, pcfg = configs("tied", layers=2)
    torch.manual_seed(4)
    model = DRModel(pcfg, backbone_type=backbone, tied=False,
                    pooling="mean")
    with torch.no_grad():
        for p in model.parameters():
            p.normal_()
    model.save(str(path))
    return str(path)


@pytest.mark.parametrize("backbone", ["t5", "t5_encdec"])
def test_scale_t5_twin_flax_branch_writes_jax_bytes(tmp_path, monkeypatch,
                                                    backbone):
    from openmatch_tpu_torch.models.flax_msgpack import read_flax_msgpack
    from openmatch_tpu_torch.scripts import scale_t5_weights

    src = om_checkpoint(tmp_path / "om", backbone)
    argv = ["--input_model_path", src, "--num_layers", "2"]
    run_jax_script("scripts/scale_t5_weights.py",
                   argv + ["--output_model_path", str(tmp_path / "jax")],
                   monkeypatch)
    scale_t5_weights.main(argv + ["--output_model_path",
                                  str(tmp_path / "port")])
    for name in ("params.msgpack", "openmatch_config.json"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    # exactly the attention outputs / 100, the FFNs / 10, shared / 100
    before = read_flax_msgpack(str(tmp_path / "om" / "params.msgpack"))
    after = read_flax_msgpack(str(tmp_path / "port" / "params.msgpack"))
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(after),
                                 jax.tree_util.tree_leaves_with_path(before)):
        name = jax.tree_util.keystr(path)
        div = 100 if ("['o']" in name or "['shared']" in name) else \
            10 if "['ff']" in name else 1
        np.testing.assert_array_equal(a, b / div if div > 1 else b, name)


def test_scale_t5_twin_hf_branch_matches_jax(tmp_path, monkeypatch):
    src = tmp_path / "hf"
    hf_t5_dir(src, 64, 5)
    (src / "spiece_note.txt").write_text("a side file\n")
    argv = ["--input_model_path", str(src), "--num_layers", "2"]
    run_jax_script("scripts/scale_t5_weights.py",
                   argv + ["--output_model_path", str(tmp_path / "jax")],
                   monkeypatch)
    from openmatch_tpu_torch.scripts import scale_t5_weights

    monkeypatch.setitem(sys.modules, "transformers", None)
    monkeypatch.setitem(sys.modules, "safetensors", None)
    scale_t5_weights.main(argv + ["--output_model_path",
                                  str(tmp_path / "port")])
    want = torch.load(tmp_path / "jax" / "pytorch_model.bin",
                      weights_only=True)
    got = torch.load(tmp_path / "port" / "pytorch_model.bin",
                     weights_only=True)
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    for name in names:
        if name != "pytorch_model.bin":
            assert (tmp_path / "port" / name).read_bytes() == \
                (tmp_path / "jax" / name).read_bytes(), name
