"""``evaluate``, successive retrieval and the whole main path of the port
against the JAX package (CPU):

- ``evaluate_run``, ``eval_mrr``, ``Metric`` and the ``evaluate`` driver's
  printed lines on a qrels/run pair with score ties, graded and negative
  labels, and queries only one side knows: exact;
- ``SuccessiveRetriever`` over 3 shards against JAX's (the same docs above
  each query's tie band, scores within 1e-4 x max|score|) and against the
  port's resident ``Retriever`` (the same);
- ``train_dr -> build_index -> retrieve -> successive_retrieve -> evaluate``
  through the port's drivers with ``--device cpu`` and ``tokenizer=``: the
  loss trace within 1e-4 (relative) of the JAX ``train_dr`` driver's on the
  same HF directory and data (``--negatives_x_device``; the JAX driver's
  batch is ``per_device_train_batch_size`` x the 8 CPU devices of the test
  mesh, so the port's per-device batch is 8 times larger), and
  ``evaluate``'s figures equal to the JAX driver's on the same run files.
"""

import json
import os

import numpy as np
import pytest
import torch

from openmatch_tpu.config import DataArguments as JaxDataArguments
from openmatch_tpu.config import InferenceArguments as JaxInferenceArguments
from openmatch_tpu.drivers import evaluate as jevaluate
from openmatch_tpu.retriever.retriever import \
    SuccessiveRetriever as JaxSuccessiveRetriever
from openmatch_tpu.utils import metrics as jmetrics
from openmatch_tpu_torch.config import DataArguments, InferenceArguments
from openmatch_tpu_torch.drivers import evaluate
from openmatch_tpu_torch.retriever.encoder import save_embeddings, shard_path
from openmatch_tpu_torch.retriever.retriever import (Retriever,
                                                     SuccessiveRetriever)
from openmatch_tpu_torch.utils import metrics
from openmatch_tpu_torch.utils.trec import load_from_trec

torch.set_num_threads(2)
REL = 1e-4

QRELS = """q1 0 d1 1
q1 0 d3 2
q2 0 d2 1
q2 0 d9 0
q3 0 d4 1
q5 0 d7 -1
"""
# ties at q1 (d2/d3, broken by doc id), a run-only query (q4), a qrels-only
# query (q3), and a query whose only label is negative (q5)
RUN = """q1 Q0 d2 1 3.5 r
q1 Q0 d3 2 3.5 r
q1 Q0 d1 3 2.0 r
q1 Q0 d8 4 1.0 r
q2 Q0 d5 1 9.0 r
q2 Q0 d6 2 8.0 r
q2 Q0 d2 3 8.0 r
q4 Q0 d1 1 1.0 r
q5 Q0 d7 1 0.5 r
"""
MEASURES = ["map", "ndcg_cut_10", "ndcg_cut.3", "recall_100", "recall.2",
            "p_10", "p.2", "mrr", "recip_rank", "mrr_cut_1", "err_20"]


@pytest.fixture()
def files(tmp_path):
    (tmp_path / "qrels").write_text(QRELS)
    (tmp_path / "run").write_text(RUN)
    return str(tmp_path / "qrels"), str(tmp_path / "run")


def test_metrics_match_jax(files):
    qrel_path, run_path = files
    q, r = metrics.load_qrels(qrel_path), metrics.load_run(run_path)
    assert q == jmetrics.load_qrels(qrel_path)
    assert r == jmetrics.load_run(run_path)
    for skip in (False, True):
        assert metrics.evaluate_run(q, r, MEASURES, skip) \
            == jmetrics.evaluate_run(q, r, MEASURES, skip)
    for cutoff in (None, 1, 2, 10):
        assert metrics.eval_mrr(q, r, cutoff) == jmetrics.eval_mrr(q, r,
                                                                   cutoff)
    for m in ("ndcg_cut_10", "map", "recall_100"):
        assert metrics.Metric().get_metric(qrel_path, run_path, m) \
            == jmetrics.Metric().get_metric(qrel_path, run_path, m)
    assert metrics.Metric().get_mrr(qrel_path, run_path) \
        == jmetrics.Metric().get_mrr(qrel_path, run_path)
    with pytest.raises(ValueError, match="Unsupported measure"):
        metrics.evaluate_run(q, r, ["bogus_5"])


@pytest.mark.parametrize("flags", [[], ["-m", "mrr_cut.10", "-q"],
                                   ["-m", "mrr"], ["-m", "ndcg_cut.10"],
                                   ["-m", "recall.100"]])
def test_evaluate_driver_prints_what_jax_prints(files, capsys, flags):
    argv = flags + list(files)
    got = evaluate.main(argv)
    got_out = capsys.readouterr().out
    want = jevaluate.main(argv)
    want_out = capsys.readouterr().out
    assert got == want
    assert got_out == want_out and got_out


# ---- successive retrieval -------------------------------------------------


def same_above_band(got, want):
    """Two runs {qid: {doc: score}}: scores within REL x max|score| and
    each holds every doc the other scores above the last score's tie band."""
    assert set(got) == set(want)
    for qid in want:
        w, g = want[qid], got[qid]
        tol = REL * max(abs(s) for s in w.values())
        band = min(w.values()) + tol
        for doc in set(g) & set(w):
            assert abs(g[doc] - w[doc]) <= tol
        assert {d for d, s in w.items() if s > band} <= set(g)
        assert {d for d, s in g.items() if s > band} <= set(w)


@pytest.fixture()
def shards(tmp_path):
    rng = np.random.default_rng(0)
    d = tmp_path / "emb"
    for i, n in enumerate((40, 13, 57)):
        emb = rng.standard_normal((n, 16)).astype(np.float16)
        save_embeddings(emb, [f"s{i}d{j}" for j in range(n)],
                        shard_path(str(d), "corpus", i), num_shards=3)
    q = rng.standard_normal((5, 16)).astype(np.float32)
    return str(d), q, [f"q{i}" for i in range(5)]


def test_successive_retriever_matches_jax_and_resident(shards):
    emb_dir, q, qids = shards
    mine = SuccessiveRetriever.from_embeddings(
        None, DataArguments(), InferenceArguments(encoded_save_path=emb_dir),
        0, device="cpu")
    got = mine.search_partitions(q, qids, topk=20)
    theirs = JaxSuccessiveRetriever.from_embeddings(
        None, None, JaxDataArguments(),
        JaxInferenceArguments(encoded_save_path=emb_dir), 0)
    want = theirs.search_partitions(q, qids, topk=20)
    assert all(len(v) == 20 for v in got.values())
    same_above_band(got, want)
    resident = Retriever.from_embeddings(
        None, DataArguments(),
        InferenceArguments(encoded_save_path=emb_dir, search_method="plain"),
        0, device="cpu")
    same_above_band(got, resident.search(q, qids, topk=20))


# ---- the main path through the drivers ------------------------------------

WORDS = [f"w{i}" for i in range(40)]
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS


def words(rng, n):
    return " ".join(rng.choice(WORDS, n))


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """A tiny HF BERT with its tokenizer (dropout 0, so both packages' loss
    traces are deterministic), training data, a corpus, queries, qrels."""
    import transformers as tf

    root = tmp_path_factory.mktemp("chain")
    (root / "vocab.txt").write_text("\n".join(VOCAB))
    tok = tf.BertTokenizerFast(vocab_file=str(root / "vocab.txt"))
    torch.manual_seed(0)
    hf = tf.BertModel(tf.BertConfig(
        vocab_size=len(VOCAB), hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=128,
        max_position_embeddings=40, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0))
    hf.save_pretrained(str(root / "hf"), safe_serialization=False)
    tok.save_pretrained(str(root / "hf"))
    rng = np.random.RandomState(1)
    docs = [words(rng, rng.randint(4, 12)) for _ in range(60)]
    with open(root / "corpus.jsonl", "w") as f:
        for i, t in enumerate(docs):
            f.write(json.dumps({"id": f"d{i}", "title": "", "text": t}) + "\n")
    with open(root / "train.jsonl", "w") as f:
        for i in range(32):
            pos = int(rng.randint(60))
            q = " ".join(docs[pos].split()[:3])
            f.write(json.dumps({
                "query": q, "positives": [docs[pos]],
                "negatives": [docs[int(j)] for j in rng.randint(0, 60, 3)]})
                + "\n")
    with open(root / "queries.jsonl", "w") as f, open(root / "qrels",
                                                      "w") as g:
        for i in range(12):
            pos = int(rng.randint(60))
            q = " ".join(docs[pos].split()[:3])
            f.write(json.dumps({"id": f"q{i}", "text": q}) + "\n")
            g.write(f"q{i} 0 d{pos} 1\n")
    return root, tok


def train_flags(root, out, per_device):
    return ["--model_name_or_path", str(root / "hf"),
            "--train_path", str(root / "train.jsonl"),
            "--output_dir", str(out), "--dtype", "float32",
            "--per_device_train_batch_size", str(per_device),
            "--train_n_passages", "2", "--q_max_len", "8", "--p_max_len",
            "16", "--max_steps", "4", "--logging_steps", "1",
            "--learning_rate", "1e-4", "--save_steps", "2",
            "--negatives_x_device"]


def jax_losses(root, out, monkeypatch):
    from openmatch_tpu.drivers import train_dr as jtrain_dr
    from openmatch_tpu.train import dr_trainer as jdr_trainer

    seen = []
    real = jdr_trainer.DRTrainer.train

    def train(self, data_iter, eval_fn=None):
        result = real(self, data_iter, eval_fn)
        seen.append(result)
        return result

    monkeypatch.setattr(jdr_trainer.DRTrainer, "train", train)
    monkeypatch.setenv("OPENMATCH_FORCE_CPU", "1")  # no compilation cache
    jtrain_dr.main(train_flags(root, out, 1))
    return seen[0]["losses"]


def test_main_path_through_the_drivers(workspace, tmp_path, monkeypatch,
                                       capsys):
    from openmatch_tpu_torch.drivers import (build_index, retrieve,
                                             successive_retrieve, train_dr)

    root, tok = workspace
    out = tmp_path / "model"
    result = train_dr.main(["--device", "cpu"]
                           + train_flags(root, out, 8), tokenizer=tok)
    losses = result["losses"]
    assert result["final_step"] == 4 and len(losses) == 4
    assert np.isfinite(losses).all()
    assert sorted(os.listdir(out)) == sorted(
        ["checkpoint-2", "checkpoint-4", "openmatch_config.json",
         "params.msgpack", "special_tokens_map.json", "tokenizer.json",
         "tokenizer_config.json", "vocab.txt"])
    want = jax_losses(root, tmp_path / "jax_model", monkeypatch)
    np.testing.assert_allclose(losses, want, rtol=REL)

    emb = tmp_path / "emb"
    common = ["--device", "cpu", "--model_name_or_path", str(out),
              "--dtype", "float32", "--q_max_len", "8", "--p_max_len", "16",
              "--encoded_save_path", str(emb), "--doc_template", "<text>",
              "--per_device_eval_batch_size", "16"]
    for i in range(3):
        build_index.main(common + ["--corpus_path", str(root / "corpus.jsonl"),
                                   "--encode_num_shard", "3",
                                   "--encode_shard_index", str(i)],
                         tokenizer=tok)
    runs = {}
    for name, driver in (("retrieve", retrieve),
                         ("successive", successive_retrieve)):
        runs[name] = str(tmp_path / f"{name}.trec")
        driver.main(common + ["--query_path", str(root / "queries.jsonl"),
                              "--trec_save_path", runs[name],
                              "--retrieve_depth", "10"], tokenizer=tok)
    got, want = (load_from_trec(runs[n]) for n in ("successive", "retrieve"))
    assert len(want) == 12 and all(len(v) == 10 for v in want.values())
    same_above_band(got, want)
    capsys.readouterr()
    mrr = evaluate.main(["-m", "mrr_cut.10", str(root / "qrels"),
                         runs["retrieve"]])
    assert mrr == jevaluate.main(["-m", "mrr_cut.10", str(root / "qrels"),
                                  runs["retrieve"]])
    assert 0.0 <= mrr <= 1.0
