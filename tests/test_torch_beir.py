"""BEIR zero-shot evaluation in the port against the JAX package (CPU):

- ``data/beir.py``'s ``BEIRDataset`` against JAX's on
  ``tests/test_beir.py``'s directory (qrels with a header, queries
  filtered to the qrels' ids, '-' for an empty title): exact;
- ``drivers/retrieve_beir.main`` of both packages on one tiny HF BERT in
  fp32 over a seeded BEIR directory: metrics within 1e-6, and each query's
  TREC ids equal above its tie band (1e-4 x max|score|), the scores within
  that band. Every relevant doc's score is asserted to stand further than
  the band from every other returned doc's, so the metrics cannot hang on
  a tie;
- ``drivers/common.maybe_init_distributed``: (0, 1) on one process; a
  ``WORLD_SIZE`` above 1 makes ``retrieve_beir`` raise before any work
  (it runs on one process, as the JAX driver on one device).
"""

import json

import numpy as np
import pytest
import torch

from openmatch_tpu.data.beir import BEIRDataset as JaxBEIRDataset
from openmatch_tpu_torch.data.beir import BEIRDataset
from openmatch_tpu_torch.drivers import common, retrieve_beir
from openmatch_tpu_torch.utils.trec import load_from_trec

torch.set_num_threads(2)
METRIC_TOL = 1e-6
BAND = 1e-4


@pytest.fixture()
def beir_dir(tmp_path):
    """``tests/test_beir.py``'s directory."""
    d = tmp_path / "scifact"
    (d / "qrels").mkdir(parents=True)
    corpus = [
        {"_id": "d1", "title": "virus study", "text": "the virus spread"},
        {"_id": "d2", "title": "", "text": "cats and dogs"},
        {"_id": "d3", "title": "cells", "text": "cell biology basics"},
    ]
    (d / "corpus.jsonl").write_text(
        "\n".join(json.dumps(r) for r in corpus) + "\n")
    queries = [
        {"_id": "q1", "text": "virus spread"},
        {"_id": "q2", "text": "unrelated question"},
        {"_id": "q3", "text": "cell biology"},
    ]
    (d / "queries.jsonl").write_text(
        "\n".join(json.dumps(r) for r in queries) + "\n")
    (d / "qrels" / "test.tsv").write_text(
        "query-id\tcorpus-id\tscore\nq1\td1\t1\nq3\td3\t2\n")
    return str(d)


def test_beir_dataset_matches_jax(beir_dir):
    mine, theirs = BEIRDataset(beir_dir), JaxBEIRDataset(beir_dir)
    assert mine.qrels == theirs.qrels == {"q1": {"d1": 1}, "q3": {"d3": 2}}
    assert list(mine.iter_queries()) == list(theirs.iter_queries())
    assert [q["id"] for q in mine.iter_queries()] == ["q1", "q3"]
    docs = list(mine.iter_corpus())
    assert docs == list(theirs.iter_corpus())
    assert docs[1]["title"] == "-"


WORDS = [f"w{i}" for i in range(60)]


@pytest.fixture(scope="module")
def beir_run_inputs(tmp_path_factory):
    """A tiny HF BERT (fp32) with its tokenizer, and a seeded BEIR directory
    of 40 docs and 12 queries, 8 of them in the qrels."""
    from transformers import BertConfig as HFBertConfig
    from transformers import BertModel, BertTokenizerFast

    root = tmp_path_factory.mktemp("beir_run")
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "title", "text",
             ":", "-"] + WORDS
    (root / "vocab.txt").write_text("\n".join(vocab))
    tok = BertTokenizerFast(vocab_file=str(root / "vocab.txt"))
    torch.manual_seed(0)
    hf = BertModel(HFBertConfig(
        vocab_size=len(vocab), hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=64))
    hf.save_pretrained(str(root / "hf"))
    tok.save_pretrained(str(root / "hf"))

    rng = np.random.RandomState(3)
    d = root / "data"
    (d / "qrels").mkdir(parents=True)
    texts = [list(rng.choice(WORDS, rng.randint(4, 12))) for _ in range(40)]
    with open(d / "corpus.jsonl", "w") as f:
        for i, t in enumerate(texts):
            title = "" if i % 7 == 0 else " ".join(rng.choice(WORDS, 2))
            f.write(json.dumps({"_id": f"d{i}", "title": title,
                                "text": " ".join(t)}) + "\n")
    rels = {f"q{j}": sorted(set(rng.randint(0, 40, 1 + j % 2)))
            for j in range(8)}
    with open(d / "queries.jsonl", "w") as f:
        for j in range(12):
            src = texts[rels[f"q{j}"][0]] if j < 8 else texts[j]
            f.write(json.dumps({"_id": f"q{j}", "text": " ".join(
                rng.choice(src, 3))}) + "\n")
    with open(d / "qrels" / "test.tsv", "w") as f:
        f.write("query-id\tcorpus-id\tscore\n")
        for q, docs in rels.items():
            for doc in docs:
                f.write(f"{q}\td{doc}\t1\n")
    return root, tok


def test_retrieve_beir_matches_jax(beir_run_inputs, monkeypatch):
    from openmatch_tpu.drivers import retrieve_beir as jretrieve_beir

    root, tok = beir_run_inputs
    # the JAX driver's setup_logging: CPU, and no compilation cache
    monkeypatch.setenv("OPENMATCH_FORCE_CPU", "1")
    args = ["--model_name_or_path", str(root / "hf"),
            "--data_dir", str(root / "data"), "--q_max_len", "16",
            "--p_max_len", "32", "--per_device_eval_batch_size", "8",
            "--dtype", "float32", "--retrieve_depth", "10",
            "--pooling", "mean"]
    want = jretrieve_beir.main(args + ["--trec_save_path",
                                       str(root / "jax.trec")])
    got = retrieve_beir.main(args + ["--trec_save_path",
                                     str(root / "port.trec"),
                                     "--device", "cpu"], tokenizer=tok)
    assert set(got) == set(want) == {"ndcg_cut_10", "recall_100"}
    for name in want:
        assert got[name] == pytest.approx(want[name], abs=METRIC_TOL)
    mine = load_from_trec(str(root / "port.trec"), as_list=True)
    theirs = load_from_trec(str(root / "jax.trec"), as_list=True)
    qrels = BEIRDataset(str(root / "data")).qrels
    assert list(mine) == list(theirs) == list(qrels)
    for qid in qrels:
        s_m = np.array([s for _, s in mine[qid]])
        s_t = np.array([s for _, s in theirs[qid]])
        tol = BAND * np.abs(s_t).max()
        assert len(s_m) == len(s_t) == 10
        assert np.abs(s_m - s_t).max() <= tol
        band = s_t[-1] + tol
        above_m = {d for d, s in mine[qid] if s > band}
        above_t = {d for d, s in theirs[qid] if s > band}
        assert above_m <= {d for d, _ in theirs[qid]}
        assert above_t <= {d for d, _ in mine[qid]}
        for d, s in mine[qid]:  # no relevant doc ties with another
            if d in qrels[qid]:
                others = [x for e, x in mine[qid] if e != d]
                assert min(abs(x - s) for x in others) > tol


def test_maybe_init_distributed(monkeypatch, beir_run_inputs):
    """One process is (0, 1); in a 2-rank gloo group each rank gets (rank,
    2); a launcher's WORLD_SIZE=2 without its rendezvous address raises
    (the rank cannot join). retrieve_beir runs on one rank only, as the
    JAX driver runs on one device."""
    import torch_ranks

    from openmatch_tpu_torch.parallel.mesh import spawn_ranks

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert common.maybe_init_distributed("cpu") == (0, 1)
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert common.maybe_init_distributed("cpu") == (0, 1)
    monkeypatch.delenv("WORLD_SIZE")
    assert spawn_ranks(torch_ranks.maybe_init_rank, 2,
                       device="cpu", timeout_s=120) == [(0, 2), (1, 2)]
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        common.maybe_init_distributed("cpu")
    root, tok = beir_run_inputs
    with pytest.raises(NotImplementedError, match="runs on one process"):
        retrieve_beir.main(["--model_name_or_path", "/nonexistent",
                            "--data_dir", str(root / "data"),
                            "--device", "cpu"], tokenizer=tok)


def test_retrieve_beir_defaults_to_the_card(beir_run_inputs):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    root, tok = beir_run_inputs
    with pytest.raises(RuntimeError, match="CUDA"):
        retrieve_beir.main(["--model_name_or_path", str(root / "hf"),
                            "--data_dir", str(root / "data")], tokenizer=tok)
