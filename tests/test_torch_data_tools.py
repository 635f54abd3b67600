"""The port's data tools against the JAX package's (CPU, a BERT tokenizer
built here from a local vocab):

- ``data/preprocessor.py`` against ``openmatch_tpu/data/preprocessor.py``:
  the readers, ``TrainPreProcessor`` (with and without templates),
  ``CollectionPreProcessor``, ``load_ranking_negatives`` (seeded, with a
  run query that has no qrels) and ``ShardedJsonlWriter``: equal values and
  byte-equal shards;
- the tool twins under ``openmatch_tpu_torch/scripts`` against the JAX
  scripts under ``scripts/``, each run in its own process on the same tiny
  MS MARCO / DPR files: ``msmarco.build_train`` and ``msmarco.build_hn``
  shards and ``nq_dpr.build_train``'s jsonl byte-equal (the twins run both
  as ``python -m`` with ``--tokenizer_name`` and through
  ``main(argv, tokenizer=...)``), and ``split_embeddings``' npz arrays and
  ids equal.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from openmatch_tpu.data import preprocessor as jpre
from openmatch_tpu_torch.data import preprocessor as pre
from openmatch_tpu_torch.retriever.encoder import (load_embeddings,
                                                   save_embeddings)
from openmatch_tpu_torch.scripts import split_embeddings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ["alpha", "beta", "gamma", "delta", "eps", "zeta", "eta", "theta",
         "iota", "kappa", "lambda", "mu"]


@pytest.fixture(scope="module")
def tok_dir(tmp_path_factory):
    from transformers import BertTokenizerFast

    d = tmp_path_factory.mktemp("tok")
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS
    (d / "vocab.txt").write_text("\n".join(vocab))
    BertTokenizerFast(vocab_file=str(d / "vocab.txt")).save_pretrained(
        str(d / "hf"))
    return str(d / "hf")


@pytest.fixture(scope="module")
def tokenizer(tok_dir):
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(tok_dir, use_fast=True)


@pytest.fixture(scope="module")
def msmarco(tmp_path_factory):
    """queries.tsv, qrels.tsv (MS MARCO), collection.tsv, a negatives tsv
    and a TREC run, seeded: 7 queries over 30 passages."""
    rng = np.random.RandomState(0)
    d = tmp_path_factory.mktemp("msmarco")

    def words(n):
        return " ".join(rng.choice(WORDS, n))

    with open(d / "collection.tsv", "w") as f:
        for i in range(30):
            title = "" if i % 5 == 0 else words(2)
            f.write(f"p{i}\t{title}\t{words(rng.randint(3, 30))}\n")
    with open(d / "queries.tsv", "w") as f:
        for j in range(7):
            f.write(f"q{j}\t{words(rng.randint(2, 8))}\n")
    qrels = {f"q{j}": [f"p{x}" for x in sorted(set(rng.randint(0, 30, 2)))]
             for j in range(6)}  # q6 has a run but no qrels
    with open(d / "qrels.tsv", "w") as f:
        for q, ps in qrels.items():
            for p in ps:
                f.write(f"{q}\t0\t{p}\t1\n")
    with open(d / "negatives.tsv", "w") as f:
        for q in qrels:
            f.write(f"{q}\t" + ",".join(f"p{x}" for x in rng.permutation(
                30)[:12]) + "\n")
    with open(d / "run.trec", "w") as f:
        for j in range(7):
            for r, x in enumerate(rng.permutation(30)[:15]):
                f.write(f"q{j} Q0 p{x} {r + 1} {20.0 - r} run\n")
    return d


def test_readers_match_jax(msmarco):
    for name, path in (("read_queries", "queries.tsv"),
                       ("read_qrel", "qrels.tsv"),
                       ("read_collection_tsv", "collection.tsv")):
        got = getattr(pre, name)(str(msmarco / path))
        assert got == getattr(jpre, name)(str(msmarco / path)) and got
    cols = ("text_id", "text")
    assert pre.read_collection_tsv(str(msmarco / "collection.tsv"), cols) \
        == jpre.read_collection_tsv(str(msmarco / "collection.tsv"), cols)


@pytest.mark.parametrize("templates", [
    {}, {"doc_template": "<title> <text>", "query_template": "<text>"},
    {"doc_template": "<text> <missing>", "allow_not_found": True}])
def test_train_preprocessor_matches_jax(msmarco, tokenizer, templates):
    kw = dict(queries=pre.read_queries(str(msmarco / "queries.tsv")),
              collection=pre.read_collection_tsv(
                  str(msmarco / "collection.tsv")),
              tokenizer=tokenizer, doc_max_len=9, query_max_len=4,
              **templates)
    mine, theirs = pre.TrainPreProcessor(**kw), jpre.TrainPreProcessor(**kw)
    for item in (("q0", ["p1"], ["p5", "p7"]), ("q3", ["p0", "p2"], [])):
        assert mine.process_one(item) == theirs.process_one(item)
    line = "p9\ttitle words\tbody words here\n"
    for n in (4, 128):
        assert pre.CollectionPreProcessor(tokenizer, max_length=n)\
            .process_line(line) == jpre.CollectionPreProcessor(
                tokenizer, max_length=n).process_line(line)


@pytest.mark.parametrize("n_sample,depth,seed", [(3, 8, 0), (20, 5, 7),
                                                 (4, 200, None)])
def test_ranking_negatives_match_jax(msmarco, n_sample, depth, seed):
    rel = pre.read_qrel(str(msmarco / "qrels.tsv"))
    run = str(msmarco / "run.trec")
    got = list(pre.load_ranking_negatives(run, rel, n_sample, depth, seed))
    want = list(jpre.load_ranking_negatives(run, rel, n_sample, depth, seed))
    if seed is not None:
        assert got == want
    assert [g[0] for g in got] == [w[0] for w in want] == sorted(rel)
    for q, positives, negs in got:
        assert len(negs) <= n_sample and not set(negs) & set(positives)


def test_sharded_writer_matches_jax(tmp_path):
    lines = [json.dumps({"i": i}) for i in range(7)]
    for lib, name in ((pre, "port"), (jpre, "jax")):
        w = lib.ShardedJsonlWriter(str(tmp_path / name), 3, suffix=".hn")
        for line in lines:
            w.write(line)
        w.close()
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) == [
        "split00.hn.jsonl", "split01.hn.jsonl", "split02.hn.jsonl"]
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() \
            == (tmp_path / "jax" / n).read_bytes()


# ---- the tool twins, each in its own process ------------------------------


def run(argv):
    # transformers is imported for its tokenizers alone: without the
    # USE_* switches its import loads every framework it finds, which
    # takes longer than the tool's run
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""),
               TOKENIZERS_PARALLELISM="false", USE_TORCH="0", USE_TF="0",
               USE_FLAX="0")
    proc = subprocess.run([sys.executable, *argv], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def with_tokenizer(module, argv, tok_dir):
    """``module.main(argv, tokenizer=...)`` in a fresh process, the
    tokenizer built by the caller."""
    return ["-c", "import sys; from transformers import AutoTokenizer; "
            f"from {module} import main; "
            f"main(sys.argv[1:], tokenizer=AutoTokenizer.from_pretrained("
            f"{tok_dir!r}, use_fast=True))", *argv]


def same_files(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    for n in names:
        with open(os.path.join(a, n), "rb") as fa, \
                open(os.path.join(b, n), "rb") as fb:
            assert fa.read() == fb.read(), n
    return names


@pytest.mark.parametrize("tool", ["build_train", "build_hn"])
def test_msmarco_tools_match_jax(msmarco, tok_dir, tmp_path, tool):
    common = ["--tokenizer_name", tok_dir,
              "--qrels", str(msmarco / "qrels.tsv"),
              "--queries", str(msmarco / "queries.tsv"),
              "--collection", str(msmarco / "collection.tsv"),
              "--truncate", "12", "--n_sample", "3", "--mp_chunk_size", "2",
              "--shard_size", "4", "--seed", "5",
              "--doc_template", "<title> <text>"]
    common += ["--negative_file", str(msmarco / "negatives.tsv")] \
        if tool == "build_train" else ["--hn_file", str(msmarco / "run.trec"),
                                       "--depth", "6"]
    module = f"openmatch_tpu_torch.scripts.msmarco.{tool}"
    run([f"scripts/msmarco/{tool}.py", *common, "--save_to",
         str(tmp_path / "jax")])
    run(["-m", module, *common, "--save_to", str(tmp_path / "port")])
    run(with_tokenizer(module, [*common, "--save_to",
                                str(tmp_path / "port_tok")], tok_dir))
    names = same_files(tmp_path / "port", tmp_path / "jax")
    same_files(tmp_path / "port_tok", tmp_path / "jax")
    suffix = ".hn.jsonl" if tool == "build_hn" else ".jsonl"
    assert names == [f"split{i:02d}{suffix}" for i in range(2)]


def test_nq_tool_matches_jax(tok_dir, tmp_path):
    rng = np.random.RandomState(1)

    def ctx():
        return {"title": " ".join(rng.choice(WORDS, 2)),
                "text": " ".join(rng.choice(WORDS, rng.randint(3, 40)))}

    data = [{"question": " ".join(rng.choice(WORDS, 4)),
             "positive_ctxs": [ctx() for _ in range(i % 3)],
             "hard_negative_ctxs": [ctx() for _ in range(i % 4)]}
            for i in range(9)]
    (tmp_path / "nq.json").write_text(json.dumps(data))
    common = ["--input", str(tmp_path / "nq.json"), "--tokenizer", tok_dir,
              "--minimum-negatives", "2", "--p_max_len", "16"]
    module = "openmatch_tpu_torch.scripts.nq_dpr.build_train"
    want = run(["scripts/nq-dpr/build_train.py", *common, "--output",
                str(tmp_path / "jax" / "train.jsonl")])
    got = run(["-m", module, *common, "--output",
               str(tmp_path / "port" / "train.jsonl")])
    run(with_tokenizer(module, [*common, "--output",
                                str(tmp_path / "tok" / "train.jsonl")],
                       tok_dir))
    same_files(tmp_path / "port", tmp_path / "jax")
    same_files(tmp_path / "tok", tmp_path / "jax")
    assert got.replace("port", "jax") == want
    kept = (tmp_path / "port" / "train.jsonl").read_text().splitlines()
    assert 0 < len(kept) < len(data)


def test_split_embeddings_matches_jax(tmp_path, capsys):
    rng = np.random.RandomState(2)
    emb = rng.randn(11, 8).astype(np.float16)
    src = str(tmp_path / "embeddings.corpus.rank.0.npz")
    save_embeddings(emb, [f"d{i}" for i in range(11)], src)
    args = ["--input_embedding", src, "--num_splits", "3"]
    run(["scripts/split_embeddings.py", *args, "--output_dir",
         str(tmp_path / "jax")])
    split_embeddings.main([*args, "--output_dir", str(tmp_path / "port")])
    assert "rows" in capsys.readouterr().out
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) == [
        f"embeddings.corpus.rank.{i}.npz" for i in range(3)]
    rows = 0
    for n in names:
        got, got_ids = load_embeddings(str(tmp_path / "port" / n))
        want, want_ids = load_embeddings(str(tmp_path / "jax" / n))
        assert got.dtype == want.dtype == np.float16
        np.testing.assert_array_equal(got, want)
        assert got_ids == want_ids
        rows += len(got_ids)
    assert rows == 11
