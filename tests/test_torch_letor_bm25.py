"""The port's BM25 first stage and LeToR against the JAX package's:
``bm25_retrieve``'s TREC file and ``coor_ascent``'s (Coor-Ascent and
RankSVM) byte for byte on a tiny corpus at a fixed seed, the native library
built under ``build/native/`` of the checkout, BM25 scores against a numpy
BM25 over the same postings (within 1e-4 relative), a saved index reloaded,
and the copied feature-file, classic-feature and ranker modules."""

import json
import math
import os

import numpy as np
import pytest

from openmatch_tpu_torch.bm25 import engine as pengine
from openmatch_tpu_torch.drivers import bm25_retrieve as pbm25_retrieve
from openmatch_tpu_torch.drivers import coor_ascent as pcoor_ascent
from openmatch_tpu_torch.letor import classic_extractor as pclassic
from openmatch_tpu_torch.letor import coor_ascent as pca
from openmatch_tpu_torch.letor import features as pfeatures
from openmatch_tpu_torch.letor import ranksvm as pranksvm

from openmatch_tpu.drivers import bm25_retrieve as jbm25_retrieve
from openmatch_tpu.drivers import coor_ascent as jcoor_ascent
from openmatch_tpu.letor import classic_extractor as jclassic
from openmatch_tpu.letor import features as jfeatures

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = [f"w{i}" for i in range(60)] + ["running", "runs", "the", "and"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A Zipf-worded jsonl corpus of 80 docs (and a tsv copy) and 12
    queries drawn from docs, in tsv."""
    d = tmp_path_factory.mktemp("bm25")
    rng = np.random.RandomState(3)
    docs = {}
    for i in range(80):
        n = rng.randint(3, 40)
        docs[f"d{i}"] = " ".join(
            WORDS[min(int(x) - 1, len(WORDS) - 1)] for x in rng.zipf(1.3, n))
    with open(d / "corpus.jsonl", "w") as f:
        for i, (did, text) in enumerate(docs.items()):
            f.write(json.dumps({"id": did, "title": f"T{i % 7}",
                                "text": text}) + "\n")
    with open(d / "corpus.tsv", "w") as f:
        for did, text in docs.items():
            f.write(f"{did}\tt\t{text}\n")
    with open(d / "queries.tsv", "w") as f:
        for q in range(12):
            words = docs[f"d{rng.randint(80)}"].split()
            pick = rng.choice(len(words), min(len(words), 4), replace=False)
            f.write(f"q{q}\t{' '.join(words[j] for j in pick)} unknownword\n")
    return d, docs


@pytest.mark.parametrize("corpus_file", ["corpus.jsonl", "corpus.tsv"])
def test_bm25_retrieve_file_equals_jax(corpus, tmp_path, corpus_file):
    d, _ = corpus
    args = ["--corpus_path", str(d / corpus_file), "--query_path",
            str(d / "queries.tsv"), "--topk", "15", "--k1", "0.9", "--b",
            "0.4"]
    jbm25_retrieve.main(args + ["--trec_save_path", str(tmp_path / "j.trec")])
    run = pbm25_retrieve.main(args + ["--trec_save_path",
                                      str(tmp_path / "p.trec")])
    got = (tmp_path / "p.trec").read_bytes()
    assert got == (tmp_path / "j.trec").read_bytes()
    assert len(run) == 12 and got.count(b"\n") > 12

    # a saved index reloads to the same run
    index = str(tmp_path / "index")
    pbm25_retrieve.main(args + ["--index_path", index, "--trec_save_path",
                                str(tmp_path / "p1.trec")])
    pbm25_retrieve.main(["--query_path", str(d / "queries.tsv"), "--topk",
                         "15", "--index_path", index, "--trec_save_path",
                         str(tmp_path / "p2.trec")])
    assert (tmp_path / "p2.trec").read_bytes() == got


def test_library_is_built_in_the_checkout():
    path = pengine._build_library()
    assert os.path.dirname(path) == os.path.join(REPO, "build", "native")
    assert os.path.exists(path) and path.endswith(".so")
    assert pengine._build_library() == path  # found, not rebuilt


def numpy_bm25(docs_tokens, query_tokens, k1, b):
    """BM25 as the native index scores it: idf log(1 + (N - df + 0.5) /
    (df + 0.5)), tf saturation with length normalisation."""
    n = len(docs_tokens)
    avg = sum(map(len, docs_tokens)) / n
    df = {}
    for toks in docs_tokens:
        for t in set(toks):
            df[t] = df.get(t, 0) + 1
    scores = np.zeros(n)
    for i, toks in enumerate(docs_tokens):
        for t in query_tokens:
            tf = toks.count(t)
            if tf == 0:
                continue
            idf = math.log(1 + (n - df[t] + 0.5) / (df[t] + 0.5))
            scores[i] += idf * tf * (k1 + 1) / (
                tf + k1 * (1 - b + b * len(toks) / avg))
    return scores


def test_bm25_scores_match_numpy(corpus):
    _, docs = corpus
    analyzer = pengine.SimpleAnalyzer(stopwords=False, stem=False)
    retriever = pengine.BM25Retriever(k1=0.9, b=0.4, analyzer=analyzer)
    retriever.index_corpus({"id": k, "text": v} for k, v in docs.items())
    tokens = [analyzer(t) for t in docs.values()]
    ids = list(docs)
    for query in ("w1 w2", "w3 w3 w10", "running w0"):
        got = retriever.index.search(query, k=20)
        want = numpy_bm25(tokens, analyzer(query), 0.9, 0.4)
        for did, score in got:
            w = want[ids.index(did)]
            assert abs(score - w) <= 1e-4 * abs(w)
        top = sorted(want, reverse=True)[:len(got)]
        np.testing.assert_allclose([s for _, s in got], top, rtol=1e-4)


def test_save_before_finalize_refused(tmp_path):
    index = pengine.BM25Index()
    index.add("d0", "w1 w2")
    with pytest.raises(RuntimeError, match="finalize"):
        index.save(str(tmp_path / "idx"))


@pytest.fixture(scope="module")
def feature_file(tmp_path_factory):
    """RankLib lines for 10 queries x 8 docs x 5 features, one feature
    informative, graded labels."""
    d = tmp_path_factory.mktemp("letor")
    rng = np.random.RandomState(4)
    lines = []
    for q in range(10):
        for j in range(8):
            label = int(rng.randint(0, 3))
            feats = rng.randn(5)
            feats[2] += label
            lines.append(f"{label} id:q{q} " + " ".join(
                f"{i + 1}:{v}" for i, v in enumerate(feats)) + f" # d{q}_{j}")
    path = d / "features.txt"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize("ranker", ["coor_ascent", "ranksvm"])
def test_coor_ascent_file_equals_jax(feature_file, tmp_path, ranker):
    args = ["--features", feature_file, "--k", "2", "--ranker", ranker,
            "--metric", "ndcg", "--metric_k", "10", "--restarts", "2",
            "--seed", "5"]
    jcoor_ascent.main(args + ["--output_trec", str(tmp_path / "j.trec")])
    folds = pcoor_ascent.main(args + ["--output_trec",
                                      str(tmp_path / "p.trec")])
    assert (tmp_path / "p.trec").read_bytes() \
        == (tmp_path / "j.trec").read_bytes()
    assert len(folds) == 2 and all(0 <= m <= 1 for m in folds)


def test_feature_files_and_rankers(feature_file, tmp_path):
    fs = pfeatures.load_feature_file(feature_file)
    js = jfeatures.load_feature_file(feature_file)
    assert (fs.qids, fs.docids) == (js.qids, js.docids)
    np.testing.assert_array_equal(fs.features, js.features)
    np.testing.assert_array_equal(fs.labels, js.labels)
    pfeatures.save_feature_file(fs, str(tmp_path / "copy.txt"))
    again = pfeatures.load_feature_file(str(tmp_path / "copy.txt"))
    np.testing.assert_array_equal(again.features, fs.features)
    with pytest.raises(ValueError, match="k >= 2"):
        pfeatures.kfold_split(fs, 1)
    ca = pca.CoorAscent(metric_k=10, n_restarts=2, seed=1).fit(fs)
    assert ca.evaluate(fs) >= pca.CoorAscent(metric_k=10).evaluate(
        fs, np.ones(fs.num_features) / fs.num_features)
    ca.save(str(tmp_path / "ca"))
    np.testing.assert_array_equal(
        pca.CoorAscent.load(str(tmp_path / "ca")).weights, ca.weights)
    svm = pranksvm.RankSVM(seed=1).fit(fs)
    svm.save(str(tmp_path / "svm"))
    np.testing.assert_array_equal(
        pranksvm.RankSVM.load(str(tmp_path / "svm")).predict(fs),
        svm.predict(fs))


def test_classic_features_equal_jax(corpus):
    _, docs = corpus
    pstats = pclassic.Corpus(docs).cnt_corpus()
    jstats = jclassic.Corpus(docs).cnt_corpus()
    assert pstats == jstats
    docs_terms, df, total_df, avg_len = pstats
    for query in ("w1 w2", "w3 unknown", ""):
        q_terms, _ = pclassic.Corpus(docs).text2lm(query)
        for did in list(docs)[:10] + ["d0"]:
            got = pclassic.ClassicExtractor(q_terms, docs_terms[did], df,
                                            total_df, avg_len).get_feature()
            want = jclassic.ClassicExtractor(q_terms, docs_terms[did], df,
                                             total_df, avg_len).get_feature()
            assert got.keys() == want.keys()
            for k in want:
                assert got[k] == want[k] or (math.isnan(got[k])
                                             and math.isnan(want[k])), k
