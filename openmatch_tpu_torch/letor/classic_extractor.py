"""Classic IR feature extraction for learning-to-rank.

The port's own copy of ``openmatch_tpu/letor/classic_extractor.py``.

Reference: OpenMatch v1's ``OpenMatch/extractors/classic_extractor.py``:
the 10 features (lm, lm_dir, lm_jm, lm_twoway, bm25, coordinate, cosine,
tf_idf, bool_and, bool_or) feeding the Coor-Ascent/RankSVM ensembles whose
numbers the v1 README publishes. Formulas are replicated exactly, including
the reference's quirks (e.g. bm25 dots the raw odds-ratio vector rather
than the normalized query vector, :113), because the published results
were produced with exactly these features.

Tokenization drops non-alphanumerics and lowercases; stopword removal is
optional (the reference loads NLTK stopwords for Corpus but text2lm does
not apply them — we mirror that).
"""

from __future__ import annotations

import math
import re
from typing import Dict, Tuple

import numpy as np

FEATURE_NAMES = [
    "lm", "lm_dir", "lm_jm", "lm_twoway", "bm25",
    "coordinate", "cosine", "tf_idf", "bool_and", "bool_or",
]


class ClassicExtractor:
    def __init__(
        self,
        query_terms: Dict[str, int],
        doc_terms: Dict[str, int],
        df: Dict[str, int],
        total_df: int = None,
        avg_doc_len: float = None,
    ):
        query_tf, query_df, doc_tf = [], [], []
        for term, tf in query_terms.items():
            query_tf.append(tf)
            query_df.append(df.get(term, 0))
            doc_tf.append(doc_terms.get(term, 0))
        self.query_tf = np.asarray(query_tf, np.float64)
        self.query_df = np.asarray(query_df, np.float64)
        self.doc_tf = np.asarray(doc_tf, np.float64)
        self.doc_len = float(sum(doc_terms.values()))
        self.total_df = total_df
        self.avg_doc_len = avg_doc_len

        self.k1 = 1.2
        self.b = 0.75
        self.dir_mu = 2500
        self.min_tf = 0.1
        self.jm_lambda = 0.4
        self.min_score = 1e-10

    def get_feature(self) -> Dict[str, float]:
        return {name: float(getattr(self, name)()) for name in FEATURE_NAMES}

    def lm(self):
        if self.doc_len == 0:
            return np.log(self.min_score)
        v_tf = np.maximum(self.doc_tf, self.min_tf) / self.doc_len
        v_tf = np.maximum(v_tf, self.min_score)
        return np.log(v_tf).dot(self.query_tf)

    def lm_dir(self):
        if self.doc_len == 0:
            return np.log(self.min_score)
        v_q = self.query_tf / np.sum(self.query_tf)
        v_mid = (self.doc_tf + self.dir_mu * (self.query_df / self.total_df)) / (
            self.doc_len + self.dir_mu
        )
        return np.log(np.maximum(v_mid, self.min_score)).dot(v_q)

    def lm_jm(self):
        if self.doc_len == 0:
            return np.log(self.min_score)
        v_mid = (
            self.doc_tf / self.doc_len * (1 - self.jm_lambda)
            + self.jm_lambda * self.query_df / self.total_df
        )
        return np.log(np.maximum(v_mid, self.min_score)).dot(self.query_tf)

    def lm_twoway(self):
        if self.doc_len == 0:
            return np.log(self.min_score)
        v_mid = (self.doc_tf + self.dir_mu * (self.query_df / self.total_df)) / (
            self.doc_len + self.dir_mu
        )
        v_mid = v_mid * (1 - self.jm_lambda) + self.jm_lambda * self.query_df / self.total_df
        return np.log(np.maximum(v_mid, self.min_score)).dot(self.query_tf)

    def bm25(self):
        if self.doc_len == 0:
            return 0.0
        v_tf_part = self.doc_tf * (self.k1 + 1) / (
            self.doc_tf + self.k1 * (1 - self.b + self.b * self.doc_len / self.avg_doc_len)
        )
        v_mid = (self.total_df - self.query_df + 0.5) / (self.query_df + 0.5)
        v_mid = np.maximum(v_mid, 1.0)
        v_idf_q = np.maximum(np.log(v_mid), 0)
        # reference quirk: dots v_mid (odds ratio), not the query vector
        score = v_mid.dot(v_tf_part * v_idf_q)
        return np.log(max(score, 1.0))

    def cosine(self):
        if self.doc_len == 0 or self.doc_tf.sum() == 0:
            return 0.0
        v_q = self.query_tf / float(np.sum(self.query_tf))
        v_d = self.doc_tf / float(self.doc_len)
        denom = np.linalg.norm(v_q) * np.linalg.norm(v_d)
        if denom == 0:
            return 0.0
        score = 1.0 - float(v_q.dot(v_d) / denom)  # scipy cosine *distance*
        return 0.0 if math.isnan(score) else score

    def coordinate(self):
        return float((self.doc_tf > 0).sum())

    def bool_and(self):
        return 1.0 if self.coordinate() == len(self.query_tf) else 0.0

    def bool_or(self):
        return min(1.0, self.coordinate())

    def tf_idf(self):
        if self.doc_len == 0:
            return 0.0
        normed_idf = np.log(1 + self.total_df / np.maximum(self.query_df, 1))
        normed_tf = self.doc_tf / self.doc_len
        return normed_idf.dot(normed_tf)


class Corpus:
    """Corpus statistics: term counts, document frequencies, lengths
    (reference classic_extractor.py:149-184)."""

    _drop = re.compile(r"[^a-z0-9\s]+")
    _spaces = re.compile(r"\s+")

    def __init__(self, docs: Dict[str, str]):
        self.docs = docs

    def text2lm(self, text: str) -> Tuple[Dict[str, int], int]:
        tokens = self._spaces.sub(" ", self._drop.sub(" ", text.lower())).strip().split()
        d: Dict[str, int] = {}
        for token in tokens:
            d[token] = d.get(token, 0) + 1
        return d, len(tokens)

    def cnt_corpus(self):
        docs_terms: Dict[str, Dict[str, int]] = {}
        df: Dict[str, int] = {}
        total_df = len(self.docs)
        total_doc_len = 0
        for doc_id, text in self.docs.items():
            doc_terms, doc_len = self.text2lm(text)
            docs_terms[doc_id] = doc_terms
            for term in doc_terms:
                df[term] = df.get(term, 0) + 1
            total_doc_len += doc_len
        avg_doc_len = total_doc_len / total_df if total_df else 0.0
        return docs_terms, df, total_df, avg_doc_len
