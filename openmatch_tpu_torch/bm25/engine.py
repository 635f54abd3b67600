"""BM25 first-stage retrieval over the native C++ inverted index.

The port's own copy of ``openmatch_tpu/bm25/engine.py``. The index core is
``native/bm25/bm25_index.cpp``, the same source the JAX package builds,
compiled with g++ at first use into ``build/native/`` of this checkout
(named by a hash of the source; published through a per-process temporary
file and ``os.replace``, so concurrent first uses are safe). A failed build
raises; there is no Python fallback scorer. This module adds the analyzer
(lowercase alphanumeric tokens, optional NLTK stopwords and Porter
stemming), the term-id vocabulary and the corpus/query drivers.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
_SRC = os.path.join(_REPO, "native", "bm25", "bm25_index.cpp")
BUILD_DIR = os.path.join(_REPO, "build", "native")


def _build_library() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, f"libbm25_{digest}.so")
    if not os.path.exists(lib_path):
        # a per-process temporary name: two processes building at once do
        # not write the same file, and os.replace publishes atomically
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        proc = subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             _SRC, "-o", tmp], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {_SRC}:\n{proc.stderr}")
        os.replace(tmp, lib_path)
    return lib_path


_lib = None


def _load_lib():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(_build_library())
        lib.bm25_create.restype = ctypes.c_void_p
        lib.bm25_create.argtypes = [ctypes.c_float, ctypes.c_float]
        lib.bm25_free.argtypes = [ctypes.c_void_p]
        lib.bm25_add_doc.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
        lib.bm25_finalize.argtypes = [ctypes.c_void_p]
        lib.bm25_num_docs.restype = ctypes.c_int64
        lib.bm25_num_docs.argtypes = [ctypes.c_void_p]
        lib.bm25_search.restype = ctypes.c_int32
        lib.bm25_search.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.c_int32, ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
        ]
        lib.bm25_save.restype = ctypes.c_int32
        lib.bm25_save.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.bm25_load.restype = ctypes.c_void_p
        lib.bm25_load.argtypes = [ctypes.c_char_p]
        _lib = lib
    return _lib


class SimpleAnalyzer:
    """Lowercase alphanumeric tokenizer with optional stopwords/stemming."""

    _token = re.compile(r"[a-z0-9]+")

    def __init__(self, stopwords: bool = True, stem: bool = True):
        self._stop = set()
        self._stemmer = None
        if stopwords:
            try:
                from nltk.corpus import stopwords as sw

                self._stop = set(sw.words("english"))
            except Exception:
                pass
        if stem:
            try:
                from nltk.stem import PorterStemmer

                self._stemmer = PorterStemmer().stem
            except Exception:
                pass

    def __call__(self, text: str) -> List[str]:
        tokens = self._token.findall(text.lower())
        if self._stop:
            tokens = [t for t in tokens if t not in self._stop]
        if self._stemmer:
            tokens = [self._stemmer(t) for t in tokens]
        return tokens


class BM25Index:
    """Python handle over the native index + the term vocabulary."""

    def __init__(self, k1: float = 0.9, b: float = 0.4, analyzer=None):
        self._lib = _load_lib()
        self._handle = self._lib.bm25_create(ctypes.c_float(k1), ctypes.c_float(b))
        self.analyzer = analyzer or SimpleAnalyzer()
        self.vocab: Dict[str, int] = {}
        self.doc_ids: List[str] = []
        self._finalized = False

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.bm25_free(self._handle)
            self._handle = None

    def _term_ids(self, tokens: Sequence[str], grow: bool) -> np.ndarray:
        ids = []
        for t in tokens:
            tid = self.vocab.get(t)
            if tid is None:
                if not grow:
                    continue
                tid = len(self.vocab)
                self.vocab[t] = tid
            ids.append(tid)
        return np.asarray(ids, np.int32)

    def add(self, doc_id: str, text: str):
        assert not self._finalized, "index already finalized"
        ids = self._term_ids(self.analyzer(text), grow=True)
        ptr = ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        self._lib.bm25_add_doc(self._handle, ptr, len(ids))
        self.doc_ids.append(doc_id)

    def finalize(self):
        self._lib.bm25_finalize(self._handle)
        self._finalized = True

    @property
    def num_docs(self) -> int:
        return int(self._lib.bm25_num_docs(self._handle))

    def search(self, query: str, k: int = 100) -> List[Tuple[str, float]]:
        assert self._finalized, "finalize() first"
        ids = self._term_ids(self.analyzer(query), grow=False)
        out_docs = np.zeros(k, np.int32)
        out_scores = np.zeros(k, np.float32)
        n = self._lib.bm25_search(
            self._handle,
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(ids),
            k,
            out_docs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            out_scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        return [(self.doc_ids[out_docs[i]], float(out_scores[i])) for i in range(n)]

    # -- persistence (native blob + vocab/doc-id sidecars) ---------------

    def save(self, path: str):
        if not self._finalized:
            # the native writer fwrites num_terms+1 offsets, which only
            # exist after finalize() builds the CSR — saving earlier
            # would write a corrupt blob (or crash)
            raise RuntimeError("finalize() the index before save()")
        os.makedirs(path, exist_ok=True)
        rc = self._lib.bm25_save(self._handle, os.path.join(path, "index.bin").encode())
        if rc != 0:
            raise IOError(f"bm25_save failed for {path}")
        terms = sorted(self.vocab.items(), key=lambda kv: kv[1])
        with open(os.path.join(path, "vocab.txt"), "w") as f:
            for term, _ in terms:
                f.write(term + "\n")
        with open(os.path.join(path, "docids.txt"), "w") as f:
            for did in self.doc_ids:
                f.write(did + "\n")

    @classmethod
    def load(cls, path: str, analyzer=None) -> "BM25Index":
        self = cls.__new__(cls)
        self._lib = _load_lib()
        handle = self._lib.bm25_load(os.path.join(path, "index.bin").encode())
        if not handle:
            raise IOError(f"cannot load BM25 index from {path}")
        self._handle = handle
        self.analyzer = analyzer or SimpleAnalyzer()
        with open(os.path.join(path, "vocab.txt")) as f:
            self.vocab = {line.rstrip("\n"): i for i, line in enumerate(f)}
        with open(os.path.join(path, "docids.txt")) as f:
            self.doc_ids = [line.rstrip("\n") for line in f]
        self._finalized = True
        return self


class BM25Retriever:
    """Corpus-level convenience wrapper producing TREC-style results."""

    def __init__(self, k1: float = 0.9, b: float = 0.4, analyzer=None):
        self.index = BM25Index(k1, b, analyzer)

    def index_corpus(self, corpus: Iterable[dict], text_fn=None):
        text_fn = text_fn or (lambda d: f"{d.get('title', '')} {d.get('text', '')}".strip())
        for doc in corpus:
            self.index.add(str(doc["id"]), text_fn(doc))
        self.index.finalize()
        return self

    def retrieve(self, queries: Dict[str, str], k: int = 100) -> Dict[str, Dict[str, float]]:
        return {
            qid: dict(self.index.search(text, k)) for qid, text in queries.items()
        }
