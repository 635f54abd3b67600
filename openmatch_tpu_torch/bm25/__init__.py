from .engine import BM25Index, BM25Retriever, SimpleAnalyzer  # noqa: F401
