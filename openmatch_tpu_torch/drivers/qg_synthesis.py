"""ContrastQG synthesis pipeline (port of the JAX ``qg_synthesis``
driver): the target-domain generation steps as one driver.

    1. prepro        target-domain corpus jsonl / tsv -> {doc_id: text}
    2. seed QG       the trained QG model generates a seed query per doc
    3. BM25 subset   the native BM25 engine retrieves per seed query
                     (``bm25/engine.py``)
    4. pair sampling contrast (doc+, doc-) pairs from the run's rank
                     bands (``research.qg.build_contrast_pairs``)
    5. ContrastQG    the trained ContrastQG model generates contrastive
                     queries; the output is OpenMatch train jsonl, which
                     ``train_dr`` reads directly.

    python -m openmatch_tpu_torch.drivers.qg_synthesis \
        --corpus_path docs.jsonl --output_path synthetic.train.jsonl \
        --qg_model_path <seed QG ckpt> --cqg_model_path <ContrastQG ckpt> \
        --tokenizer_name <tokenizer> [--bm25_topk 100] [--max_docs N] \
        [--neg_rank_lo 50 --neg_rank_hi 100] [--temperature 0.0] \
        [--device cuda]

The JAX driver's flags, plus ``--device`` (default ``cuda``; the CPU only
when named). The models are HF T5 directories. ``main`` takes
``tokenizer=`` (a T5-style tokenizer: ``__call__`` with truncation and
``decode``) in place of loading ``--tokenizer_name``.
"""

from __future__ import annotations

import argparse
import logging
from typing import Dict, Optional, Tuple

from ..bm25.engine import BM25Retriever
from ..research.qg import (QGModel, build_contrast_pairs,
                           generate_seed_queries, synthesize_training_data)
from .bm25_retrieve import iter_corpus
from .common import _auto_tokenizer, setup_logging, split_device_flag

logger = logging.getLogger(__name__)


def run_pipeline(
    qg: QGModel,
    cqg: QGModel,
    tokenizer,
    corpus: Dict[str, str],
    output_path: str,
    max_src_len: int = 256,
    max_new_tokens: int = 24,
    batch_size: int = 16,
    bm25_topk: int = 100,
    neg_rank_range: Tuple[int, int] = (50, 100),
    temperature: float = 0.0,
    k1: float = 0.9,
    b: float = 0.4,
    max_docs: Optional[int] = None,
    seed: int = 0,
    eos_token_id: int = 1,
) -> int:
    """Steps 2-5 over an in-memory corpus; returns the examples written.
    The seed QG reads the raw doc text, ContrastQG the 'positive: ...
    negative: ...' concatenation."""
    doc_ids = list(corpus.keys())[: max_docs or None]
    seed_queries = generate_seed_queries(
        qg, tokenizer, corpus, doc_ids, max_src_len=max_src_len,
        max_new_tokens=max_new_tokens, batch_size=batch_size,
        temperature=temperature, eos_token_id=eos_token_id)
    logger.info("seed QG: %d queries for %d docs", len(seed_queries),
                len(doc_ids))

    retriever = BM25Retriever(k1=k1, b=b)
    retriever.index_corpus({"id": d, "text": t} for d, t in corpus.items())
    run = retriever.retrieve(seed_queries, k=bm25_topk)
    logger.info("BM25 subset retrieval: %d result lists", len(run))

    # a seed query's qid is its source doc's id, so the positive is the
    # source doc itself
    pairs = build_contrast_pairs(
        run, seed_doc_of_query={d: d for d in seed_queries},
        neg_rank_range=neg_rank_range, seed=seed)

    n = synthesize_training_data(
        cqg, tokenizer, corpus, pairs, output_path,
        max_src_len=max_src_len, max_new_tokens=max_new_tokens,
        batch_size=batch_size, temperature=temperature,
        eos_token_id=eos_token_id)
    logger.info("ContrastQG: wrote %d training examples to %s", n,
                output_path)
    return n


def load_corpus(path: str) -> Dict[str, str]:
    """Step 1: a jsonl / tsv target-domain corpus as id -> text (the title
    prepended when there is one)."""
    corpus = {}
    for d in iter_corpus(path):
        text = d.get("text", "")
        title = d.get("title", "")
        corpus[str(d["id"])] = f"{title} {text}".strip() if title else text
    return corpus


def main(argv=None, tokenizer=None) -> int:
    """Returns the number of examples written."""
    setup_logging()
    device, rest = split_device_flag(argv)
    parser = argparse.ArgumentParser()
    parser.add_argument("--corpus_path", required=True)
    parser.add_argument("--output_path", required=True)
    parser.add_argument("--qg_model_path", required=True)
    parser.add_argument("--cqg_model_path", required=True)
    parser.add_argument("--tokenizer_name", required=True)
    parser.add_argument("--max_src_len", type=int, default=256)
    parser.add_argument("--max_new_tokens", type=int, default=24)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--bm25_topk", type=int, default=100)
    parser.add_argument("--neg_rank_lo", type=int, default=50)
    parser.add_argument("--neg_rank_hi", type=int, default=100)
    parser.add_argument("--temperature", type=float, default=0.0)
    parser.add_argument("--k1", type=float, default=0.9)
    parser.add_argument("--b", type=float, default=0.4)
    parser.add_argument("--max_docs", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(rest)

    if tokenizer is None:
        tokenizer = _auto_tokenizer().from_pretrained(args.tokenizer_name)
    qg = QGModel.from_pretrained(args.qg_model_path, device=device)
    cqg = QGModel.from_pretrained(args.cqg_model_path, device=device)
    corpus = load_corpus(args.corpus_path)
    return run_pipeline(
        qg, cqg, tokenizer, corpus, args.output_path,
        max_src_len=args.max_src_len, max_new_tokens=args.max_new_tokens,
        batch_size=args.batch_size, bm25_topk=args.bm25_topk,
        neg_rank_range=(args.neg_rank_lo, args.neg_rank_hi),
        temperature=args.temperature, k1=args.k1, b=args.b,
        max_docs=args.max_docs, seed=args.seed)


if __name__ == "__main__":
    main()
