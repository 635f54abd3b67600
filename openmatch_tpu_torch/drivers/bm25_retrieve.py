"""BM25 first-stage retrieval (port of the JAX ``bm25_retrieve`` driver;
the host's C++ index, no device).

    python -m openmatch_tpu_torch.drivers.bm25_retrieve \
        --corpus_path corpus.jsonl --query_path queries.tsv \
        --trec_save_path run.trec [--index_path idx_dir] [--k1 0.9 --b 0.4]

With --index_path: builds the index there if absent, else loads it.
"""

from __future__ import annotations

import argparse
import csv
import json
import os

from ..bm25.engine import BM25Index, BM25Retriever
from ..utils.trec import save_as_trec


def iter_corpus(path: str):
    if path.endswith(".jsonl") or path.endswith(".json"):
        with open(path) as f:
            for line in f:
                d = json.loads(line)
                d.setdefault("id", d.get("_id", d.get("text_id")))
                yield d
    else:
        with open(path) as f:
            for row in csv.reader(f, delimiter="\t"):
                yield {"id": row[0], "title": row[1] if len(row) > 2 else "",
                       "text": row[-1]}


def load_queries(path: str):
    queries = {}
    if path.endswith(".jsonl") or path.endswith(".json"):
        with open(path) as f:
            for line in f:
                d = json.loads(line)
                queries[str(d.get("id", d.get("_id")))] = d.get("text", "")
    else:
        with open(path) as f:
            for row in csv.reader(f, delimiter="\t"):
                queries[row[0]] = row[1]
    return queries


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--corpus_path", type=str)
    parser.add_argument("--query_path", required=True)
    parser.add_argument("--trec_save_path", required=True)
    parser.add_argument("--index_path", type=str, default=None)
    parser.add_argument("--k1", type=float, default=0.9)
    parser.add_argument("--b", type=float, default=0.4)
    parser.add_argument("--topk", type=int, default=1000)
    args = parser.parse_args(argv)

    if args.index_path and os.path.exists(os.path.join(args.index_path, "index.bin")):
        retriever = BM25Retriever.__new__(BM25Retriever)
        retriever.index = BM25Index.load(args.index_path)
        print(f"loaded index: {retriever.index.num_docs} docs")
    else:
        assert args.corpus_path, "--corpus_path required to build an index"
        retriever = BM25Retriever(k1=args.k1, b=args.b)
        retriever.index_corpus(iter_corpus(args.corpus_path))
        print(f"indexed {retriever.index.num_docs} docs")
        if args.index_path:
            retriever.index.save(args.index_path)

    queries = load_queries(args.query_path)
    result = retriever.retrieve(queries, k=args.topk)
    save_as_trec(result, args.trec_save_path, run_id="BM25")
    print(f"wrote {len(result)} queries -> {args.trec_save_path}")
    return result


if __name__ == "__main__":
    main()
