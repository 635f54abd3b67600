"""Build MS MARCO tokenized train shards from qrels + a negatives tsv (twin
of ``scripts/msmarco/build_train.py``).

    python -m openmatch_tpu_torch.scripts.msmarco.build_train \
        --tokenizer_name <tok> --negative_file negs.tsv --qrels qrels.tsv \
        --queries queries.tsv --collection collection.tsv --save_to out_dir

``negative_file`` lines: ``qid\tnegid1,negid2,...``; output: ``n_sample``
shuffled negatives per query, tokenized jsonl in ``shard_size``-line
shards (``splitNN.jsonl``), tokenized by a ``multiprocessing.Pool``.
"""

import random
from argparse import ArgumentParser
from multiprocessing import Pool

from ...config import ModelArguments
from ...data.preprocessor import (ShardedJsonlWriter, TrainPreProcessor,
                                  read_collection_tsv, read_qrel,
                                  read_queries)
from ...drivers.common import load_tokenizer


def main(argv=None, tokenizer=None):
    """``tokenizer``: used as given; by default ``load_tokenizer`` of
    ``--tokenizer_name``."""
    parser = ArgumentParser()
    parser.add_argument("--tokenizer_name", required=True)
    parser.add_argument("--negative_file", required=True)
    parser.add_argument("--qrels", required=True)
    parser.add_argument("--queries", required=True)
    parser.add_argument("--collection", required=True)
    parser.add_argument("--save_to", required=True)
    parser.add_argument("--doc_template", type=str, default=None)
    parser.add_argument("--query_template", type=str, default=None)
    parser.add_argument("--truncate", type=int, default=128)
    parser.add_argument("--n_sample", type=int, default=30)
    parser.add_argument("--mp_chunk_size", type=int, default=500)
    parser.add_argument("--shard_size", type=int, default=45000)
    parser.add_argument("--seed", type=int, default=None)
    args = parser.parse_args(argv)

    rng = random.Random(args.seed)
    qrel = read_qrel(args.qrels)
    if tokenizer is None:
        tokenizer = load_tokenizer(
            ModelArguments(model_name_or_path=args.tokenizer_name))
    processor = TrainPreProcessor(
        queries=read_queries(args.queries),
        collection=read_collection_tsv(args.collection),
        tokenizer=tokenizer,
        doc_max_len=args.truncate,
        doc_template=args.doc_template,
        query_template=args.query_template,
        allow_not_found=True,
    )

    def read_lines():
        with open(args.negative_file) as nf:
            for line in nf:
                q, nn = line.strip().split("\t")
                nn = nn.split(",")
                rng.shuffle(nn)
                yield q, qrel[q], nn[: args.n_sample]

    writer = ShardedJsonlWriter(args.save_to, args.shard_size)
    with Pool() as p:
        for x in p.imap(processor.process_one, read_lines(),
                        chunksize=args.mp_chunk_size):
            writer.write(x)
    writer.close()


if __name__ == "__main__":
    main()
