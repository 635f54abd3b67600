"""Mine hard negatives from a TREC run into tokenized train shards (twin
of ``scripts/msmarco/build_hn.py``).

    python -m openmatch_tpu_torch.scripts.msmarco.build_hn \
        --tokenizer_name <tok> --hn_file run.trec --qrels qrels.tsv \
        --queries queries.tsv --collection collection.tsv --save_to out_dir

Streams the run grouped by query, drops qrel positives, keeps ``depth``,
samples ``n_sample`` and writes ``splitNN.hn.jsonl`` shards: the static
counterpart of the ANCE refresh (``ance/loop.py``).
"""

from argparse import ArgumentParser
from multiprocessing import Pool

from ...config import ModelArguments
from ...data.preprocessor import (ShardedJsonlWriter, TrainPreProcessor,
                                  load_ranking_negatives,
                                  read_collection_tsv, read_qrel,
                                  read_queries)
from ...drivers.common import load_tokenizer


def main(argv=None, tokenizer=None):
    """``tokenizer``: used as given; by default ``load_tokenizer`` of
    ``--tokenizer_name``."""
    parser = ArgumentParser()
    parser.add_argument("--tokenizer_name", required=True)
    parser.add_argument("--hn_file", required=True)
    parser.add_argument("--qrels", required=True)
    parser.add_argument("--queries", required=True)
    parser.add_argument("--collection", required=True)
    parser.add_argument("--save_to", required=True)
    parser.add_argument("--doc_template", type=str, default=None)
    parser.add_argument("--query_template", type=str, default=None)
    parser.add_argument("--truncate", type=int, default=128)
    parser.add_argument("--n_sample", type=int, default=30)
    parser.add_argument("--depth", type=int, default=200)
    parser.add_argument("--mp_chunk_size", type=int, default=500)
    parser.add_argument("--shard_size", type=int, default=45000)
    parser.add_argument("--seed", type=int, default=None)
    args = parser.parse_args(argv)

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

    stream = load_ranking_negatives(args.hn_file, qrel, args.n_sample,
                                    args.depth, args.seed)
    writer = ShardedJsonlWriter(args.save_to, args.shard_size, suffix=".hn")
    with Pool() as p:
        for x in p.imap(processor.process_one, stream,
                        chunksize=args.mp_chunk_size):
            writer.write(x)
    writer.close()


if __name__ == "__main__":
    main()
