"""Strided split of an embedding shard for ``SuccessiveRetriever`` (twin of
``scripts/split_embeddings.py``).

    python -m openmatch_tpu_torch.scripts.split_embeddings \
        --input_embedding emb/embeddings.corpus.rank.0.npz \
        --output_dir split_dir [--kind corpus] [--num_splits 2]

Split ``i`` holds rows ``i, i + n, i + 2n, ...`` as
``embeddings.<kind>.rank.<i>.npz`` (``retriever/encoder.py``'s format).
"""

import argparse
import os

import numpy as np

from ..retriever.encoder import load_embeddings, save_embeddings


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--input_embedding", type=str, required=True)
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--kind", type=str, default="corpus")
    parser.add_argument("--num_splits", type=int, default=2)
    args = parser.parse_args(argv)

    embedding, ids = load_embeddings(args.input_embedding)
    ids = np.array(ids)
    os.makedirs(args.output_dir, exist_ok=True)
    for split in range(args.num_splits):
        emb_split = embedding[split :: args.num_splits]
        ids_split = ids[split :: args.num_splits].tolist()
        out = os.path.join(args.output_dir,
                           f"embeddings.{args.kind}.rank.{split}.npz")
        save_embeddings(emb_split, ids_split, out)
        print(f"{out}: {len(ids_split)} rows")


if __name__ == "__main__":
    main()
