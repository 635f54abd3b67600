"""Shard-at-a-time retrieval over saved embedding shards (port of the JAX
``successive_retrieve``): the ``retrieve`` driver with a
``SuccessiveRetriever``, which holds one shard on the device at a time.

    python -m openmatch_tpu_torch.drivers.successive_retrieve \
        --model_name_or_path <ckpt> --query_path queries.tsv \
        --encoded_save_path emb_dir --trec_save_path run.trec [--device cuda]
"""

from __future__ import annotations

from ..retriever.retriever import SuccessiveRetriever
from .retrieve import main as _retrieve_main


def main(argv=None, tokenizer=None):
    """``tokenizer``: used as given; by default ``load_tokenizer``."""
    _retrieve_main(argv, retriever_cls=SuccessiveRetriever,
                   tokenizer=tokenizer)


if __name__ == "__main__":
    main()
