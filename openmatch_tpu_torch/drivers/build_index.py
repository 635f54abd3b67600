"""Encode a corpus into embedding shards (port of the JAX build_index).

    python -m openmatch_tpu_torch.drivers.build_index \
        --model_name_or_path <ckpt> --corpus_path corpus.jsonl \
        --encoded_save_path emb_dir [--encode_shard_index i --encode_num_shard n] \
        [--device cuda]
"""

from __future__ import annotations

from ..config import (ArgumentParser, DataArguments, InferenceArguments,
                      ModelArguments)
from ..data.inference_dataset import InferenceDataset
from ..models.dr_model import DRModel
from ..retriever.retriever import Retriever
from .common import load_tokenizer, setup_logging, split_device_flag


def main(argv=None, tokenizer=None):
    """``tokenizer``: used as given; by default ``load_tokenizer``."""
    setup_logging()
    device, rest = split_device_flag(argv)
    parser = ArgumentParser((ModelArguments, DataArguments, InferenceArguments))
    model_args, data_args, infer_args = parser.parse(rest)

    if tokenizer is None:
        tokenizer = load_tokenizer(model_args)
    model = DRModel.build(model_args, device=device)
    corpus = InferenceDataset.load(
        tokenizer, data_args,
        data_files=data_args.encode_in_path or data_args.corpus_path,
        is_query=data_args.encode_is_qry,
        shard_index=data_args.encode_shard_index,
        num_shards=data_args.encode_num_shard,
    )
    retriever = Retriever(model, data_args, infer_args,
                          tokenizer.pad_token_id or 0, device)
    encode = retriever.encode_queries if data_args.encode_is_qry \
        else retriever.encode_corpus
    _, ids = encode(corpus, save_dir=infer_args.encoded_save_path,
                    shard_index=data_args.encode_shard_index)
    print(f"encoded {len(ids)} items -> {infer_args.encoded_save_path}")


if __name__ == "__main__":
    main()
