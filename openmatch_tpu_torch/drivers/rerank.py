"""Rerank a TREC run with a cross-encoder (port of the JAX ``rerank``).

    python -m openmatch_tpu_torch.drivers.rerank \
        --model_name_or_path <rr_ckpt> \
        --query_path queries.tsv --corpus_path corpus.tsv \
        --trec_run_path run.trec --trec_save_path reranked.trec \
        [--reranking_depth 100] [--pos_token true --neg_token false] \
        [--device cuda]
"""

from __future__ import annotations

from ..config import (ArgumentParser, DataArguments, InferenceArguments,
                      ModelArguments)
from ..data.inference_dataset import InferenceDataset
from ..models.rr_model import RRModel
from ..retriever.reranker import Reranker
from ..utils.trec import load_from_trec, save_as_trec
from .common import load_tokenizer, setup_logging, split_device_flag


def main(argv=None, tokenizer=None):
    """``tokenizer``: used as given, by default ``load_tokenizer``. Returns
    the reranked run."""
    setup_logging()
    device, rest = split_device_flag(argv)
    parser = ArgumentParser((ModelArguments, DataArguments,
                             InferenceArguments))
    model_args, data_args, infer_args = parser.parse(rest)

    if tokenizer is None:
        tokenizer = load_tokenizer(model_args)
    model = RRModel.build(model_args, tokenizer=tokenizer, device=device)
    queries = InferenceDataset.load(tokenizer, data_args,
                                    is_query=True).to_dict()
    corpus = InferenceDataset.load(tokenizer, data_args,
                                   is_query=False).to_dict()
    run = load_from_trec(infer_args.trec_run_path,
                         max_len_per_q=infer_args.reranking_depth)
    reranker = Reranker(model, tokenizer, data_args, infer_args)
    result = reranker.rerank(queries, corpus, run,
                             depth=infer_args.reranking_depth)
    save_as_trec(result, infer_args.trec_save_path)
    print(f"reranked {len(result)} queries -> {infer_args.trec_save_path}")
    return result


if __name__ == "__main__":
    main()
