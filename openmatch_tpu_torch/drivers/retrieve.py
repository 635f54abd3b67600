"""Dense retrieval over saved embedding shards (port of the JAX retrieve).

    python -m openmatch_tpu_torch.drivers.retrieve \
        --model_name_or_path <ckpt> --query_path queries.tsv \
        --encoded_save_path emb_dir --trec_save_path run.trec \
        [--retrieve_depth 100] [--device cuda]
"""

from __future__ import annotations

from ..config import (ArgumentParser, DataArguments, InferenceArguments,
                      ModelArguments)
from ..data.inference_dataset import InferenceDataset
from ..models.dr_model import DRModel
from ..retriever.retriever import Retriever
from ..utils.trec import save_as_trec
from .common import load_tokenizer, setup_logging, split_device_flag


def main(argv=None, retriever_cls=Retriever, tokenizer=None):
    """``retriever_cls``: ``Retriever`` (the whole index resident) or
    ``SuccessiveRetriever``; ``tokenizer``: used as given, by default
    ``load_tokenizer``."""
    setup_logging()
    device, rest = split_device_flag(argv)
    parser = ArgumentParser((ModelArguments, DataArguments, InferenceArguments))
    model_args, data_args, infer_args = parser.parse(rest)

    if tokenizer is None:
        tokenizer = load_tokenizer(model_args)
    model = DRModel.build(model_args, device=device)
    queries = InferenceDataset.load(tokenizer, data_args, is_query=True)
    retriever = retriever_cls.from_embeddings(
        model, data_args, infer_args, tokenizer.pad_token_id or 0, device)
    result = retriever.retrieve(queries, topk=infer_args.retrieve_depth)
    save_as_trec(result, infer_args.trec_save_path)
    print(f"wrote {sum(len(v) for v in result.values())} entries -> "
          f"{infer_args.trec_save_path}")


if __name__ == "__main__":
    main()
