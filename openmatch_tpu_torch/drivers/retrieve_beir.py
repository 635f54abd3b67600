"""BEIR zero-shot retrieval with inline NDCG@10 and Recall@100 (port of the
JAX ``retrieve_beir`` driver).

    python -m openmatch_tpu_torch.drivers.retrieve_beir \
        --model_name_or_path <ckpt> --data_dir beir/scifact \
        --trec_save_path run.trec [--retrieve_depth 100] [--device cuda]

Encodes the corpus as ``Title: <title> Text: <text>`` and the queries that
have qrels, searches ``retrieve_depth``, writes the TREC run and prints
``ndcg_cut_10`` and ``recall_100``.
"""

from __future__ import annotations

from ..config import (ArgumentParser, DataArguments, InferenceArguments,
                      ModelArguments)
from ..data.beir import BEIRDataset
from ..models.dr_model import DRModel
from ..retriever.retriever import Retriever
from ..templates import fill_template
from ..utils.metrics import evaluate_run
from ..utils.trec import save_as_trec
from .common import (load_tokenizer, refuse_ranks, setup_logging,
                     split_device_flag)

BEIR_DOC_TEMPLATE = "Title: <title> Text: <text>"


def main(argv=None, tokenizer=None):
    """``tokenizer``: used as given; by default ``load_tokenizer``. Returns
    the metrics."""
    setup_logging()
    device, rest = split_device_flag(argv)
    parser = ArgumentParser((ModelArguments, DataArguments,
                             InferenceArguments))
    model_args, data_args, infer_args = parser.parse(rest)
    refuse_ranks("retrieve_beir")

    if tokenizer is None:
        tokenizer = load_tokenizer(model_args)
    model = DRModel.build(model_args, device=device)
    beir = BEIRDataset(data_args.data_dir)

    def tok(text, max_len):
        return tokenizer.encode_plus(
            text, truncation="only_first", max_length=max_len,
            padding=False, return_attention_mask=False,
            return_token_type_ids=False,
        )["input_ids"]

    corpus_stream = (
        {"id": d["id"], "input_ids": tok(fill_template(BEIR_DOC_TEMPLATE, d),
                                         data_args.p_max_len)}
        for d in beir.iter_corpus()
    )
    query_stream = (
        {"id": q["id"], "input_ids": tok(q["text"], data_args.q_max_len)}
        for q in beir.iter_queries()
    )

    retriever = Retriever(model, data_args, infer_args,
                          tokenizer.pad_token_id or 0, device)
    retriever.encode_corpus(corpus_stream,
                            save_dir=infer_args.encoded_save_path)
    q_emb, qids = retriever.encode_queries(query_stream)
    result = retriever.search(q_emb, qids, topk=infer_args.retrieve_depth)

    if infer_args.trec_save_path:
        save_as_trec(result, infer_args.trec_save_path)
    metrics = evaluate_run(beir.qrels, result, ["ndcg_cut_10", "recall_100"])
    for name, value in metrics.items():
        print(f"{name}: {value:.4f}")
    return metrics


if __name__ == "__main__":
    main()
