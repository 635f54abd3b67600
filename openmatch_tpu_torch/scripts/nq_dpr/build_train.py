"""Convert DPR-format json (NQ) to OpenMatch tokenized train jsonl (twin of
``scripts/nq-dpr/build_train.py``).

    python -m openmatch_tpu_torch.scripts.nq_dpr.build_train \
        --input nq-train.json --output train.jsonl [--tokenizer <tok>]

An example is kept when it has at least one positive and at least
``--minimum-negatives`` hard negatives.
"""

import json
import os
from argparse import ArgumentParser

from ...config import ModelArguments
from ...drivers.common import load_tokenizer
from ...templates import fill_template


def main(argv=None, tokenizer=None):
    """``tokenizer``: used as given; by default ``load_tokenizer`` of
    ``--tokenizer``."""
    parser = ArgumentParser()
    parser.add_argument("--input", type=str, required=True)
    parser.add_argument("--output", type=str, required=True)
    parser.add_argument("--query_template", type=str, default="<question>")
    parser.add_argument("--doc_template", type=str,
                        default="<title> [SEP] <text>")
    parser.add_argument("--tokenizer", type=str, default="bert-base-uncased")
    parser.add_argument("--minimum-negatives", type=int, default=1)
    parser.add_argument("--q_max_len", type=int, default=32)
    parser.add_argument("--p_max_len", type=int, default=128)
    args = parser.parse_args(argv)

    if tokenizer is None:
        tokenizer = load_tokenizer(
            ModelArguments(model_name_or_path=args.tokenizer))
    with open(args.input) as f:
        data = json.load(f)

    save_dir = os.path.split(args.output)[0]
    if save_dir and not os.path.exists(save_dir):
        os.makedirs(save_dir)

    kept = 0
    with open(args.output, "w") as f:
        for item in data:
            if (len(item.get("hard_negative_ctxs", [])) < args.minimum_negatives
                    or len(item.get("positive_ctxs", [])) < 1):
                continue
            positives = [fill_template(args.doc_template, p)
                         for p in item["positive_ctxs"]]
            negatives = [fill_template(args.doc_template, n)
                         for n in item["hard_negative_ctxs"]]
            group = {
                "query": tokenizer.encode(
                    fill_template(args.query_template, item),
                    add_special_tokens=False, max_length=args.q_max_len,
                    truncation=True,
                ),
                "positives": tokenizer(
                    positives, add_special_tokens=False,
                    max_length=args.p_max_len, truncation=True,
                    padding=False,
                )["input_ids"],
                "negatives": tokenizer(
                    negatives, add_special_tokens=False,
                    max_length=args.p_max_len, truncation=True,
                    padding=False,
                )["input_ids"],
            }
            f.write(json.dumps(group) + "\n")
            kept += 1
    print(f"wrote {kept} examples -> {args.output}")


if __name__ == "__main__":
    main()
