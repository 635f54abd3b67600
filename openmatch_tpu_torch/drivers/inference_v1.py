"""Score a dev/test set with a trained v1 model and write a TREC run (port
of the JAX ``inference_v1`` driver).

    python -m openmatch_tpu_torch.drivers.inference_v1 \
        -model knrm -test test.jsonl -vocab vocab.txt \
        -checkpoint checkpoints/knrm -res run.trec [--device cuda]

``-checkpoint`` holds a ``train_state.msgpack`` written by either
package's ``train_v1``; its ``params`` are loaded. ``main`` takes
``tokenizer=`` in place of loading one.
"""

from __future__ import annotations

import argparse
import os

from ..data.loader import batched
from ..train.v1_trainer import load_v1_params, predict_scores
from ..utils.trec import save_as_trec
from ..v1.dataset import V1Dataset
from .common import (DictOrStr, build_v1_tokenizer, setup_logging,
                     split_device_flag)
from .train_v1 import add_model_args, build_v1_collator, build_v1_model


def main(argv=None, tokenizer=None):
    """Returns the run, {qid: {docid: score}}."""
    setup_logging()
    device, rest = split_device_flag(argv)
    parser = argparse.ArgumentParser()
    add_model_args(parser)
    parser.add_argument("-test", required=True, action=DictOrStr)
    parser.add_argument("-checkpoint", required=True)
    parser.add_argument("-res", required=True)
    parser.add_argument("-mode", default="test", choices=["dev", "test"])
    parser.add_argument("-batch_size", type=int, default=32)
    args = parser.parse_args(rest)

    if tokenizer is None:
        tokenizer = build_v1_tokenizer(args)
    model = load_v1_params(build_v1_model(args, tokenizer),
                           args.checkpoint).to(device)

    dataset = V1Dataset(args.test, mode=args.mode, task=args.task)
    batches = batched(iter(dataset), args.batch_size,
                      build_v1_collator(args, tokenizer, args.mode))
    result = predict_scores(model, batches, args.task, device)
    os.makedirs(os.path.dirname(args.res) or ".", exist_ok=True)
    save_as_trec(result, args.res)
    print(f"wrote {len(result)} queries -> {args.res}")
    return result


if __name__ == "__main__":
    main()
