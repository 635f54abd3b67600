"""Dump RankLib-format features from a trained v1 model for LeToR
ensembling (port of the JAX ``gen_feature`` driver).

Per (query, doc): the label, ``id:<qid>``, the model's feature vector, its
score and the first-stage retrieval score, then ``# <docid>``; the same
lines the JAX driver writes. Feeds ``drivers/coor_ascent.py``. For the
BERT models the feature vector is the [CLS] rep (BertMaxP's: its MLP's
hidden layer).

    python -m openmatch_tpu_torch.drivers.gen_feature \
        -model knrm -dev dev.jsonl -vocab vocab.txt \
        -checkpoint checkpoints/knrm -out features.txt [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..data.loader import batched
from ..train.v1_trainer import load_v1_params, to_device
from ..v1.dataset import V1Dataset
from .common import (DictOrStr, build_v1_tokenizer, setup_logging,
                     split_device_flag)
from .train_v1 import add_model_args, build_v1_collator, build_v1_model


def feature_line(qid, did, label, feats, score, rscore) -> str:
    parts = [str(int(label)), f"id:{qid}"]
    parts += [f"{i + 1}:{v}" for i, v in enumerate(feats)]
    parts.append(f"{len(feats) + 1}:{score}")
    parts.append(f"{len(feats) + 2}:{rscore}")
    parts.append(f"# {did}")
    return " ".join(parts)


def main(argv=None, tokenizer=None):
    """Returns the number of lines written."""
    setup_logging()
    device, rest = split_device_flag(argv)
    parser = argparse.ArgumentParser()
    add_model_args(parser)
    parser.add_argument("-dev", required=True, action=DictOrStr)
    parser.add_argument("-checkpoint", required=True)
    parser.add_argument("-out", required=True)
    parser.add_argument("-batch_size", type=int, default=32)
    args = parser.parse_args(rest)

    if tokenizer is None:
        tokenizer = build_v1_tokenizer(args)
    model = load_v1_params(build_v1_model(args, tokenizer),
                           args.checkpoint).to(device).eval()

    dev_set = V1Dataset(args.dev, mode="dev", task=args.task)
    lines = []
    collator = build_v1_collator(args, tokenizer, "dev")
    for batch in batched(iter(dev_set), args.batch_size, collator):
        tensors = to_device({k: v for k, v in batch.items()
                             if k not in ("label", "retrieval_score")},
                            device)
        with torch.no_grad():
            scores, feats = model.score_batch(tensors)
            if scores.ndim == 2:
                scores = torch.softmax(scores, dim=-1)[:, 1]
        scores = scores.float().cpu().numpy()
        feats = feats.float().cpu().numpy()
        labels = batch.get("label", np.zeros(len(scores), np.int32))
        rscores = batch.get("retrieval_score",
                            np.zeros(len(scores), np.float32))
        for qid, did, label, f, s, r in zip(
                batch["query_id"], batch["doc_id"], labels, feats, scores,
                rscores):
            lines.append(feature_line(qid, did, label, f, s, r))

    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {len(lines)} feature lines -> {args.out}")
    return len(lines)


if __name__ == "__main__":
    main()
