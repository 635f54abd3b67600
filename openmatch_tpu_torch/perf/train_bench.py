"""DR and RR training-step throughput at the recipe shape.

Twin of ``scripts/perf/train_bench.py``:

    python -m openmatch_tpu_torch.perf.train_bench [BATCH] [N_PASSAGES]
        [--grad-cache] [--t5] [--rr] [--tiny] [--dtype bfloat16|float32]
        [--device cpu]

The recipe (docs/dr-msmarco-passage.md): BATCH (default 8) queries of 32
tokens x N_PASSAGES (8) passages of 128 a step, bf16 compute with fp32
parameters and optimizer. DR steps run ``DRTrainer`` with
``negatives_x_device=True`` (and GradCache with ``--grad-cache``): BERT-base,
or with ``--t5`` T5-base as ``t5_encdec`` (the flagship recipe's default:
the rep is the decoder's first step). ``--rr`` runs ``RRTrainer`` over
BATCH positive and BATCH negative pairs of 32 + 128 + 2 = 162 tokens:
BERT-base with the bce loss, or monoT5-base (``--t5``) with ce and the
script's pos / neg token ids 3 / 4; N_PASSAGES is ignored. ``--tiny``
takes the TPU script's 1-layer, 16-wide models over a 64-token vocab.

Weights come from each module's initialisation under a generator seeded
with 0, token ids from ``np.random.RandomState(0)`` as the TPU script draws
them, so throughput depends on shapes only. One warm-up step, whose loss
is returned as ``first_loss``, then ``ITERS`` eager steps timed on the
host's clock behind a sync (the TPU script's 8-step ``fori_loop``): ms per
step, queries/s and passages/s (or sequences/s) on the device.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from ..device import resolve_dtype
from . import add_device_arg, device_of, sync

ITERS = 8
QL, PL = 32, 128


def parse(argv: Optional[List[str]]):
    ap = argparse.ArgumentParser(
        prog="python -m openmatch_tpu_torch.perf.train_bench",
        description=__doc__.splitlines()[0])
    ap.add_argument("batch", type=int, nargs="?", default=8)
    ap.add_argument("n_passages", type=int, nargs="?", default=8)
    ap.add_argument("--grad-cache", action="store_true")
    ap.add_argument("--t5", action="store_true")
    ap.add_argument("--rr", action="store_true")
    ap.add_argument("--tiny", action="store_true",
                    help="1-layer, 16-wide models over a 64-token vocab")
    ap.add_argument("--dtype", default="bfloat16",
                    help="compute dtype: bfloat16 | float32")
    add_device_arg(ap)
    return ap.parse_args(argv)


def encoder_config(args):
    """(encoder config, vocab) of the run."""
    from ..models.bert import BertConfig
    from ..models.t5 import T5Config

    if args.tiny:
        cfg = (T5Config(d_model=16, d_kv=8, d_ff=32, num_layers=1,
                        num_decoder_layers=1, num_heads=2, vocab_size=64)
               if args.t5 else
               BertConfig(vocab_size=64, hidden_size=16, num_hidden_layers=1,
                          num_attention_heads=2, intermediate_size=32,
                          add_pooler=False))
        return cfg, 64
    if args.t5:
        return T5Config(), 32000  # t5-base geometry
    return BertConfig(add_pooler=False), 30000


def build(args):
    """(model, trainer class, TrainingArguments, batch, (unit, count)) of
    the run; the model's weights drawn under a generator seeded with 0."""
    from ..config import TrainingArguments
    from ..models.dr_model import DRModel
    from ..models.rr_model import RRModel
    from ..train.dr_trainer import DRTrainer
    from ..train.rr_trainer import RRTrainer

    cfg, vocab = encoder_config(args)
    dtype = resolve_dtype(args.dtype)
    B, NP = args.batch, args.n_passages
    rng = np.random.RandomState(0)

    def ids(rows, length):
        x = rng.randint(1, vocab, size=(rows, length)).astype(np.int64)
        return {"input_ids": x, "attention_mask": np.ones_like(x)}

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        if args.rr:
            model = RRModel(cfg, backbone_type="t5" if args.t5 else "bert",
                            pos_token_id=3, neg_token_id=4,
                            head_in_dim=getattr(cfg, "hidden_size", None)
                            or cfg.d_model,
                            loss_fn_str="ce" if args.t5 else "bce",
                            dtype=dtype)
        else:
            model = DRModel(encoder_config=cfg,
                            backbone_type="t5_encdec" if args.t5 else "bert",
                            dtype=dtype)
    if args.rr:
        L = QL + PL + 2  # the reference PairCollator's pair length
        batch = {"pos_pairs": ids(B, L), "neg_pairs": ids(B, L)}
        # each of the 2B units is one positive or negative sequence
        return (model, RRTrainer, TrainingArguments(
            per_device_train_batch_size=B, max_steps=1000), batch,
            ("seqs", 2 * B))
    batch = {"query": ids(B, QL), "passage": ids(B * NP, PL)}
    return (model, DRTrainer, TrainingArguments(
        negatives_x_device=True, grad_cache=args.grad_cache,
        per_device_train_batch_size=B, max_steps=1000), batch,
        ("passages", B * NP))


def main(argv: Optional[List[str]] = None) -> dict:
    args = parse(argv)
    dev = device_of(args)
    model, trainer_cls, train_args, batch, (unit, n_units) = build(args)
    trainer = trainer_cls(model, train_args, total_steps=1000, device=dev)
    first_loss = float(trainer.train_step(batch))  # warm-up, synced
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(ITERS):
        loss = trainer.train_step(batch)
    sync(dev)
    dt = (time.perf_counter() - t0) / ITERS
    B = args.batch
    tag = "".join(["rr-" if args.rr else "", "t5" if args.t5 else "bert",
                   "-grad_cache" if args.grad_cache else ""])
    shape = (f"B={B} pairs (L={QL + PL + 2})" if args.rr
             else f"B={B} x {args.n_passages} passages (q{QL}/p{PL})")
    print(f"{tag}: {dt * 1e3:.1f} ms/step at {shape} ({args.dtype}) -> "
          f"{B / dt:,.1f} queries/s/{dev.type} device, "
          f"{n_units / dt:,.1f} {unit}/s/{dev.type} device", flush=True)
    return {"tag": tag, "ms": dt * 1e3, "queries_s": B / dt,
            "units_s": n_units / dt, "unit": unit, "first_loss": first_loss,
            "last_loss": float(loss), "steps": trainer.step}


if __name__ == "__main__":
    main()
