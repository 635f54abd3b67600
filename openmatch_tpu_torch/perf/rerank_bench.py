"""Cross-encoder reranking throughput: pairs/s of BERT and monoT5.

Twin of ``scripts/perf/rerank_bench.py``:

    python -m openmatch_tpu_torch.perf.rerank_bench bert|monot5 [BATCH]
        [SEQ_LEN] [--tiny] [--dtype bfloat16|float32] [--device cpu]

BATCH (default 128) pairs of SEQ_LEN (192: the recipe's 32 + 128 + 2 = 162
tokens, padded) through ``RRModel.score`` and ``relevance_logprob``, the
serving path, under ``torch.inference_mode()``: BERT-base with its linear
head, or monoT5-base (``T5Config()``, pos / neg token ids 1176 / 6136, the
script's), in bf16 compute. Weights come from each module's
initialisation under a generator seeded with 0 and token ids from
``np.random.RandomState(0)``, as the TPU script draws them: throughput
depends on shapes, not values. ``--tiny`` takes a 1-layer, 16-wide model
over a 64-token vocab (monoT5's token ids then 3 / 4). Each batch is timed
with CUDA events on the card, the median of a few after a warm-up, in
place of the TPU script's ``fori_loop``; queries/s at reranking depth d
are pairs/s / d.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

from ..device import resolve_dtype
from . import add_device_arg, device_of, time_ms


def parse(argv: Optional[List[str]]):
    ap = argparse.ArgumentParser(
        prog="python -m openmatch_tpu_torch.perf.rerank_bench",
        description=__doc__.splitlines()[0])
    ap.add_argument("kind", nargs="?", default="bert",
                    choices=["bert", "monot5"])
    ap.add_argument("batch", type=int, nargs="?", default=128)
    ap.add_argument("seq_len", type=int, nargs="?", default=192)
    ap.add_argument("--tiny", action="store_true",
                    help="a 1-layer, 16-wide model over a 64-token vocab")
    ap.add_argument("--dtype", default="bfloat16",
                    help="compute dtype: bfloat16 | float32")
    add_device_arg(ap)
    return ap.parse_args(argv)


def build(args):
    """(model, (ids, mask, segs) as numpy int64) of the run; the weights
    drawn under a generator seeded with 0."""
    from ..models.bert import BertConfig
    from ..models.rr_model import RRModel
    from ..models.t5 import T5Config

    dtype = resolve_dtype(args.dtype)
    vocab = 64 if args.tiny else 30000
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        if args.kind == "bert":
            cfg = (BertConfig(vocab_size=64, hidden_size=16,
                              num_hidden_layers=1, num_attention_heads=2,
                              intermediate_size=32, add_pooler=False)
                   if args.tiny else BertConfig(add_pooler=False))
            model = RRModel(cfg, head_in_dim=cfg.hidden_size, dtype=dtype)
        else:
            cfg = (T5Config(d_model=16, d_kv=8, d_ff=32, num_layers=1,
                            num_decoder_layers=1, num_heads=2,
                            vocab_size=64) if args.tiny else T5Config())
            tokens = (3, 4) if args.tiny else (1176, 6136)
            model = RRModel(cfg, backbone_type="t5", pos_token_id=tokens[0],
                            neg_token_id=tokens[1], dtype=dtype)
    rng = np.random.RandomState(0)
    B, S = args.batch, args.seq_len
    ids = rng.randint(1, vocab, size=(B, S)).astype(np.int64)
    return model, (ids, np.ones_like(ids), np.zeros_like(ids))


def main(argv: Optional[List[str]] = None) -> dict:
    args = parse(argv)
    dev = device_of(args)
    model, inputs = build(args)
    model = model.to(dev).eval()
    ids, mask, segs = (torch.from_numpy(x).to(dev) for x in inputs)
    B, S = args.batch, args.seq_len

    def score():
        return model.relevance_logprob(model.score(ids, mask, segs))

    with torch.inference_mode():
        out = score()
        ms = time_ms(score, dev)
    pps = B / ms * 1000
    print(f"{args.kind}: {ms:.3f} ms/batch of {B} pairs @S={S} "
          f"({args.dtype}) -> {pps:,.0f} pairs/s/{dev.type} device (depth "
          f"100: {pps / 100:,.1f} q/s; depth 1000: {pps / 1000:,.2f} q/s)",
          flush=True)
    return {"kind": args.kind, "ms": ms, "pairs_s": pps,
            "queries_s_100": pps / 100, "queries_s_1000": pps / 1000,
            "scores": out.float().cpu()}


if __name__ == "__main__":
    main()
