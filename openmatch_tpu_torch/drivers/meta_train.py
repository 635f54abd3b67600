"""Meta learning-to-reweight training, Meta-LTR (port of the JAX
``meta_train`` driver).

Source pairs (``-train``) are reweighted per batch by the meta-gradient of
the TARGET-domain batch's loss (``-target``, cycled endlessly), with
optional per-step weight logging (``-log_weights`` -> weights.txt) and dev
evaluation keeping the best checkpoint (``-eval_during_train``). The
target set is a second ``V1Dataset`` in train mode (the same pair format).

    python -m openmatch_tpu_torch.drivers.meta_train \
        -model knrm -train source.jsonl -target target.jsonl \
        -dev dev.jsonl -qrels qrels -vocab vocab.txt \
        -save_folder ckpt -eval_during_train -log_weights \
        -epoch 1 -train_batch_size 8 -target_batch_size 8 -lr 0.001 \
        [--device cuda]

The JAX driver's flags, plus ``--device`` (default ``cuda``; the CPU only
when named). The models are ``train_v1``'s. ``main`` takes ``tokenizer=``
(an HF-style tokenizer for the BERT models, a ``WordTokenizer`` for the
others) in place of loading one; checkpoints are ``train_state.msgpack``
in the JAX package's layout.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..config import TrainingArguments
from ..data.loader import batched
from ..train.meta_trainer import CyclingIterator, MetaLTRTrainer
from ..train.v1_trainer import predict_scores
from ..utils.metrics import evaluate_run, load_qrels
from ..utils.trec import save_as_trec
from ..v1.dataset import V1Dataset
from .common import (DictOrStr, build_v1_tokenizer, setup_logging,
                     split_device_flag)
from .train_v1 import add_model_args, build_v1_collator, build_v1_model


def main(argv=None, tokenizer=None):
    """Returns the trainer's ``{"losses", "final_step", "best_metric",
    "weights"}``."""
    setup_logging()
    device, rest = split_device_flag(argv)
    parser = argparse.ArgumentParser()
    add_model_args(parser)
    parser.set_defaults(model="bert", max_query_len=20, max_doc_len=150)
    parser.add_argument("-ranking_loss", default="margin_loss")
    parser.add_argument("-train", required=True, action=DictOrStr,
                        help="source-domain pairs")
    parser.add_argument("-target", required=True, action=DictOrStr,
                        help="target-domain pairs (cycled; the meta reward "
                             "signal)")
    parser.add_argument("-dev", default=None, action=DictOrStr)
    parser.add_argument("-qrels", default=None)
    parser.add_argument("-metric", default="ndcg_cut_10")
    parser.add_argument("-epoch", type=int, default=1)
    parser.add_argument("-train_batch_size", type=int, default=8)
    parser.add_argument("-target_batch_size", type=int, default=8)
    parser.add_argument("-dev_eval_batch_size", type=int, default=128)
    parser.add_argument("-lr", type=float, default=2e-5)
    parser.add_argument("-n_warmup_steps", type=int, default=1000)
    parser.add_argument("-eval_every", type=int, default=1000)
    parser.add_argument("-eval_during_train", action="store_true",
                        default=False)
    parser.add_argument("-log_weights", action="store_true", default=False)
    parser.add_argument("-save_folder", required=True)
    parser.add_argument("-max_input", type=int, default=1_280_000)
    args = parser.parse_args(rest)

    os.makedirs(args.save_folder, exist_ok=True)
    if tokenizer is None:
        tokenizer = build_v1_tokenizer(args)
    model = build_v1_model(args, tokenizer)

    train_set = V1Dataset(args.train, mode="train", task=args.task,
                          max_input=args.max_input)
    target_set = V1Dataset(args.target, mode="train", task=args.task,
                           max_input=args.max_input)
    train_collator = build_v1_collator(args, tokenizer, "train")

    steps_per_epoch = max(len(train_set) // args.train_batch_size, 1)
    total_steps = steps_per_epoch * args.epoch

    train_args = TrainingArguments(
        output_dir=args.save_folder, learning_rate=args.lr,
        warmup_steps=args.n_warmup_steps,
        logging_steps=max(args.eval_every, 1),
        eval_steps=args.eval_every if args.eval_during_train else None,
        save_steps=0, seed=args.seed, margin=1.0,
    )
    trainer = MetaLTRTrainer(
        model, train_args, total_steps, task=args.task,
        ranking_loss_kind=args.ranking_loss,
        log_weights_path=os.path.join(args.save_folder, "weights.txt")
        if args.log_weights else None, device=device)

    eval_fn = None
    if args.eval_during_train:
        if not (args.dev and args.qrels):
            raise ValueError("-eval_during_train needs -dev and -qrels")
        dev_set = V1Dataset(args.dev, mode="dev", task=args.task,
                            max_input=args.max_input)
        dev_collator = build_v1_collator(args, tokenizer, "dev")
        qrels = load_qrels(args.qrels)
        res_path = os.path.join(args.save_folder, "latest_dev.trec")

        def eval_fn(tr):
            batches = batched(iter(dev_set), args.dev_eval_batch_size,
                              dev_collator)
            result = predict_scores(tr.model, batches, args.task)
            save_as_trec(result, res_path)
            metric = evaluate_run(qrels, result, [args.metric])[args.metric]
            print(f"dev {args.metric}: {metric:.4f}")
            return metric

    def data_iter():
        for _ in range(args.epoch):
            yield from batched(iter(train_set), args.train_batch_size,
                               train_collator, drop_last=True)

    target_iter = CyclingIterator(
        lambda: batched(iter(target_set), args.target_batch_size,
                        train_collator, drop_last=True))

    out = trainer.train(data_iter(), target_iter, eval_fn=eval_fn)
    trainer.save_checkpoint(os.path.join(args.save_folder, "final"))
    if eval_fn is not None:
        eval_fn(trainer)
    w = np.concatenate(out["weights"]) if out["weights"] else np.zeros(1)
    print(f"finished at step {out['final_step']}; "
          f"mean weight {w.mean():.4f}, zero-weight fraction "
          f"{(w == 0).mean():.2f}")
    return out


if __name__ == "__main__":
    main()
