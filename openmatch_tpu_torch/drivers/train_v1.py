"""Train a v1 reranker: KNRM, Conv-KNRM, TK, EDRM, or a BERT-family
BertRanker / BertMaxP (port of the JAX ``train_v1`` driver).

    python -m openmatch_tpu_torch.drivers.train_v1 \
        -model knrm -task ranking -ranking_loss margin_loss \
        -train train.jsonl -dev dev.jsonl -qrels qrels \
        -vocab vocab.txt [-pretrain glove.txt] \
        -save checkpoints/knrm -res results/knrm.trec \
        -epoch 1 -batch_size 8 -lr 0.001 -eval_every 100 [--device cuda]

The JAX driver's flags, plus ``--device`` (default ``cuda``; the CPU only
when named). ``-model bert|roberta|electra`` take an HF checkpoint
directory as ``-pretrain`` and compute in fp32; ``-maxp`` makes it
BertMaxP. ``-save`` receives ``train_state.msgpack`` in the JAX package's
layout, which either package's ``inference_v1`` and ``gen_feature`` read.
``-reinfoselect`` trains in ReInfoSelect's data-selection mode: a
Conv-KNRM classification policy (a BERT one for the BERT models) picks the
pairs that train the ranker and is updated by REINFORCE on the dev
metric's change (``train/reinfoselect_trainer.py``); ``-reset`` restores
the best ranker after each policy update, ``-tau`` is the gumbel-softmax
temperature.
``main`` takes ``tokenizer=`` (an HF-style tokenizer for the BERT models, a
``WordTokenizer`` for the others) in place of loading one.

On N ranks (JAX's trainers take every device of the host)::

    torchrun --nproc_per_node=N -m openmatch_tpu_torch.drivers.train_v1 ...

every rank reads the same batches of ``-batch_size`` pairs, the GLOBAL
batch as in JAX, and trains on its ``1/N`` of the rows (the batch must
split evenly); rank 0 alone evaluates (its metric broadcast) and writes
``-save`` and ``-res``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..config import TrainingArguments
from ..data.loader import batched
from ..models.hf_convert import load_bert_encoder
from ..train.reinfoselect_trainer import ReInfoSelectTrainer
from ..train.v1_trainer import V1Trainer, predict_scores
from ..utils.metrics import evaluate_run, load_qrels
from ..utils.trec import save_as_trec
from ..v1.dataset import BertPairCollator, V1Dataset, WordCollator
from ..v1.long_doc import BertMaxPCollator, EDRMCollator
from ..v1.models import EDRM, KNRM, TK, BertMaxP, BertRanker, ConvKNRM
from ..v1.tokenizer import WordTokenizer
from .common import (DictOrStr, build_v1_tokenizer, maybe_init_distributed,
                     setup_logging, split_device_flag)

BERT_MODELS = ("bert", "roberta", "electra")


def _seeded(seed: int, build):
    """``build()`` with the CPU generator seeded, the global state kept."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build()


def _load_embeddings(embedder, tokenizer):
    matrix = tokenizer.get_embed_matrix()
    if matrix is not None:
        with torch.no_grad():
            embedder.embedding.copy_(torch.from_numpy(
                np.asarray(matrix, np.float32)))


def _word_embed_dim(args, tokenizer) -> int:
    return (tokenizer.get_embed_dim() if tokenizer.get_embed_dim() > 0
            else args.embed_dim)


def build_word_model(args, tokenizer):
    vocab_size = tokenizer.get_vocab_size()
    embed_dim = _word_embed_dim(args, tokenizer)
    if args.model == "knrm":
        cls, kw = KNRM, {}
    elif args.model in ("cknrm", "conv_knrm"):
        cls, kw = ConvKNRM, {}
    elif args.model == "tk":
        cls, kw = TK, {}
    else:
        raise ValueError(f"Unknown v1 model {args.model}")
    model = _seeded(args.seed, lambda: cls(
        vocab_size=vocab_size, embed_dim=embed_dim, task=args.task, **kw))
    _load_embeddings(model.embedder, tokenizer)
    return model


def build_edrm_model(args, tokenizer, ent_tokenizer):
    """EDRM: the word channel plus an entity channel enriched by
    description convolutions."""
    model = _seeded(args.seed, lambda: EDRM(
        wrd_vocab_size=tokenizer.get_vocab_size(),
        ent_vocab_size=ent_tokenizer.get_vocab_size(),
        wrd_embed_dim=_word_embed_dim(args, tokenizer),
        ent_embed_dim=args.kernel_dim, max_des_len=args.max_des_len,
        max_ent_num=args.max_ent_num, kernel_dim=args.kernel_dim,
        task=args.task))
    _load_embeddings(model.wrd_embedder, tokenizer)
    return model


def build_bert_ranker(pretrain: str, mode: str, task: str, seed: int = 42,
                      maxp: bool = False, num_passages: int = 4):
    """BertRanker (BertMaxP when ``maxp``) over an HF checkpoint directory,
    fp32."""
    config, enc_state = load_bert_encoder(pretrain)
    if mode == "pooling" and not config.add_pooler:
        raise ValueError(
            "-bert_mode pooling needs a BERT checkpoint with a pooler; "
            "this checkpoint has none (roberta/electra): use the "
            "default cls mode")
    if maxp:
        model = _seeded(seed, lambda: BertMaxP(
            config, num_passages=num_passages, mode=mode, task=task))
    else:
        model = _seeded(seed, lambda: BertRanker(config, mode=mode,
                                                 task=task))
    model.bert.load_state_dict(enc_state, strict=True)
    return model


def build_policy(args, tokenizer):
    """ReInfoSelect's keep / drop policy for the word models and EDRM: a
    Conv-KNRM with a 2-class head over the positive pair, sharing the
    ranker's vocabulary and pretrained embeddings, built from
    ``args.seed + 1``."""
    model = _seeded(args.seed + 1, lambda: ConvKNRM(
        vocab_size=tokenizer.get_vocab_size(),
        embed_dim=_word_embed_dim(args, tokenizer), task="classification"))
    _load_embeddings(model.embedder, tokenizer)
    return model


def _ent_tokenizer(args):
    if not getattr(args, "ent_vocab", None):
        raise ValueError("-model edrm requires -ent_vocab (entity vocab file)")
    return WordTokenizer(vocab=args.ent_vocab, if_swr=False, if_stem=False)


def build_v1_collator(args, tokenizer, mode: str):
    """The collator of ``args.model`` for ``mode`` (train | dev | test):
    EDRM's carries the entity fields, the BERT models' pair
    [CLS] q [SEP] d [SEP] from an HF-style tokenizer (BertMaxP's, one such
    input per passage)."""
    if args.model in BERT_MODELS:
        if getattr(args, "maxp", False):
            return BertMaxPCollator(tokenizer, args.max_query_len,
                                    args.max_doc_len, mode=mode,
                                    task=args.task)
        return BertPairCollator(tokenizer, args.max_query_len,
                                args.max_doc_len, mode=mode, task=args.task)
    if args.model == "edrm":
        return EDRMCollator(tokenizer, _ent_tokenizer(args),
                            args.max_query_len, args.max_doc_len,
                            args.max_ent_num, args.max_des_len, mode=mode,
                            task=args.task)
    return WordCollator(tokenizer, args.max_query_len, args.max_doc_len,
                        mode=mode, task=args.task)


def build_v1_model(args, tokenizer):
    """The v1 model ``args`` name, built on the CPU from ``args.seed``."""
    if args.model in BERT_MODELS:
        if not getattr(args, "pretrain", None):
            raise ValueError(
                f"-model {args.model} requires -pretrain (HF checkpoint dir)")
        return build_bert_ranker(args.pretrain,
                                 getattr(args, "bert_mode", "cls"),
                                 args.task, args.seed,
                                 maxp=bool(getattr(args, "maxp", False)))
    if args.model == "edrm":
        return build_edrm_model(args, tokenizer, _ent_tokenizer(args))
    return build_word_model(args, tokenizer)


def add_model_args(parser):
    """The model flags train_v1, inference_v1 and gen_feature share."""
    parser.add_argument("-task", default="ranking")
    parser.add_argument("-model", default="knrm")
    parser.add_argument("-vocab", default=None)
    parser.add_argument("-pretrain", default=None,
                        help="GloVe embedding file, or the HF checkpoint "
                             "of -model bert")
    parser.add_argument("-ent_vocab", default=None,
                        help="entity vocab file (edrm)")
    parser.add_argument("-max_ent_num", type=int, default=3)
    parser.add_argument("-max_des_len", type=int, default=20)
    parser.add_argument("-kernel_dim", type=int, default=128)
    parser.add_argument("-embed_dim", type=int, default=100)
    parser.add_argument("-max_query_len", type=int, default=10)
    parser.add_argument("-max_doc_len", type=int, default=256)
    parser.add_argument("-seed", type=int, default=42)
    parser.add_argument("-bert_mode", default="cls", choices=["cls", "pooling"],
                        help="BertRanker rep for -model bert")
    parser.add_argument("-maxp", action="store_true", default=False,
                        help="BertMaxP chunk-and-maxpool long-doc scoring")


def main(argv=None, tokenizer=None):
    """Returns the trainer's ``{"losses", "final_step", "best_metric"}``
    (and ``"keep_rates"`` under ``-reinfoselect``)."""
    setup_logging()
    device, rest = split_device_flag(argv)
    parser = argparse.ArgumentParser()
    add_model_args(parser)
    parser.add_argument("-ranking_loss", default="margin_loss")
    parser.add_argument("-train", required=True, action=DictOrStr)
    parser.add_argument("-dev", default=None, action=DictOrStr)
    parser.add_argument("-qrels", default=None)
    parser.add_argument("-save", default="./checkpoints/v1")
    parser.add_argument("-res", default="./results/v1.trec")
    parser.add_argument("-metric", default="ndcg_cut_10")
    parser.add_argument("-epoch", type=int, default=1)
    parser.add_argument("-batch_size", type=int, default=8)
    parser.add_argument("-lr", type=float, default=1e-3)
    parser.add_argument("-eval_every", type=int, default=1000)
    parser.add_argument("-max_input", type=int, default=1_280_000)
    parser.add_argument("-reinfoselect", action="store_true", default=False,
                        help="ReInfoSelect data-selection mode: a "
                             "classification policy picks which pairs train "
                             "the ranker, updated by REINFORCE on the "
                             "dev-metric delta")
    parser.add_argument("-reset", action="store_true", default=False,
                        help="reload the best ranker after each policy "
                             "refresh")
    parser.add_argument("-tau", type=float, default=1.0,
                        help="gumbel-softmax temperature")
    args = parser.parse_args(rest)
    maybe_init_distributed(device)
    if args.maxp and args.reinfoselect:
        raise ValueError("-maxp and -reinfoselect cannot combine (the policy "
                         "scores flat cross-encoder inputs)")
    if tokenizer is None:
        tokenizer = build_v1_tokenizer(args)
    model = build_v1_model(args, tokenizer)

    train_set = V1Dataset(args.train, mode="train", task=args.task,
                          max_input=args.max_input)
    train_collator = build_v1_collator(args, tokenizer, "train")
    steps_per_epoch = max(len(train_set) // args.batch_size, 1)
    total_steps = steps_per_epoch * args.epoch

    train_args = TrainingArguments(
        output_dir=args.save, learning_rate=args.lr, warmup_ratio=0.1,
        logging_steps=max(args.eval_every, 1), eval_steps=args.eval_every,
        save_steps=0, seed=args.seed, margin=1.0,
    )
    if args.reinfoselect:
        if not (args.dev and args.qrels):
            raise ValueError("-reinfoselect needs -dev and -qrels: the "
                             "policy's REINFORCE reward is the dev-metric "
                             "delta")
        if args.model in BERT_MODELS:
            policy = build_bert_ranker(args.pretrain, args.bert_mode,
                                       "classification", args.seed + 1)
        else:
            policy = build_policy(args, tokenizer)
        trainer = ReInfoSelectTrainer(
            model, policy, train_args, total_steps, task=args.task,
            ranking_loss_kind=args.ranking_loss, tau=args.tau,
            reset=args.reset, device=device)
    else:
        trainer = V1Trainer(model, train_args, total_steps, task=args.task,
                            ranking_loss_kind=args.ranking_loss,
                            device=device)

    eval_fn = None
    if args.dev and args.qrels:
        dev_set = V1Dataset(args.dev, mode="dev", task=args.task,
                            max_input=args.max_input)
        dev_collator = build_v1_collator(args, tokenizer, "dev")
        qrels = load_qrels(args.qrels)

        def eval_fn(tr):
            batches = batched(iter(dev_set), args.batch_size, dev_collator)
            result = predict_scores(tr.model, batches, args.task)
            os.makedirs(os.path.dirname(args.res) or ".", exist_ok=True)
            save_as_trec(result, args.res)
            metric = evaluate_run(qrels, result, [args.metric])[args.metric]
            print(f"dev {args.metric}: {metric:.4f}")
            return metric

    def data_iter():
        for _ in range(args.epoch):
            yield from batched(iter(train_set), args.batch_size,
                               train_collator, drop_last=True)

    if args.reinfoselect:
        out = trainer.train(data_iter(), eval_fn)
        rates = out["keep_rates"]
        if trainer.is_main:
            print(f"keep-rate {np.mean(rates):.2f} over {len(rates)} "
                  "selection steps")
    else:
        out = trainer.train(data_iter(), eval_fn=eval_fn)
    trainer.save_checkpoint(args.save)
    if eval_fn is not None:
        trainer.evaluate(eval_fn)
    if trainer.is_main:
        print(f"finished at step {out['final_step']}")
    return out


if __name__ == "__main__":
    main()
