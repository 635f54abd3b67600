"""Shared driver plumbing: logging, tokenizers, the ``--device`` flag, the
ranks of a ``torchrun`` job, the trainers' epoch loop and the v1 drivers'
dataset specs (``DictOrStr``, ``build_v1_tokenizer``)."""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from ..parallel.mesh import (env_world_size, init_distributed, rank_device,
                             world_size)


def setup_logging():
    logging.basicConfig(
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
        level=os.environ.get("OPENMATCH_LOG_LEVEL", "INFO"),
    )


def maybe_init_distributed(device) -> Tuple[int, int]:
    """(rank, world size) of this job (JAX ``maybe_init_distributed``).
    Under a launcher (``torchrun`` sets ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``) with ``WORLD_SIZE`` above 1, the default process group
    is initialised here if it is not yet, with the backend
    ``parallel.mesh.choose_backend`` picks for this rank's ``device``;
    without one the job is the one process (0, 1)."""
    if env_world_size() > 1 and not dist.is_initialized():
        init_distributed(torch.device(device))
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def refuse_ranks(what: str):
    """Raise when this job runs on more than one rank: ``what`` does not
    run over ranks yet."""
    count = max(env_world_size(), world_size())
    if count > 1:
        raise NotImplementedError(
            f"{what} over {count} ranks is not ported to PyTorch yet "
            "(ROADMAP.md, P10)")


def _auto_tokenizer():
    try:
        from transformers import AutoTokenizer
    except ImportError:
        raise RuntimeError(
            "loading a tokenizer needs the 'transformers' package, which is "
            "not installed; construct the service with a tokenizer object "
            "instead") from None
    return AutoTokenizer


def load_tokenizer(model_args):
    """The HF fast tokenizer named by ``--tokenizer_name`` or the model
    path. ``transformers`` is imported here and in ``build_v1_tokenizer``
    only."""
    name = model_args.tokenizer_name or model_args.model_name_or_path
    return _auto_tokenizer().from_pretrained(
        name, cache_dir=model_args.cache_dir, use_fast=True)


class DictOrStr(argparse.Action):
    """v1 dataset specs: a plain path, or ``queries=q.tsv,docs=d.tsv,
    trec=run.trec[,qrels=qrels]`` parsed to a dict for V1Dataset's id-spec
    mode.

    The dict branch is taken only when EVERY comma-part is
    ``<spec key>=value`` for the keys V1Dataset's id-spec mode reads: a
    plain path that happens to contain '=' (``run=3/x.jsonl``) stays a
    string, and a value containing '=' survives (split once per part)."""

    SPEC_KEYS = frozenset({"queries", "docs", "trec", "qrels"})

    def __call__(self, parser, namespace, values, option_string=None):
        parts = [kv.split("=", 1) for kv in values.split(",")]
        if all(len(p) == 2 and p[0] in self.SPEC_KEYS for p in parts):
            setattr(namespace, self.dest, dict(parts))
        else:
            setattr(namespace, self.dest, values)


def build_v1_tokenizer(args):
    """The v1 drivers' tokenizer: bert/roberta/electra load the HF
    tokenizer from -vocab or -pretrain; every other model gets the
    WordTokenizer over -vocab or a -pretrain GloVe file."""
    if args.model in ("bert", "roberta", "electra"):
        src = args.vocab or args.pretrain
        if not src:
            raise ValueError(
                f"-model {args.model} needs -vocab or -pretrain to locate "
                "the HF tokenizer")
        return _auto_tokenizer().from_pretrained(src)
    from ..v1.tokenizer import WordTokenizer

    return WordTokenizer(vocab=args.vocab, pretrained=args.pretrain)


def split_device_flag(argv: Optional[List[str]]) -> Tuple[object, List[str]]:
    """Take ``--device`` (default ``cuda``) off the command line; the rest
    are the JAX drivers' flags. The CPU runs only when named. Under a
    launcher of several ranks ``cuda`` is this rank's card
    (``parallel.mesh.rank_device``)."""
    extra = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    extra.add_argument("--device", default="cuda",
                       help="cuda | cuda:N | cpu (default cuda)")
    args, rest = extra.parse_known_args(
        list(argv) if argv is not None else sys.argv[1:])
    return rank_device(args.device), rest


def epochs_iterator(dataset, collator, batch_size: int, num_epochs: int,
                    seed: int):
    """Epoch-looped batched stream for trainers (JAX ``epochs_iterator``);
    the hashed seed mirrors the reference's per-epoch sampling."""
    from ..data.loader import batched, prefetch

    hashed_seed = hash(seed) % (2**31)
    for epoch in range(max(num_epochs, 1)):
        stream = batched(dataset.epoch_iterator(epoch, hashed_seed),
                         batch_size, collator, drop_last=True)
        yield from prefetch(stream, depth=4)
