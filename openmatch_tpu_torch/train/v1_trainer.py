"""Trainer of the v1 rerankers, KNRM to BertMaxP, on one device (port of
``openmatch_tpu/train/v1_trainer.py``).

- Tasks: ``ranking`` (two forwards a step, one on the positive pairs and
  one on the negatives, split by ``_default_pos_neg_split``) with the
  losses ``margin_loss`` (on tanh'd scores), ``CE_loss`` (BCE on
  sigmoid(pos - neg)) and ``triplet_loss`` (log-softmax over [pos, neg]);
  ``classification`` (cross-entropy over two logits).
- The optimizer is the port's ``OptaxAdam`` with the JAX package's
  defaults: AdamW, global-norm clip, linear warmup and decay.
- A dev evaluation every ``eval_steps`` keeps the ``best`` checkpoint.
- ``save_checkpoint`` writes ``train_state.msgpack`` in the JAX package's
  layout (``{"step", "params", "opt_state"}``, the Flax tree and optax's
  chain state: ``{"0": {}, "1": {"0": {"count", "mu", "nu"}, "1": {},
  "2": {"count"}}}`` for the default clip -> adamw) with the port's own
  codec, and ``train_state.json``. The JAX package's ``load_train_state``
  reads it; the port's ``load_v1_params`` reads the ``params`` of either
  package's file.

One process and one device: more, or ``dp_size > 1``, raises (the V1,
Meta-LTR and ReInfoSelect trainers over ranks are ROADMAP P10's rest).
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..models.flax_msgpack import read_flax_msgpack, write_flax_msgpack
from ..models.jax_convert import v1_params_from_jax, v1_params_to_jax
from ..parallel.mesh import world_size
from .state import make_optimizer, optax_state_tree

logger = logging.getLogger(__name__)

_MULTI_PROCESS_TODO = ("{} is not ported to PyTorch yet: the V1, Meta-LTR "
                       "and ReInfoSelect trainers train on one process and "
                       "one device (ROADMAP.md, P10: the trainers over "
                       "ranks)")

TRAIN_STATE = "train_state.msgpack"


def ranking_loss(pos_scores, neg_scores, kind: str, margin: float = 1.0):
    if kind == "margin_loss":
        # MarginRankingLoss(margin) on tanh'd scores
        return torch.mean(F.relu(margin - torch.tanh(pos_scores)
                                 + torch.tanh(neg_scores)))
    if kind == "CE_loss":
        # BCE(sigmoid(pos - neg), 1)
        p = torch.sigmoid(pos_scores - neg_scores)
        return torch.mean(-torch.log(torch.clamp(p, 1e-10, 1.0)))
    if kind == "triplet_loss":
        logits = torch.stack([pos_scores, neg_scores], dim=1)
        return torch.mean(-F.log_softmax(logits, dim=1)[:, 0])
    raise ValueError(f"Unknown ranking loss {kind}")


def classification_loss(logits, labels):
    """Softmax cross-entropy with integer labels, averaged."""
    return F.cross_entropy(logits.float(), labels.long())


def _default_pos_neg_split(batch):
    pos = {}
    neg = {}
    for k, v in batch.items():
        if "pos" in k:
            pos[k.replace("doc_pos", "doc").replace("pos_", "")] = v
        elif "neg" in k:
            neg[k.replace("doc_neg", "doc").replace("neg_", "")] = v
        else:
            pos[k] = v
            neg[k] = v
    return pos, neg


def _score(model, batch):
    return model.score_batch(batch)[0]


def to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """The batch's arrays as tensors on ``device``; lists (ids) dropped."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()
            if not isinstance(v, list)}


class V1Trainer:
    def __init__(self, model, train_args, total_steps: int,
                 task: str = "ranking", ranking_loss_kind: str = "margin_loss",
                 pos_neg_split: Optional[Callable] = None, device="cuda"):
        """``model``: a ``v1/models.py`` model, trained in place on
        ``device`` (the card unless the caller names the CPU).
        ``pos_neg_split(batch) -> (pos_batch, neg_batch)`` for ranking,
        by default on the doc_pos_* / doc_neg_* and pos_* / neg_* keys."""
        self.device = resolve_device(device)
        if world_size() > 1:
            raise NotImplementedError(_MULTI_PROCESS_TODO.format(
                f"training on {world_size()} processes"))
        if train_args.dp_size > 1 or train_args.tp_size > 1:
            raise NotImplementedError(_MULTI_PROCESS_TODO.format(
                f"dp_size={train_args.dp_size}, tp_size={train_args.tp_size}"))
        self.model = model.to(self.device).train()
        self.args = train_args
        self.task = task
        self.loss_kind = ranking_loss_kind
        self.total_steps = total_steps
        self.pos_neg_split = pos_neg_split or _default_pos_neg_split
        self.step = 0
        self.optimizer, self.scheduler = make_optimizer(
            list(self.model.parameters()), train_args, total_steps)

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        if self.task == "ranking":
            pos_batch, neg_batch = self.pos_neg_split(batch)
            pos = _score(self.model, pos_batch)
            neg = _score(self.model, neg_batch)
            return ranking_loss(pos, neg, self.loss_kind, self.args.margin)
        batch = dict(batch)
        labels = batch.pop("label")
        return classification_loss(_score(self.model, batch), labels)

    def train_step(self, batch: Dict[str, Any]) -> torch.Tensor:
        """One update; returns the loss, still on the device."""
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss(to_device(batch, self.device))
        loss.backward()
        self.optimizer.step()
        self.scheduler.step()
        self.step += 1
        return loss.detach()

    def train(self, data_iter: Iterable, eval_fn=None) -> Dict[str, Any]:
        """``eval_fn(trainer) -> metric`` every ``eval_steps``; the best
        metric's model is saved to ``output_dir/best``."""
        losses, log_loss = [], 0.0
        best_metric = -np.inf
        for batch in data_iter:
            if self.total_steps > 0 and self.step >= self.total_steps:
                break
            log_loss = log_loss + self.train_step(batch)
            step = self.step
            if step % self.args.logging_steps == 0 and step > 0:
                avg = float(log_loss) / self.args.logging_steps
                logger.info(f"step {step}/{self.total_steps} loss {avg:.4f}")
                losses.append(avg)
                log_loss = 0.0
            if eval_fn is not None and self.args.eval_steps and step > 0 \
                    and step % self.args.eval_steps == 0:
                metric = eval_fn(self)
                if metric > best_metric:
                    best_metric = metric
                    self.save_checkpoint(os.path.join(self.args.output_dir,
                                                      "best"))
        return {"losses": losses, "final_step": self.step,
                "best_metric": best_metric}

    def save_checkpoint(self, output_dir: Optional[str] = None) -> str:
        out = output_dir or os.path.join(self.args.output_dir,
                                         f"checkpoint-{self.step}")
        os.makedirs(out, exist_ok=True)
        payload = {
            "step": np.asarray(self.step, np.int32),
            "params": v1_params_to_jax(self.model.state_dict(),
                                       self.model.num_heads),
            "opt_state": optax_state_tree(
                self.optimizer, self.model.named_parameters(),
                lambda named: v1_params_to_jax(named, self.model.num_heads)),
        }
        write_flax_msgpack(payload, os.path.join(out, TRAIN_STATE))
        with open(os.path.join(out, "train_state.json"), "w") as f:
            json.dump({"step": self.step}, f)
        return out


def load_v1_params(model, ckpt_dir: str):
    """The ``params`` of ``ckpt_dir/train_state.msgpack``, written by
    either package, loaded into ``model`` (strict); returns ``model``."""
    payload = read_flax_msgpack(os.path.join(ckpt_dir, TRAIN_STATE))
    model.load_state_dict(v1_params_from_jax(payload["params"]), strict=True)
    return model


@torch.no_grad()
def predict_scores(model, batches: Iterable[Dict], task: str = "ranking",
                   device=None):
    """Batch scoring to {qid: {did: score}}: classification scores are the
    softmax P(class 1), and a doc id seen twice for a query keeps its
    highest score."""
    device = device or next(model.parameters()).device
    model.eval()
    result: Dict[str, Dict[str, float]] = {}
    for batch in batches:
        qids = batch.pop("query_id")
        dids = batch.pop("doc_id")
        batch.pop("retrieval_score", None)
        batch.pop("label", None)
        scores = _score(model, to_device(batch, device))
        if scores.ndim == 2:  # classification -> P(relevant)
            scores = torch.softmax(scores, dim=-1)[:, 1]
        scores = scores.float().cpu().numpy()
        for qid, did, s in zip(qids, dids, scores):
            bucket = result.setdefault(qid, {})
            if did not in bucket or s > bucket[did]:
                bucket[did] = float(s)
    return result
