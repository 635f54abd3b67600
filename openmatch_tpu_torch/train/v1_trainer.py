"""Trainer of the v1 rerankers, KNRM to BertMaxP (port of
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

Over ranks (``parallel/mesh.py``; JAX's ``make_replicated_state`` mesh of
every device, dp = the world): parameters start as rank 0's
(``state.make_replicated_state``), ``train_step`` takes the GLOBAL batch,
as JAX's does, and each rank keeps its contiguous ``1/dp`` of the rows
(``shard_batch``, which refuses a batch that does not split evenly). The
pos / neg split keys by name, so a row keeps its pair. The mean losses'
gradients and the loss are averaged over the ranks by one flat all-reduce
after backward (then clipped by the optimizer), so every rank takes the
same update as one process over the global batch. The dev evaluation runs
on rank 0 and its metric is broadcast, so every rank makes the same
"best" decision; only rank 0 writes checkpoints. The parameters are
replicated, so ``tp_size > 1`` is refused: it would only repeat the work.
The Meta-LTR and ReInfoSelect trainers build on this class.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..device import resolve_device
from ..models.flax_msgpack import read_flax_msgpack
from ..models.jax_convert import v1_params_from_jax, v1_params_to_jax
from ..parallel.mesh import (MODEL_AXIS, Mesh, broadcast, make_mesh,
                             reduce_grads, shard_batch)
from .state import (TRAIN_STATE, make_replicated_state, optax_state_tree,
                    save_train_state)

logger = logging.getLogger(__name__)


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
                 pos_neg_split: Optional[Callable] = None, device="cuda",
                 mesh: Optional[Mesh] = None):
        """``model``: a ``v1/models.py`` model, trained in place on
        ``device`` (the card unless the caller names the CPU).
        ``pos_neg_split(batch) -> (pos_batch, neg_batch)`` for ranking,
        by default on the doc_pos_* / doc_neg_* and pos_* / neg_* keys.
        ``mesh``: this rank's place among the job's ranks; by default
        ``make_mesh(dp_size, tp_size)`` over every rank (one without a
        process group)."""
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else make_mesh(
            train_args.dp_size, train_args.tp_size, self.device)
        if self.mesh.shape[MODEL_AXIS] > 1:
            raise ValueError(
                f"{type(self).__name__} holds replicated parameters: "
                "tp_size > 1 would only repeat the work on the model axis; "
                "train with tp_size=1 (DRTrainer is the TP-capable trainer)")
        self.model = model.to(self.device).train()
        self.args = train_args
        self.task = task
        self.loss_kind = ranking_loss_kind
        self.total_steps = total_steps
        self.pos_neg_split = pos_neg_split or _default_pos_neg_split
        self.step = 0
        self.optimizer, self.scheduler = make_replicated_state(
            self.model.parameters(), train_args, total_steps, self.mesh)

    @property
    def is_main(self) -> bool:
        """Whether this rank writes (rank 0)."""
        return self.mesh.rank == 0

    def local_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """This rank's rows of a global batch, as tensors on the device."""
        batch = {k: v for k, v in batch.items() if not isinstance(v, list)}
        return to_device(shard_batch(batch, self.mesh), self.device)

    def evaluate(self, eval_fn: Callable) -> float:
        """``eval_fn(self)`` on rank 0; its metric on every rank."""
        metric = float(eval_fn(self)) if self.is_main else 0.0
        if self.mesh.group("world") is None:
            return metric
        t = torch.tensor([metric], dtype=torch.float64,
                         device=self.mesh.device)
        return float(broadcast(t, self.mesh)[0])

    def _barrier(self):
        if self.mesh.group("world") is not None:
            dist.barrier()

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
        """One update from a global batch (this rank trains on its rows);
        returns the global batch's loss, still on the device."""
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss(self.local_batch(batch))
        loss.backward()
        (loss,) = reduce_grads(self.model.parameters(), self.mesh, [loss])
        self.optimizer.step()
        self.scheduler.step()
        self.step += 1
        return loss[0]

    def train(self, data_iter: Iterable, eval_fn=None) -> Dict[str, Any]:
        """``eval_fn(trainer) -> metric`` every ``eval_steps`` (on rank 0);
        the best metric's model is saved to ``output_dir/best``."""
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
                metric = self.evaluate(eval_fn)
                if metric > best_metric:
                    best_metric = metric
                    self.save_checkpoint(os.path.join(self.args.output_dir,
                                                      "best"))
        return {"losses": losses, "final_step": self.step,
                "best_metric": best_metric}

    def save_checkpoint(self, output_dir: Optional[str] = None) -> str:
        """``train_state.msgpack`` and ``train_state.json``, written by rank
        0 (every rank calls it)."""
        out = output_dir or os.path.join(self.args.output_dir,
                                         f"checkpoint-{self.step}")
        if self.is_main:
            to_jax = lambda named: v1_params_to_jax(  # noqa: E731
                named, self.model.num_heads)
            save_train_state(out, self.step, to_jax(self.model.state_dict()),
                             optax_state_tree(self.optimizer,
                                              self.model.named_parameters(),
                                              to_jax))
        self._barrier()
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
