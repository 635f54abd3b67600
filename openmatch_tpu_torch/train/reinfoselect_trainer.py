"""ReInfoSelect training mode for the v1 rerankers (port of
``openmatch_tpu/train/reinfoselect_trainer.py``), the ``-reinfoselect``
mode of ``train_v1``.

Per batch, a classification policy scores the positive pair,
gumbel-softmax(tau) plus a categorical draw picks keep / drop per pair,
and the ranker trains on the kept pairs: the per-pair loss is weighted by
the keep mask and divided by max(kept, 1). A batch where no pair is kept
takes no optimizer step, so the optimizer's own update count (which the
learning-rate schedule reads) does not advance, while the trainer's step
does, as in JAX, whose step counter then runs one ahead of optax's count.

Every ``eval_steps`` steps the dev metric is evaluated, the best
checkpoint kept, and the policy REINFORCE-updated with reward = the
metric's change (``research.reinfoselect.make_policy_refresh`` over the
buffered ``(policy inputs, Gumbel noise, actions)`` of each step);
``reset`` then restores the ranker's best parameters. The policy's
optimizer is plain Adam (the port's ``OptaxAdam`` with no clipping, decay
or schedule).
"""

from __future__ import annotations

import logging
import os
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..research.reinfoselect import make_policy_refresh, select_pairs
from .state import OptaxAdam
from .v1_trainer import V1Trainer, to_device

logger = logging.getLogger(__name__)


def per_pair_ranking_loss(pos_scores, neg_scores, kind: str,
                          margin: float = 1.0) -> torch.Tensor:
    """The [B] per-pair form of ``v1_trainer.ranking_loss``."""
    if kind == "margin_loss":
        return F.relu(margin - torch.tanh(pos_scores)
                      + torch.tanh(neg_scores))
    if kind == "CE_loss":
        p = torch.sigmoid(pos_scores - neg_scores)
        return -torch.log(torch.clamp(p, 1e-10, 1.0))
    if kind == "triplet_loss":
        logits = torch.stack([pos_scores, neg_scores], dim=1)
        return -F.log_softmax(logits, dim=1)[:, 0]
    raise ValueError(f"Unknown ranking loss {kind}")


def per_example_loss(trainer, score: Callable, batch: Dict) -> torch.Tensor:
    """[B] losses of ``trainer``'s task on a device batch: per pair for
    ranking, cross-entropy per example for classification.
    ``score(batch) -> scores``."""
    if trainer.task == "ranking":
        pos_batch, neg_batch = trainer.pos_neg_split(batch)
        return per_pair_ranking_loss(score(pos_batch), score(neg_batch),
                                     trainer.loss_kind, trainer.args.margin)
    batch = dict(batch)
    labels = batch.pop("label")
    return F.cross_entropy(score(batch).float(), labels.long(),
                           reduction="none")


def policy_inputs_from_batch(batch: Dict) -> Dict:
    """The policy scores the POSITIVE pair: cross-encoder inputs for BERT
    batches, the word channel's query / doc tensors for word models and
    EDRM (the Conv-KNRM policy reads only the word channel)."""
    if "pos_input_ids" in batch:  # bert ranking batch
        return {"input_ids": batch["pos_input_ids"],
                "input_mask": batch["pos_input_mask"],
                "segment_ids": batch["pos_segment_ids"]}
    if "input_ids" in batch:  # bert classification batch
        return {"input_ids": batch["input_ids"],
                "input_mask": batch["input_mask"],
                "segment_ids": batch["segment_ids"]}
    if "query_wrd_idx" in batch:  # EDRM batch
        # classification EDRM batches carry one doc channel (doc_wrd_*),
        # ranking batches the pos / neg pair (doc_pos_wrd_*)
        doc = "doc_pos_wrd" if "doc_pos_wrd_idx" in batch else "doc_wrd"
        return {"query_idx": batch["query_wrd_idx"],
                "query_mask": batch["query_wrd_mask"],
                "doc_idx": batch[f"{doc}_idx"],
                "doc_mask": batch[f"{doc}_mask"]}
    if "doc_pos_idx" in batch:  # ranking word batch
        return {"query_idx": batch["query_idx"],
                "query_mask": batch["query_mask"],
                "doc_idx": batch["doc_pos_idx"],
                "doc_mask": batch["doc_pos_mask"]}
    # classification batch: the single pair
    return {"query_idx": batch["query_idx"],
            "query_mask": batch["query_mask"],
            "doc_idx": batch["doc_idx"], "doc_mask": batch["doc_mask"]}


class ReInfoSelectTrainer(V1Trainer):
    """select -> masked train -> dev eval -> REINFORCE.

    ``model`` is the ranker (a ``v1/models.py`` model), ``policy`` the
    keep / drop policy module; ``policy_score_fn(inputs) -> [B, 2]``
    defaults to ``policy.score_batch(inputs)[0]`` over
    ``policy_inputs_from_batch``'s tensors. Both train on ``device``."""

    def __init__(self, model, policy, train_args, total_steps: int,
                 task: str = "ranking", ranking_loss_kind: str = "margin_loss",
                 tau: float = 1.0, reset: bool = False,
                 pos_neg_split: Optional[Callable] = None, device="cuda",
                 policy_score_fn: Optional[Callable] = None):
        super().__init__(model, train_args, total_steps, task=task,
                         ranking_loss_kind=ranking_loss_kind,
                         pos_neg_split=pos_neg_split, device=device)
        self.tau = tau
        self.reset = reset
        self.policy = policy.to(self.device).train()
        self.policy_score_fn = policy_score_fn or (
            lambda inputs: self.policy.score_batch(inputs)[0])
        # plain Adam for the policy: no clip, no decay, a constant lr
        self.policy_optimizer = OptaxAdam(list(self.policy.parameters()),
                                          lr=train_args.learning_rate)
        self._refresh_fn = make_policy_refresh(
            self.policy_score_fn, self.policy_optimizer, tau)
        self._buffer = []  # (policy inputs, gumbel noise, actions) a step
        self.keep_rates = []  # fraction kept per step

    def _score(self, batch):
        return self.model.score_batch(batch)[0]

    def train_step(self, batch: Dict[str, Any],
                   generator: Optional[torch.Generator] = None):
        """One selection step: returns (loss, actions); the optimizer steps
        only when a pair is kept, the trainer's step always advances."""
        self.model.train()
        batch = to_device(batch, self.device)
        inputs = policy_inputs_from_batch(batch)
        with torch.no_grad():
            logits = self.policy_score_fn(inputs)
        actions, noise = select_pairs(logits, self.tau, generator)
        mask = actions.to(torch.float32)
        kept = float(mask.sum())
        self.optimizer.zero_grad(set_to_none=True)
        per = per_example_loss(self, self._score, batch)
        loss = (per * mask).sum() / max(kept, 1.0)
        if kept > 0:
            loss.backward()
            self.optimizer.step()
            self.scheduler.step()
        self.step += 1
        self._buffer.append((inputs, noise, actions))
        return loss.detach(), actions

    def train(self, data_iter: Iterable, eval_fn: Callable,
              generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """``eval_fn(trainer) -> dev metric``: called before training (the
        initial dev pass) and every ``args.eval_steps`` steps for the
        REINFORCE reward. ``generator`` (default: seeded with
        ``args.seed`` on the device) draws the selections."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(
                self.args.seed)
        best_dir = os.path.join(self.args.output_dir, "best")
        best_mes = last_mes = eval_fn(self)
        self.save_checkpoint(best_dir)
        logger.info(f"initial dev metric {best_mes:.4f}")
        best_state = _snapshot(self.model)
        losses = []
        for batch in data_iter:
            if self.total_steps > 0 and self.step >= self.total_steps:
                break
            loss, actions = self.train_step(batch, generator)
            losses.append(float(loss))
            self.keep_rates.append(float(actions.float().mean()))
            step = self.step
            if self.args.eval_steps and step % self.args.eval_steps == 0 \
                    and self._buffer:
                mes = eval_fn(self)
                if mes >= best_mes:
                    best_mes = mes
                    best_state = _snapshot(self.model)
                    self.save_checkpoint(best_dir)
                reward = mes - last_mes
                last_mes = mes
                self.refresh_policy(reward)
                logger.info(
                    f"step {step}: dev {mes:.4f} (best {best_mes:.4f}), "
                    f"reward {reward:+.4f}, keep-rate "
                    f"{np.mean(self.keep_rates[-self.args.eval_steps:]):.2f}")
                if self.reset:
                    self.model.load_state_dict(best_state)
                    last_mes = best_mes
        return {"losses": losses, "final_step": self.step,
                "best_metric": best_mes, "keep_rates": self.keep_rates}

    def refresh_policy(self, reward: float):
        """REINFORCE-update the policy over the buffered steps; clears the
        buffer."""
        if not self._buffer:
            return
        self.policy.train()
        self._refresh_fn(self._buffer, reward)
        self._buffer = []


def _snapshot(model) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}
