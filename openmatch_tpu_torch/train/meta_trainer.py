"""Meta learning-to-reweight trainer (Meta-LTR) for the v1 rerankers (port
of ``openmatch_tpu/train/meta_trainer.py``).

Per source batch, one virtual SGD step on the eps-weighted source loss,
the TARGET-domain batch's loss differentiated back to eps, and
relu(-grad_eps) / sum as each pair's weight in the real update
(``research.meta_ltr``). The virtual learning rate is the live warmup
schedule's at the trainer's step. The target batches cycle independently
of the source batches (``CyclingIterator``); each step's weights can be
logged to a file, and a dev evaluation every ``eval_steps`` keeps the best
checkpoint. Checkpoints are ``V1Trainer``'s: ``train_state.msgpack`` in the
JAX package's layout.

Over ranks (``V1Trainer``'s data mesh) both global batches are split by
rows and the step computes JAX's SPMD numbers (``research.meta_ltr``): the
weights over the global batch, the gradient summed. ``train_step``
returns the global batch's weights in row order on every rank, and rank 0
alone logs them.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Callable, Dict, Iterable, Iterator, Optional

import numpy as np
import torch
from torch.func import functional_call

from ..parallel.mesh import DATA_AXIS, all_gather
from ..research.meta_ltr import make_meta_train_step
from .reinfoselect_trainer import per_example_loss
from .state import linear_warmup_schedule
from .v1_trainer import V1Trainer

logger = logging.getLogger(__name__)


class CyclingIterator:
    """Endless target-batch source: restarts ``make_iter()`` when it is
    exhausted, and raises if a fresh one yields nothing."""

    def __init__(self, make_iter: Callable[[], Iterator]):
        self._make = make_iter
        self._it = make_iter()

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self._it)
        except StopIteration:
            self._it = self._make()
            try:
                return next(self._it)
            except StopIteration:
                raise ValueError(
                    "the target-batch source yielded no batches — is the "
                    "-target set smaller than -target_batch_size?"
                ) from None


class MetaLTRTrainer(V1Trainer):
    """Source batches reweighted by the meta-gradient of the target loss.
    ``model`` is a ``v1/models.py`` model, trained in place on ``device``;
    ranking batches are split into pos / neg views by
    ``pos_neg_split``."""

    def __init__(self, model, train_args, total_steps: int,
                 task: str = "ranking", ranking_loss_kind: str = "margin_loss",
                 pos_neg_split: Optional[Callable] = None,
                 log_weights_path: Optional[str] = None, device="cuda",
                 mesh=None):
        super().__init__(model, train_args, total_steps, task=task,
                         ranking_loss_kind=ranking_loss_kind,
                         pos_neg_split=pos_neg_split, device=device,
                         mesh=mesh)
        self.log_weights_path = log_weights_path
        warmup = train_args.warmup_steps or int(train_args.warmup_ratio
                                                * total_steps)
        self.schedule = linear_warmup_schedule(train_args.learning_rate,
                                               total_steps, warmup)
        self._step_fn = make_meta_train_step(
            self.per_example_loss, self.target_loss, schedule=self.schedule,
            mesh=self.mesh)

    def per_example_loss(self, params: Dict[str, torch.Tensor],
                         batch: Dict) -> torch.Tensor:
        """[B] source losses of the model under ``params``."""
        def score(b):
            args = tuple(b[k] for k in self.model.INPUTS)
            return functional_call(self.model, params, args)[0]

        return per_example_loss(self, score, batch)

    def target_loss(self, params, target_batch) -> torch.Tensor:
        """The global target batch's mean loss (over ranks, this rank's
        rows' share of it)."""
        per = self.per_example_loss(params, target_batch)
        return per.sum() / (per.shape[0] * self.mesh.shape[DATA_AXIS])

    def train_step(self, batch: Dict, target_batch: Dict):
        """One reweighted update from global source and target batches:
        returns (weighted loss, weights [B]) of the global batch."""
        self.model.train()
        loss, weights = self._step_fn(
            self.model, self.optimizer, self.step, self.local_batch(batch),
            self.local_batch(target_batch))
        self.scheduler.step()
        self.step += 1
        return loss, all_gather(weights, self.mesh, DATA_AXIS)

    def train(self, data_iter: Iterable, target_iter: CyclingIterator,
              eval_fn: Optional[Callable] = None) -> Dict[str, Any]:
        losses, log_loss = [], 0.0
        best_metric = -np.inf
        weight_history = []
        for batch in data_iter:
            if self.total_steps > 0 and self.step >= self.total_steps:
                break
            loss, weights = self.train_step(batch, next(target_iter))
            w = weights.float().cpu().numpy()
            weight_history.append(w)
            step = self.step
            if self.log_weights_path and self.is_main:
                with open(self.log_weights_path, "a", encoding="utf-8") as f:
                    f.write(str(step) + "\t"
                            + "\t".join(str(x) for x in w.tolist()) + "\n")
            log_loss += float(loss)
            if step % self.args.logging_steps == 0 and step > 0:
                avg = log_loss / self.args.logging_steps
                logger.info(f"step {step}/{self.total_steps} weighted loss "
                            f"{avg:.4f}")
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
                "best_metric": best_metric, "weights": weight_history}
