"""Dense-retrieval trainer on one device (port of
``openmatch_tpu/train/dr_trainer.py``).

On one process the JAX package's five step builders collapse to two: the
plain step (``loss(encode(batch))``, one backward) and the GradCache step
(``parallel/grad_cache.py``); each takes the ``dual_learning`` loss when
asked. With one process, ``negatives_x_device`` computes the same global
loss as local negatives, so the flag is accepted; more than one process,
``dp_size > 1`` or ``tp_size > 1`` raise (multi-process training is
ROADMAP P10).

Parameters are fp32 and the encoder computes in ``model.dtype`` (bf16 by
default), casting the weights on each call. Dropout, when the encoder's
config carries nonzero rates, draws its masks from a generator on the
trainer's device seeded from (``seed``, step), so a resumed run replays the
same masks. The loss stays on the device between logging steps.
"""

from __future__ import annotations

import functools
import logging
import os
import time
from typing import Any, Dict, Iterable, Optional

import torch

from ..device import resolve_device
from ..losses import dual_contrastive_loss, simple_contrastive_loss
from ..parallel.grad_cache import grad_cache_backward
from .state import (latest_checkpoint, load_train_state, make_optimizer,
                    save_train_state)

logger = logging.getLogger(__name__)

_MULTI_PROCESS_TODO = ("{} is not ported to PyTorch yet: the port trains on "
                       "one process and one device (ROADMAP.md, P10)")


def world_size() -> int:
    """The ``torch.distributed`` world size; 1 when it is not initialised."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


class DRTrainer:
    def __init__(self, model, train_args, total_steps: int, device="cuda"):
        """``model``: a ``DRModel`` (an ``RRModel`` for ``RRTrainer``) whose
        fp32 parameters are trained in place, moved to ``device`` (the card
        unless the caller names the CPU)."""
        self.device = resolve_device(device)
        if world_size() > 1:
            raise NotImplementedError(_MULTI_PROCESS_TODO.format(
                f"training on {world_size()} processes"))
        if train_args.dp_size > 1 or train_args.tp_size > 1:
            raise NotImplementedError(_MULTI_PROCESS_TODO.format(
                f"dp_size={train_args.dp_size}, tp_size={train_args.tp_size}"))
        self.model = model.to(self.device).train()
        self.args = train_args
        self.total_steps = total_steps
        self.step = 0
        self.optimizer, self.scheduler = make_optimizer(
            list(self.model.parameters()), train_args, total_steps)
        self._generator = (torch.Generator(device=self.device)
                           if model.dropout_active else None)
        if train_args.dual_learning:
            self.loss_fn = functools.partial(
                dual_contrastive_loss, dual_weight=train_args.dual_weight,
                temperature=train_args.score_temperature)
        else:
            self.loss_fn = functools.partial(
                simple_contrastive_loss,
                temperature=train_args.score_temperature)

    # ------------------------------------------------------------------

    def _to_device(self, part: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in part.items()}

    def _encode_q(self, batch, generator=None):
        return self.model.encode_query(batch["input_ids"],
                                       batch["attention_mask"], generator)

    def _encode_p(self, batch, generator=None):
        return self.model.encode_passage(batch["input_ids"],
                                         batch["attention_mask"], generator)

    def _step_generator(self) -> Optional[torch.Generator]:
        if self._generator is None:
            return None
        return self._generator.manual_seed(self.args.seed * 2**32 + self.step)

    def loss_and_grads(self, batch) -> torch.Tensor:
        """The step's loss (detached, on the device), with d loss / d params
        in the parameters' ``.grad``: GradCache when ``grad_cache`` is set,
        else one forward and backward."""
        args = self.args
        q, p = self._to_device(batch["query"]), self._to_device(
            batch["passage"])
        generator = self._step_generator()
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        if args.grad_cache:
            n_q, n_p = q["input_ids"].shape[0], p["input_ids"].shape[0]
            return grad_cache_backward(
                self._encode_q, self._encode_p, self.loss_fn, q, p,
                q_chunks=max(n_q // max(args.gc_q_chunk_size, 1), 1),
                p_chunks=max(n_p // max(args.gc_p_chunk_size, 1), 1),
                generator=generator)
        loss = self.loss_fn(self._encode_q(q, generator),
                            self._encode_p(p, generator))
        loss.backward()
        return loss.detach()

    def train_step(self, batch) -> torch.Tensor:
        """One update; returns the loss as a device scalar (no host sync)."""
        loss = self.loss_and_grads(batch)
        self.optimizer.step()
        self.scheduler.step()
        self.step += 1
        return loss

    def train(self, data_iter: Iterable, eval_fn=None) -> Dict[str, Any]:
        args = self.args
        losses, t0 = [], time.time()
        log_loss, window = 0.0, 0
        for batch in data_iter:
            if self.total_steps > 0 and self.step >= self.total_steps:
                break
            log_loss = log_loss + self.train_step(batch)
            window += 1
            if self.step % args.logging_steps == 0:
                dt = time.time() - t0
                avg = float(log_loss) / window
                logger.info(f"step {self.step}/{self.total_steps} loss "
                            f"{avg:.4f} ({dt / window:.2f}s/step)")
                losses.append(avg)
                log_loss, window, t0 = 0.0, 0, time.time()
            if args.save_steps and self.step % args.save_steps == 0:
                self.save_checkpoint()
            if eval_fn is not None and args.eval_steps \
                    and self.step % args.eval_steps == 0:
                eval_fn(self)
        return {"losses": losses, "final_step": self.step}

    # ------------------------------------------------------------------

    def save_checkpoint(self, output_dir: Optional[str] = None) -> str:
        """The model in the JAX package's format plus ``train_state.pt``,
        in ``output_dir`` or ``<output_dir>/checkpoint-<step>``."""
        out = output_dir or os.path.join(self.args.output_dir,
                                         f"checkpoint-{self.step}")
        self.model.save(out)
        save_train_state(self.step, self.optimizer, self.scheduler, out)
        logger.info(f"saved checkpoint to {out}")
        return out

    def save_model(self, output_dir: Optional[str] = None) -> str:
        out = output_dir or self.args.output_dir
        self.model.save(out)
        return out

    def maybe_resume(self) -> bool:
        """Load the newest ``checkpoint-N`` of ``output_dir``, if any: the
        parameters from its ``params.msgpack``, the optimizer, schedule and
        step from its ``train_state.pt``."""
        ckpt = latest_checkpoint(self.args.output_dir)
        if ckpt is None:
            return False
        self.model.load_weights(ckpt)
        self.step = load_train_state(ckpt, self.optimizer, self.scheduler,
                                     self.device)
        logger.info(f"resumed from {ckpt} at step {self.step}")
        return True

