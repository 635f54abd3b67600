"""Dense-retrieval trainer (port of ``openmatch_tpu/train/dr_trainer.py``).

One process per rank over ``torch.distributed`` (``parallel/mesh.py``):
``dp x tp`` ranks, each holding its rows of the global batch (``train_step``
takes this rank's rows; ``shard_batch`` cuts them from a global batch).
The JAX package's step builders, each also with ``dual_learning``:

- local negatives: each rank's contrastive loss over its own rows; loss
  and gradients averaged over the data group (JAX's ``pmean``);
- ``negatives_x_device``: q and p reps all-gathered over the data group
  (``all_gather_rows``), the loss over the global score matrix on every
  rank, gradients summed over the data group (``psum``): the same update
  as one process over the global batch. Rank d's queries and passages
  land at matching offsets, so query g's positive stays at g * stride;
- GradCache (``parallel/grad_cache.py``), local (``pmean``) or with the
  reps gathered (``psum``);
- tensor parallelism (``tp_size > 1``, ``parallel/tp.py``): each rank holds
  its slices of the attention and FFN weights; it needs
  ``negatives_x_device``, as in JAX.

The gradients are reduced by one flat all-reduce after backward (not DDP,
so GradCache's two passes stay as they are), then clipped, so every rank of
a data group steps the same optimizer on the same gradients and the
parameters stay replicated. Parameters start as rank 0's.

Parameters are fp32 and the encoder computes in ``model.dtype`` (bf16 by
default), casting the weights on each call. Dropout, when the encoder's
config carries nonzero rates, draws its masks from a generator on the
trainer's device seeded from (``seed``, step, data index): the ranks of a
model group share masks, so their replicated activations stay equal, and a
resumed run replays the same masks. The loss stays on the device between
logging steps. Only rank 0 writes checkpoints, in the one-process layout:
the JAX package's ``params.msgpack`` and ``train_state.msgpack``, so a run
of either package resumes in the other.

A step's phases are spans (``utils.profiling``): ``train.forward`` (the
upload, both encodes and the loss), ``train.backward`` and
``train.optimizer`` (the reduction over ranks, the optimizer and the
schedule); GradCache's passes carry the same names.
"""

from __future__ import annotations

import functools
import logging
import os
import time
from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..losses import dual_contrastive_loss, simple_contrastive_loss
from ..models.dr_model import num_heads
from ..models.jax_convert import params_from_jax, params_to_jax
from ..parallel import tp as tp_mod
from ..parallel.grad_cache import grad_cache_backward
from ..parallel.mesh import (DATA_AXIS, MODEL_AXIS, Mesh, all_gather_rows,
                             all_reduce, flat_all_reduce, make_mesh,
                             reduce_grads, replicate)
from ..utils.profiling import span
from .state import (latest_checkpoint, load_train_state, make_optimizer,
                    optax_state_tree, restore_optimizer, save_train_state)

logger = logging.getLogger(__name__)


class DRTrainer:
    def __init__(self, model, train_args, total_steps: int, device="cuda",
                 mesh: Optional[Mesh] = None):
        """``model``: a ``DRModel`` (an ``RRModel`` for ``RRTrainer``) whose
        fp32 parameters are trained in place, moved to ``device`` (the card
        unless the caller names the CPU). ``mesh``: this rank's place
        among the job's ranks; by default ``make_mesh(dp_size, tp_size)``
        over every rank of the initialised process group (one without)."""
        if getattr(model, "port_only", False):
            raise ValueError(
                f"DRTrainer does not train the {model.backbone_type!r} "
                "backbone: its weights are held in the compute dtype, with "
                "no fp32 master for the optimizer")
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else make_mesh(
            train_args.dp_size, train_args.tp_size, self.device)
        self.tp_size = self.mesh.shape[MODEL_AXIS]
        if self.tp_size > 1 and not train_args.negatives_x_device:
            raise ValueError(
                "tensor parallelism (tp_size > 1) requires "
                "negatives_x_device=True (the local-negatives shard_map "
                "path assumes replicated params); grad_cache composes "
                "with TP through the jit path")
        self.model = model.to(self.device).train()
        replicate(list(self.model.parameters()), self.mesh)
        tp_mod.shard_model(self.model, self.mesh)
        self._hd = tp_mod.head_dim(self.model.encoder_config)
        self._param_specs = tp_mod.param_partition_specs(
            self.model.state_dict(), self._hd)
        self.args = train_args
        self.total_steps = total_steps
        self.step = 0
        self.optimizer, self.scheduler = make_optimizer(
            list(self.model.parameters()), train_args, total_steps)
        if self.tp_size > 1:
            self.optimizer.set_tensor_parallel(
                [p for n, p in self.model.named_parameters()
                 if self._param_specs[n] is not None],
                lambda t: all_reduce(t, self.mesh, MODEL_AXIS))
        self._generator = (torch.Generator(device=self.device)
                           if model.dropout_active else None)
        if train_args.dual_learning:
            rep_loss = functools.partial(
                dual_contrastive_loss, dual_weight=train_args.dual_weight,
                temperature=train_args.score_temperature)
        else:
            rep_loss = functools.partial(
                simple_contrastive_loss,
                temperature=train_args.score_temperature)
        if train_args.negatives_x_device:
            self.loss_fn = lambda q, p: rep_loss(
                all_gather_rows(q, self.mesh), all_gather_rows(p, self.mesh))
        else:
            self.loss_fn = rep_loss

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
        seed = self.args.seed * 2**32 + self.step
        d = self.mesh.data_index
        if d:
            seed = (seed * 1_000_003 + d) % 2**63
        return self._generator.manual_seed(seed)

    def _grads_summed(self) -> bool:
        """Whether the data group's gradients are summed (each rank's loss
        is the global one) rather than averaged."""
        return bool(self.args.negatives_x_device)

    def loss_and_grads(self, batch) -> torch.Tensor:
        """This rank's part of the step: the loss (detached, on the
        device), with d loss / d params in the parameters' ``.grad``;
        GradCache when ``grad_cache`` is set, else one forward and
        backward. ``step`` reduces both over the data group."""
        args = self.args
        with span("train.forward"):
            q, p = self._to_device(batch["query"]), self._to_device(
                batch["passage"])
            generator = self._step_generator()
            self.model.train()
            self.optimizer.zero_grad(set_to_none=True)
            if not args.grad_cache:
                loss = self.loss_fn(self._encode_q(q, generator),
                                    self._encode_p(p, generator))
        if args.grad_cache:
            n_q, n_p = q["input_ids"].shape[0], p["input_ids"].shape[0]
            return grad_cache_backward(
                self._encode_q, self._encode_p, self.loss_fn, q, p,
                q_chunks=max(n_q // max(args.gc_q_chunk_size, 1), 1),
                p_chunks=max(n_p // max(args.gc_p_chunk_size, 1), 1),
                generator=generator)
        with span("train.backward"):
            loss.backward()
        return loss.detach()

    def _reduce(self, loss: torch.Tensor) -> torch.Tensor:
        """Gradients and loss over the data group, in one flat all-reduce:
        the gradients summed or averaged (``_grads_summed``), the loss
        averaged (under summed gradients every rank's loss is the global
        one already). Under tp the replicated parameters' gradients are
        first averaged over the model group: each rank computed them
        alone, and the card's atomic adds (an embedding's backward) sum in
        any order, so they differ in the last bits and the replicas would
        drift apart."""
        if self.tp_size > 1:
            flat_all_reduce(
                [p.grad for n, p in self.model.named_parameters()
                 if self._param_specs[n] is None and p.grad is not None],
                self.mesh, MODEL_AXIS, op="mean")
        if self.mesh.group(DATA_AXIS) is None:
            return loss
        summed = self._grads_summed()
        (loss,) = reduce_grads(self.model.parameters(), self.mesh, [loss],
                               op="sum" if summed else "mean")
        return loss[0] / self.mesh.shape[DATA_AXIS] if summed else loss[0]

    def train_step(self, batch) -> torch.Tensor:
        """One update from this rank's rows of the global batch; returns
        the step's loss as a device scalar (no host sync)."""
        loss = self.loss_and_grads(batch)
        with span("train.optimizer"):
            loss = self._reduce(loss)
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

    # ---- checkpoints: the one-process layout, written by rank 0 --------

    def full_state(self) -> Dict[str, torch.Tensor]:
        """The model's full parameters (under tp gathered over the model
        group: every rank of the group must call it)."""
        return tp_mod.gather_params(self.model.state_dict(), self.mesh,
                                    self._hd)

    def _to_jax(self, named: Dict[str, torch.Tensor]) -> dict:
        return params_to_jax(named, num_heads(self.model.encoder_config))

    def _full_moments(self) -> dict:
        """The Adam moments ``{"mu": {name: tensor}, "nu": ...}`` in the
        one-process layout: under tp each sharded moment gathered over the
        model group (every rank of the group must call it)."""
        moments = {}
        for key in ("mu", "nu"):
            local = {n: (self.optimizer.state[p][key]
                         if self.optimizer.state.get(p)
                         else torch.zeros_like(p))
                     for n, p in self.model.named_parameters()}
            moments[key] = (local if self.tp_size == 1 else
                            tp_mod.gather_params(local, self.mesh, self._hd))
        return moments

    def _cut(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """A one-process tensor cut to this rank's slice of ``name``."""
        return tp_mod.local_slice(t, self._param_specs[name], self.tp_size,
                                  self.mesh.model_index)

    def _save_model(self, out: str) -> Optional[Dict[str, torch.Tensor]]:
        """Rank 0 writes the model; returns the full parameters there."""
        state = self.full_state() if self.tp_size > 1 else None  # collective
        if self.mesh.rank != 0:
            return None
        if state is None:
            self.model.save(out)
            return self.model.state_dict()
        self.model.save(out, state_dict=state)
        return state

    def _barrier(self):
        if self.mesh.group("world") is not None:
            dist.barrier()

    def save_checkpoint(self, output_dir: Optional[str] = None) -> str:
        """The model in the JAX package's format plus its
        ``train_state.msgpack``, in ``output_dir`` or
        ``<output_dir>/checkpoint-<step>``."""
        out = output_dir or os.path.join(self.args.output_dir,
                                         f"checkpoint-{self.step}")
        state = self._save_model(out)
        moments = self._full_moments()  # collective under tp
        if self.mesh.rank == 0:
            save_train_state(out, self.step, self._to_jax(state),
                             optax_state_tree(self.optimizer, None,
                                              self._to_jax, moments))
            logger.info(f"saved checkpoint to {out}")
        self._barrier()
        return out

    def save_model(self, output_dir: Optional[str] = None) -> str:
        out = output_dir or self.args.output_dir
        self._save_model(out)
        self._barrier()
        return out

    def maybe_resume(self) -> bool:
        """Load the newest ``checkpoint-N`` of ``output_dir``, if any, on
        every rank from its ``train_state.msgpack`` (written by either
        package): the parameters (cut to this rank's slices under tp), the
        Adam moments, the update count with its learning rate, and the
        step."""
        ckpt = latest_checkpoint(self.args.output_dir)
        if ckpt is None:
            return False
        payload = load_train_state(ckpt)
        full = params_from_jax(payload["params"])
        cut = self._cut if self.tp_size > 1 else None
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                t = torch.from_numpy(np.array(full[name]))
                p.copy_(cut(name, t) if cut is not None else t)
        restore_optimizer(payload["opt_state"], self.optimizer,
                          self.scheduler, self.model.named_parameters(),
                          params_from_jax, cut)
        self.step = int(np.asarray(payload["step"]))
        logger.info(f"resumed from {ckpt} at step {self.step}")
        return True
