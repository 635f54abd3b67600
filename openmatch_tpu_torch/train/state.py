"""Optimizer, learning-rate schedule and checkpoint/resume (port of
``openmatch_tpu/train/state.py``).

The JAX package's optimizer is the optax chain ``clip_by_global_norm`` ->
``adamw`` or ``lamb`` with a linear warmup -> linear decay schedule.
``OptaxAdam`` writes that chain out as one ``torch.optim.Optimizer`` so the
updates agree with optax's to float rounding:

- the clip scales by ``max_norm / g_norm`` only when ``g_norm >= max_norm``
  (``clip_grad_norm_`` would divide by ``norm + 1e-6`` on every step);
- Adam's moments and bias correction are ``scale_by_adam``'s;
- decoupled weight decay ``wd * p`` is added to every parameter, biases and
  LayerNorm included (one parameter group);
- LAMB adds ``scale_by_trust_ratio``: each tensor's update is scaled by
  ``|p| / |u|``, or 1 where either norm is 0;
- the schedule is evaluated at the update count *before* the update, as
  optax's is: ``make_optimizer``'s ``LambdaLR`` is stepped after each
  ``optimizer.step()``, so the first update under warmup has lr 0 and
  leaves the parameters unchanged.

A parameter without a gradient counts as a zero gradient, as in optax,
whose update covers every leaf.

Under tensor parallelism (``set_tensor_parallel``) a sharded parameter holds
this rank's slice: the clip's global norm and LAMB's per-tensor norms sum
its squares over the model group, so they are the full tensors' norms, as
optax computes them over the GSPMD-sharded tree. Every other step of the
chain is elementwise.

Checkpoints: the model goes into the directory in the JAX package's format
(``DRModel.save``), so both packages load it; the optimizer and schedule
go into the port's own ``train_state.pt`` (``torch.save`` of the step, the
optimizer state and the scheduler state) beside a ``train_state.json``.
Over ranks the trainer passes the optimizer state in the one-process
layout (``optimizer_state``) and cuts it again on load (``cut``).
Resuming from the JAX package's ``train_state.msgpack`` is not ported.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch

TRAIN_STATE = "train_state.pt"


def linear_warmup_schedule(learning_rate: float, total_steps: int,
                           warmup_steps: int) -> Callable[[int], float]:
    """Linear 0 -> lr over warmup, then linear lr -> 0 over the remainder;
    a function of the update count (optax ``join_schedules`` of two
    ``linear_schedule``s)."""
    warmup_steps = max(warmup_steps, 1)
    decay_steps = max(total_steps - warmup_steps, 1)

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return learning_rate * min(count, warmup_steps) / warmup_steps
        done = min(count - warmup_steps, decay_steps)
        return learning_rate * (1.0 - done / decay_steps)

    return schedule


class OptaxAdam(torch.optim.Optimizer):
    """optax ``clip_by_global_norm`` -> ``scale_by_adam`` ->
    ``add_decayed_weights`` -> [``scale_by_trust_ratio``] ->
    ``scale_by_learning_rate``: AdamW, or LAMB with ``trust_ratio=True``.
    One parameter group; ``lr`` is read from the group on each step."""

    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 max_grad_norm: float = 0.0, trust_ratio: bool = False):
        defaults = dict(lr=lr, b1=b1, b2=b2, eps=eps,
                        weight_decay=weight_decay,
                        max_grad_norm=max_grad_norm, trust_ratio=trust_ratio,
                        count=0)
        super().__init__(params, defaults)
        if len(self.param_groups) != 1:
            raise ValueError("OptaxAdam takes one parameter group")
        self._sharded: set = set()
        self._model_sum: Optional[Callable] = None

    def set_tensor_parallel(self, sharded, model_sum: Callable):
        """``sharded``: the parameters that hold this rank's slice;
        ``model_sum(t)``: ``t`` summed over the model group."""
        self._sharded = {id(p) for p in sharded}
        self._model_sum = model_sum

    def _norms(self, tensors, params) -> torch.Tensor:
        """The full tensors' norms [n] of per-rank ``tensors``."""
        norms = torch.stack(torch._foreach_norm(tensors))
        if self._model_sum is None:
            return norms
        sharded = torch.tensor([id(p) in self._sharded for p in params],
                               device=norms.device)
        sq = norms.square()
        full = self._model_sum(torch.where(sharded, sq, 0.0))
        return torch.where(sharded, full, sq).sqrt()

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("OptaxAdam takes no closure")
        group = self.param_groups[0]
        params = list(group["params"])
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        max_norm = group["max_grad_norm"]
        if max_norm and max_norm > 0:
            g_norm = torch.linalg.vector_norm(self._norms(grads, params))
            scale = torch.where(g_norm < max_norm, torch.ones_like(g_norm),
                                max_norm / g_norm)
            grads = torch._foreach_mul(grads, scale)
        for p in params:
            if not self.state[p]:
                self.state[p]["mu"] = torch.zeros_like(p)
                self.state[p]["nu"] = torch.zeros_like(p)
        mu = [self.state[p]["mu"] for p in params]
        nu = [self.state[p]["nu"] for p in params]
        b1, b2 = group["b1"], group["b2"]
        group["count"] += 1
        count = group["count"]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
        updates = torch._foreach_div(mu, 1.0 - b1 ** count)
        denom = torch._foreach_div(nu, 1.0 - b2 ** count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, group["eps"])
        torch._foreach_div_(updates, denom)
        if group["weight_decay"]:
            torch._foreach_add_(updates, params, alpha=group["weight_decay"])
        if group["trust_ratio"]:
            if self._model_sum is None:
                p_norms = [torch.linalg.vector_norm(p) for p in params]
                u_norms = [torch.linalg.vector_norm(u) for u in updates]
            else:
                p_norms = self._norms(params, params)
                u_norms = self._norms(updates, params)
            for u, p_norm, u_norm in zip(updates, p_norms, u_norms):
                ratio = torch.where((p_norm == 0) | (u_norm == 0),
                                    torch.ones_like(p_norm), p_norm / u_norm)
                u.mul_(ratio)
        torch._foreach_add_(params, updates, alpha=-group["lr"])


def make_optimizer(params, train_args, total_steps: int
                   ) -> Tuple[OptaxAdam, torch.optim.lr_scheduler.LambdaLR]:
    """(optimizer, scheduler) for ``train_args``: ``optimizer`` adamw |
    lamb, ``max_grad_norm``, ``warmup_steps`` or ``warmup_ratio``. Step the
    scheduler after every ``optimizer.step()``."""
    warmup = train_args.warmup_steps or int(train_args.warmup_ratio
                                            * total_steps)
    name = getattr(train_args, "optimizer", "adamw")
    if name not in ("adamw", "lamb"):
        raise ValueError(f"Unknown optimizer '{name}' (expected adamw | lamb)")
    lr = train_args.learning_rate
    optimizer = OptaxAdam(
        params, lr=lr, b1=train_args.adam_beta1, b2=train_args.adam_beta2,
        eps=train_args.adam_epsilon, weight_decay=train_args.weight_decay,
        max_grad_norm=train_args.max_grad_norm or 0.0,
        trust_ratio=name == "lamb")
    schedule = linear_warmup_schedule(lr, total_steps, warmup)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda count: schedule(count) / lr if lr else 0.0)
    return optimizer, scheduler


def optax_state_tree(optimizer: OptaxAdam, named_params, to_jax) -> dict:
    """optax's chain state for ``make_optimizer``'s chain, as the Flax tree
    the JAX package serializes in ``train_state.msgpack``:
    ``{"0": {}, "1": {"0": {"count", "mu", "nu"}, "1": {}, "2":
    {"count"}}}`` for the default clip -> adamw (the clip's state left out
    without ``max_grad_norm``, a trust-ratio state added for LAMB).
    ``to_jax({name: tensor}) -> tree`` lays out the moments as the
    parameters are laid out."""
    group = optimizer.param_groups[0]
    count = np.asarray(group["count"], np.int32)
    moments = {"mu": {}, "nu": {}}
    for name, p in named_params:
        state = optimizer.state.get(p)
        for key in moments:
            moments[key][name] = state[key] if state else torch.zeros_like(p)
    inner = [{"count": count, "mu": to_jax(moments["mu"]),
              "nu": to_jax(moments["nu"])},
             {}]  # scale_by_adam, add_decayed_weights
    if group["trust_ratio"]:
        inner.append({})  # scale_by_trust_ratio
    inner.append({"count": count})  # the schedule
    chain = [{str(i): s for i, s in enumerate(inner)}]
    if group["max_grad_norm"] and group["max_grad_norm"] > 0:
        chain.insert(0, {})  # clip_by_global_norm
    return {str(i): s for i, s in enumerate(chain)}


def save_train_state(step: int, optimizer, scheduler, output_dir: str,
                     optimizer_state: Optional[dict] = None):
    """``train_state.pt`` (step, optimizer and scheduler state) and
    ``train_state.json`` ({"step"}) in ``output_dir``; ``optimizer_state``
    in place of ``optimizer.state_dict()`` when given."""
    os.makedirs(output_dir, exist_ok=True)
    if optimizer_state is None:
        optimizer_state = optimizer.state_dict()
    torch.save({"step": int(step), "optimizer": optimizer_state,
                "scheduler": scheduler.state_dict()},
               os.path.join(output_dir, TRAIN_STATE))
    with open(os.path.join(output_dir, "train_state.json"), "w") as f:
        json.dump({"step": int(step)}, f)


def load_train_state(ckpt_dir: str, optimizer, scheduler,
                     device=None, cut: Optional[Callable] = None) -> int:
    """Restore the optimizer and scheduler from ``train_state.pt``, tensors
    on ``device``, the optimizer state passed through ``cut`` first when
    given; returns the step."""
    payload = torch.load(os.path.join(ckpt_dir, TRAIN_STATE),
                         map_location=device, weights_only=True)
    state = payload["optimizer"]
    optimizer.load_state_dict(cut(state) if cut is not None else state)
    scheduler.load_state_dict(payload["scheduler"])
    return int(payload["step"])


def latest_checkpoint(output_dir: str) -> Optional[str]:
    """The newest ``checkpoint-N`` directory holding a ``train_state.pt``."""
    if not os.path.isdir(output_dir):
        return None
    best, best_step = None, -1
    for name in os.listdir(output_dir):
        if name.startswith("checkpoint-"):
            try:
                step = int(name.split("-")[1])
            except (IndexError, ValueError):
                continue
            if step > best_step and os.path.exists(
                    os.path.join(output_dir, name, TRAIN_STATE)):
                best, best_step = os.path.join(output_dir, name), step
    return best
