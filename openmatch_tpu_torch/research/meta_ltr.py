"""Meta learning-to-reweight training pairs with target-domain data (port
of ``openmatch_tpu/research/meta_ltr.py``; Ren et al., "Learning to
Reweight Examples").

Per-example weights come from differentiating the TARGET-domain (dev)
loss through one virtual SGD step on the eps-weighted SOURCE loss, at
eps = 0. The virtual step is ``torch.autograd.grad(..., create_graph=True)``
over the parameters, the virtual parameters go through
``torch.func.functional_call``, and the gradient with respect to eps is
taken of the dev loss: a second-order gradient, so every module on the
path must be differentiable twice (the v1 matcher's ``ieee_bmm`` is, and
the BERT encoder is plain matmul and softmax).

``params`` is a ``{name: tensor}`` dict of a module's parameters (e.g.
``dict(model.named_parameters())``), and the loss functions take it:
``per_example_loss_fn(params, batch) -> [B]``,
``dev_loss_fn(params, dev_batch) -> scalar``. A parameter the source loss
does not reach has a zero gradient, as in ``jax.grad``.

Over ranks (a ``mesh`` whose data axis splits both batches) the numbers are
those of one process over the global batches, as JAX's SPMD step computes
them: the virtual step's gradient of ``sum(eps * loss)`` is summed over the
ranks inside the differentiated graph (``parallel.mesh.all_reduce_sum``,
whose backward sums the dev loss's gradients too), ``dev_loss_fn`` returns
this rank's share of the global mean (its rows' sum over the global
count), the normaliser ``weights.sum()`` and its ``> 0`` test are global,
and the real update's gradient of ``sum(w * loss)`` is summed, not
averaged. Each rank gets its rows' weights.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..parallel.mesh import (DATA_AXIS, all_reduce, all_reduce_sum,
                             reduce_grads)


def meta_reweight_step(
    params: Dict[str, torch.Tensor],
    per_example_loss_fn: Callable,
    dev_loss_fn: Callable,
    train_batch,
    dev_batch,
    virtual_lr: float = 1e-3,
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weights [B], weighted_loss) for the real update; over a ``mesh``,
    this rank's rows' weights and its part of the loss.

    weights = relu(-d dev_loss / d eps) normalised to sum 1: examples whose
    gradient helps the target domain get positive weight, harmful ones
    zero. When none helps, every weight is zero (the batch is skipped), not
    uniform. The weights are detached: the real update treats them as
    constants (Ren et al. eq. 12), and ``weighted_loss`` is differentiable
    with respect to ``params`` through the per-example losses alone."""
    names = list(params)
    tensors = [params[n] for n in names]
    losses = per_example_loss_fn(params, train_batch)
    eps = torch.zeros(losses.shape[0], dtype=losses.dtype,
                      device=losses.device, requires_grad=True)
    grads = torch.autograd.grad((eps * losses).sum(), tensors,
                                create_graph=True, allow_unused=True)
    if mesh is not None and mesh.group(DATA_AXIS) is not None:
        grads = all_reduce_sum([torch.zeros_like(p) if g is None else g
                                for p, g in zip(tensors, grads)], mesh)
    virtual = {n: p if g is None else p - virtual_lr * g
               for n, p, g in zip(names, tensors, grads)}
    (grad_eps,) = torch.autograd.grad(dev_loss_fn(virtual, dev_batch), eps,
                                      allow_unused=True)
    if grad_eps is None:  # the dev loss does not reach eps (lr 0)
        grad_eps = torch.zeros_like(eps)
    weights = torch.relu(-grad_eps.detach())
    norm = weights.sum()
    if mesh is not None:
        norm = all_reduce(norm.clone(), mesh, DATA_AXIS)
    weights = torch.where(norm > 0, weights / torch.clamp(norm, min=1e-8),
                          torch.zeros_like(weights))
    return weights, (weights * losses).sum()


def make_meta_train_step(
    per_example_loss_fn: Callable,
    dev_loss_fn: Callable,
    virtual_lr: float = 1e-3,
    schedule: Optional[Callable[[int], float]] = None,
    mesh=None,
):
    """``step(model, optimizer, count, train_batch, dev_batch) -> (loss,
    weights)``: one update of ``model``'s parameters by ``optimizer`` with
    the reweighted gradient. ``schedule(count) -> lr`` overrides
    ``virtual_lr`` with the live learning rate at update ``count`` (the
    reference's virtual step at the scheduler's current lr). The caller
    steps its scheduler after. Over a ``mesh`` the batches are this
    rank's rows, the gradient and the returned loss are summed over the
    ranks, and the weights are this rank's rows'."""

    def step(model, optimizer, count: int, train_batch, dev_batch):
        vlr = schedule(count) if schedule is not None else virtual_lr
        optimizer.zero_grad(set_to_none=True)
        weights, loss = meta_reweight_step(
            dict(model.named_parameters()), per_example_loss_fn,
            dev_loss_fn, train_batch, dev_batch, vlr, mesh)
        loss.backward()
        if mesh is not None:
            (loss,) = reduce_grads(model.parameters(), mesh, [loss],
                                   op="sum")
        optimizer.step()
        return loss.detach().reshape(()), weights

    return step
