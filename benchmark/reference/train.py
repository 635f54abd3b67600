"""Plain dense-retrieval training steps in float32: the contrastive loss
over in-batch negatives and AdamW as the recipe states it.

A step encodes the global batch's queries and passages with the plain
encoder, scores every query against every passage (float32), takes the
softmax cross-entropy with each query's positive at ``i * passages per
query`` (mean over queries), and back-propagates. The update is optax's
chain: the gradients clipped to a global norm of ``max_grad_norm``, Adam's
bias-corrected moments with ``eps`` added outside the square root, decayed
weights added, times the learning rate of the schedule (linear from 0 over
``max(warmup, 1)`` updates, then linear to 0 at ``total_steps``), the
first update taking the rate at count 0."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F


@dataclass
class Recipe:
    learning_rate: float
    total_steps: int
    warmup_steps: int = 0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    max_grad_norm: float = 1.0

    def lr(self, count: int) -> float:
        warmup = max(self.warmup_steps, 1)
        decay = max(self.total_steps - warmup, 1)
        if count < warmup:
            return self.learning_rate * count / warmup
        return self.learning_rate * (1.0 - min(count - warmup, decay) / decay)


def contrastive_loss(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    stride = p.shape[0] // q.shape[0]
    targets = torch.arange(q.shape[0], device=q.device) * stride
    return F.cross_entropy(q.float() @ p.float().T, targets)


@dataclass
class StepRecord:
    loss: float
    grads: Dict[str, torch.Tensor]  # as the optimizer took them (clipped);
    # kept for the first step only


def train(w0: Dict[str, torch.Tensor], reps: Callable, batches: List[dict],
          recipe: Recipe, loss_fn: Callable = None,
          precision: Optional[str] = None):
    """Run ``len(batches)`` steps from the weights ``w0`` (left as they
    are). ``reps(w, ids, mask, precision)`` -> [B, d]; each batch holds
    ``query`` and ``passage`` ``input_ids`` / ``attention_mask`` tensors;
    ``loss_fn(q_reps, p_reps)`` defaults to the contrastive loss.
    Returns (the step records, the final weights)."""
    loss_fn = loss_fn or contrastive_loss
    w = {n: t.detach().clone().float().requires_grad_(True)
         for n, t in w0.items()}
    mu = {n: torch.zeros_like(t) for n, t in w.items()}
    nu = {n: torch.zeros_like(t) for n, t in w.items()}
    records = []
    for count, batch in enumerate(batches):
        q = reps(w, batch["query"]["input_ids"],
                 batch["query"]["attention_mask"], precision)
        p = reps(w, batch["passage"]["input_ids"],
                 batch["passage"]["attention_mask"], precision)
        loss = loss_fn(q, p)
        grads = torch.autograd.grad(loss, list(w.values()),
                                    allow_unused=True)
        g = {n: (t if t is not None else torch.zeros_like(w[n]))
             for n, t in zip(w, grads)}
        with torch.no_grad():
            if recipe.max_grad_norm:
                norm = torch.sqrt(sum(t.double().pow(2).sum()
                                      for t in g.values())).float()
                if norm >= recipe.max_grad_norm:
                    g = {n: t * (recipe.max_grad_norm / norm)
                         for n, t in g.items()}
            t1 = count + 1
            lr = recipe.lr(count)
            for n in w:
                mu[n].mul_(recipe.b1).add_(g[n], alpha=1 - recipe.b1)
                nu[n].mul_(recipe.b2).addcmul_(g[n], g[n],
                                               value=1 - recipe.b2)
                u = (mu[n] / (1 - recipe.b1 ** t1)) / (
                    (nu[n] / (1 - recipe.b2 ** t1)).sqrt() + recipe.eps)
                if recipe.weight_decay:
                    u = u + recipe.weight_decay * w[n]
                w[n].sub_(lr * u)
        records.append(StepRecord(loss=float(loss.detach()),
                                  grads=g if count == 0 else {}))
    return records, {n: t.detach() for n, t in w.items()}
