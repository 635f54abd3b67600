"""Training losses (port of ``openmatch_tpu/losses.py``).

- Contrastive: softmax cross-entropy over ``q @ p.T`` where each query's
  positive sits at column ``i * (n_p // n_q)`` (the ``train_n_passages``
  stride). Scores are accumulated in fp32 whatever the reps' dtype: both
  sides are cast to fp32 before the product, which is exact for bf16 reps,
  as JAX's ``preferred_element_type=float32`` is.
- Pairwise reranker losses: margin ranking, softplus margin, BCE
  (pos->1/neg->0), and 2-class CE over ``[neg, pos]`` logits.

The score matrix is one ``torch.matmul``: in the JAX package it is a
``jnp.dot`` outside any Pallas kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def contrastive_targets(n_queries: int, n_passages: int,
                        device=None) -> torch.Tensor:
    """Positive-column index for each query: stride = n_passages // n_queries."""
    stride = n_passages // n_queries
    return torch.arange(n_queries, device=device) * stride


def _scores(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a.float() @ b.float().T


def simple_contrastive_loss(q_reps: torch.Tensor, p_reps: torch.Tensor,
                            targets: torch.Tensor = None,
                            reduction: str = "mean",
                            temperature: float = 1.0) -> torch.Tensor:
    """In-batch softmax contrastive loss over the full score matrix.
    q_reps [n_q, d], p_reps [n_q * n_psg, d]; ``temperature`` divides the
    scores before the softmax."""
    if targets is None:
        targets = contrastive_targets(q_reps.shape[0], p_reps.shape[0],
                                      q_reps.device)
    scores = _scores(q_reps, p_reps)
    if temperature != 1.0:
        scores = scores / temperature
    losses = F.cross_entropy(scores, targets, reduction="none")
    if reduction == "mean":
        return losses.mean()
    if reduction == "sum":
        return losses.sum()
    return losses


def contrastive_loss_with_scores(q_reps, p_reps, targets=None):
    """Same as simple_contrastive_loss but also returns the score matrix."""
    if targets is None:
        targets = contrastive_targets(q_reps.shape[0], p_reps.shape[0],
                                      q_reps.device)
    scores = _scores(q_reps, p_reps)
    return F.cross_entropy(scores, targets), scores


def dual_contrastive_loss(q_reps: torch.Tensor, p_reps: torch.Tensor,
                          dual_weight: float = 0.1,
                          temperature: float = 1.0) -> torch.Tensor:
    """DANCE-style dual learning: the query->passage loss plus
    ``dual_weight`` times a passage->query loss in which each positive
    passage (``p_reps[::stride]``) must retrieve its query among all
    queries. ``temperature`` divides both directions' scores."""
    n_q = q_reps.shape[0]
    stride = p_reps.shape[0] // n_q
    q2p = simple_contrastive_loss(q_reps, p_reps, temperature=temperature)
    scores = _scores(p_reps[::stride], q_reps) / temperature
    targets = torch.arange(n_q, device=q_reps.device)
    return q2p + dual_weight * F.cross_entropy(scores, targets)


def margin_ranking_loss(pos_scores, neg_scores, margin: float = 1.0):
    return torch.relu(margin - pos_scores + neg_scores).mean()


def soft_margin_ranking_loss(pos_scores, neg_scores, margin: float = 1.0):
    return F.softplus(margin - pos_scores + neg_scores).mean()


def binary_cross_entropy_loss(pos_scores, neg_scores):
    """BCE-with-logits; the reference sums the two means."""
    pos = F.binary_cross_entropy_with_logits(
        pos_scores, torch.ones_like(pos_scores))
    neg = F.binary_cross_entropy_with_logits(
        neg_scores, torch.zeros_like(neg_scores))
    return pos + neg


def cross_entropy_loss(pos_scores, neg_scores):
    """2-class CE over [neg, pos] logit pairs ([batch, 2]); pos rows are
    labelled 1, neg rows 0."""
    ones = torch.ones(pos_scores.shape[0], dtype=torch.long,
                      device=pos_scores.device)
    zeros = torch.zeros(neg_scores.shape[0], dtype=torch.long,
                        device=neg_scores.device)
    return F.cross_entropy(pos_scores, ones) + F.cross_entropy(neg_scores,
                                                               zeros)


rr_loss_functions = {
    "mr": margin_ranking_loss,
    "smr": soft_margin_ranking_loss,
    "bce": binary_cross_entropy_loss,
    "ce": cross_entropy_loss,
}
