"""ReInfoSelect: reinforcement data selection for weak supervision (port of
``openmatch_tpu/research/reinfoselect.py``).

A policy model (a classification ranker over the positive pair: BERT for
``-model bert``, Conv-KNRM otherwise) scores each candidate training pair;
gumbel-softmax(tau) relaxes its two logits into drop / keep
probabilities, one action is drawn per pair, the ranker trains on the
kept pairs, and every ``eval_every`` steps the policy is updated by
REINFORCE with reward = the change of the dev metric: a reward >= 0
reinforces the kept pairs' actions, a reward < 0 their flips.

The refresh recomputes the log-probabilities under the current policy
from the buffered Gumbel noise, one buffered step at a time, and
accumulates the gradient step by step (``make_policy_refresh``): memory is one
policy forward and backward, whatever the number of buffered steps. That
is gradient-exact because the policy does not change between refreshes.

Randomness comes from an explicit ``torch.Generator``; each sampling
function also takes its noise as an argument, so a test can feed the
draws of a JAX key (``jax.random.categorical`` is argmax(logits +
Gumbel)).

``DataSelectionPolicy``, ``sample_actions``, ``policy_loss`` and
``reinfoselect_round`` are the generic form over per-pair feature
vectors.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.gumbel import categorical, gumbel_noise


class DataSelectionPolicy(nn.Module):
    """2-layer MLP over per-pair state features -> [B, 2] log-probs of
    [drop, keep]."""

    def __init__(self, in_dim: int, hidden_dim: int = 64):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, 2)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        x = torch.tanh(self.fc1(features))
        return F.log_softmax(self.fc2(x), dim=-1)


def sample_actions(log_probs: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Keep (1) / drop (0) per example, drawn from the policy."""
    return categorical(log_probs, generator, noise)


def policy_loss(log_probs: torch.Tensor, actions: torch.Tensor,
                reward) -> torch.Tensor:
    """REINFORCE: -reward * log pi(action), averaged."""
    chosen = log_probs.gather(1, actions.long()[:, None])[:, 0]
    return -(reward * chosen).mean()


def reinfoselect_round(policy: DataSelectionPolicy, optimizer,
                       pair_features: torch.Tensor,
                       train_on_selected: Callable[[torch.Tensor], None],
                       eval_metric: Callable[[], float], last_metric: float,
                       generator: Optional[torch.Generator] = None,
                       noise: Optional[torch.Tensor] = None
                       ) -> Tuple[float, torch.Tensor]:
    """One select -> train -> evaluate -> REINFORCE cycle; updates
    ``policy`` in place through ``optimizer`` and returns (new_metric,
    actions)."""
    with torch.no_grad():
        actions = sample_actions(policy(pair_features), generator, noise)
    train_on_selected(actions)
    new_metric = eval_metric()
    reward = torch.tensor(new_metric - last_metric, dtype=torch.float32,
                          device=pair_features.device)
    optimizer.zero_grad(set_to_none=True)
    policy_loss(policy(pair_features), actions, reward).backward()
    optimizer.step()
    return new_metric, actions


# ---------------------------------------------------------------------------
# The training mode of ``train_v1 -reinfoselect``: the policy is a
# classification model over the positive pair.
# ---------------------------------------------------------------------------


def gumbel_keep_log_probs(logits: torch.Tensor, tau: float,
                          noise: torch.Tensor) -> torch.Tensor:
    """log of gumbel_softmax(logits, tau) for the given Gumbel ``noise``:
    the policy's two logits relaxed. The noise is an argument so the
    refresh can recompute the identical distribution later."""
    return F.log_softmax((logits + noise) / tau, dim=-1)


def select_pairs(logits: torch.Tensor, tau: float,
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[torch.Tensor] = None,
                 action_noise: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(actions [B], noise [B, 2]): keep (1) / drop (0) per pair from
    Categorical(gumbel_softmax(logits, tau)). ``noise`` relaxes the
    logits and ``action_noise`` draws the action; each is drawn from
    ``generator`` when not given. The refresh needs ``noise`` back."""
    if noise is None:
        noise = gumbel_noise(logits.shape, generator, logits.device,
                             logits.dtype)
    log_p = gumbel_keep_log_probs(logits, tau, noise)
    return categorical(log_p, generator, action_noise), noise


def refresh_step_loss(logits: torch.Tensor, noise: torch.Tensor,
                      actions: torch.Tensor, reward: float,
                      tau: float) -> torch.Tensor:
    """One buffered step's REINFORCE loss: only kept pairs count; a reward
    >= 0 pushes up log pi(action), a reward < 0 log pi(1 - action)."""
    log_p = gumbel_keep_log_probs(logits, tau, noise)
    actions = actions.long()
    mask = actions.to(log_p.dtype)
    if reward >= 0:
        lp_a = log_p.gather(1, actions[:, None])[:, 0]
        return -(lp_a * mask).sum() * reward
    lp_flip = log_p.gather(1, (1 - actions)[:, None])[:, 0]
    return (lp_flip * mask).sum() * reward


def make_policy_refresh(policy_score_fn: Callable, optimizer, tau: float,
                        reduce: Optional[Callable[[], None]] = None):
    """``refresh(buffer, reward)``: the REINFORCE update of the policy over
    ``buffer``, a list of ``(inputs, noise, actions)`` per selection step.
    The loss is a plain sum over the steps, so each step's gradient is
    accumulated into ``.grad`` by its own backward (no step's graph
    outlives it); then ``reduce()`` when given (over ranks: the gradients
    summed over the ranks, whose buffers hold their rows of each step), and
    one ``optimizer.step()`` (the port's ``OptaxAdam``, which reads a
    parameter without a gradient as a zero gradient, as optax does).
    ``policy_score_fn(inputs) -> [B, 2]``."""

    def refresh(buffer, reward: float):
        reward = float(reward)
        optimizer.zero_grad(set_to_none=True)
        for inputs, noise, actions in buffer:
            logits = policy_score_fn(inputs)
            refresh_step_loss(logits, noise, actions, reward,
                              tau).backward()
        if reduce is not None:
            reduce()
        optimizer.step()

    return refresh
