"""GradCache: large-batch contrastive training in bounded memory (port of
``openmatch_tpu/parallel/grad_cache.py``).

Three passes, as in the JAX version and the luyug/GradCache package it
follows:

1. reps chunk by chunk under ``torch.no_grad()``, no activations kept; the
   dropout generator's state is saved before each chunk;
2. the loss on the full [B, D] rep matrices, with gradients taken with
   respect to those matrices only;
3. each chunk replayed with gradients, the generator's state restored to
   what it was before that chunk in pass 1 (so the dropout masks are the
   same), and ``reps.backward(rep_grad_chunk)`` accumulating into the
   parameters' ``.grad``.

The accumulated gradient equals the plain ``loss(encode(batch))`` gradient
(to float rounding) while the activation memory is one chunk's.

Over ranks the loss may all-gather the reps first (``DRTrainer`` with
``negatives_x_device`` passes ``rep_loss(all_gather_rows(q),
all_gather_rows(p))``, as JAX's ``gc_loss`` gathers them): pass 2's rep
gradients are then this rank's rows of the global loss's, and the replayed
parameter gradients are this rank's share, summed over the data group
after the passes.

Passes 1 and 2's loss run in a ``train.forward`` span, the rep gradients
and pass 3 in a ``train.backward`` span (``utils.profiling``), the names
of a plain step's phases.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from ..utils.profiling import span

Batch = Dict[str, torch.Tensor]
Encode = Callable[[Batch, Optional[torch.Generator]], torch.Tensor]


def split_batch(batch: Batch, num_chunks: int) -> List[Batch]:
    """[B, ...] tensors -> ``num_chunks`` batches of B / num_chunks rows."""
    b = next(iter(batch.values())).shape[0]
    if b % num_chunks:
        raise ValueError(f"batch of {b} rows does not split into "
                         f"{num_chunks} chunks")
    parts = {k: v.chunk(num_chunks) for k, v in batch.items()}
    return [{k: parts[k][i] for k in batch} for i in range(num_chunks)]


def grad_cache_backward(encode_q: Encode, encode_p: Encode,
                        loss_fn: Callable[[torch.Tensor, torch.Tensor],
                                          torch.Tensor],
                        q_batch: Batch, p_batch: Batch, q_chunks: int,
                        p_chunks: int,
                        generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
    """Accumulate d loss / d params into the parameters' ``.grad`` chunk by
    chunk; returns the loss (detached).

    encode_*: (batch, generator) -> [b, D] reps. loss_fn: (q_reps [Bq, D],
    p_reps [Bp, D]) -> scalar. ``generator`` feeds dropout; each chunk's
    replay restores the state it had in the rep pass."""
    sides = ((encode_q, split_batch(q_batch, q_chunks)),
             (encode_p, split_batch(p_batch, p_chunks)))
    states, reps = [], []
    with span("train.forward"):
        with torch.no_grad():  # pass 1
            for encode, chunks in sides:
                side_states, side_reps = [], []
                for chunk in chunks:
                    side_states.append(None if generator is None
                                       else generator.get_state())
                    side_reps.append(encode(chunk, generator))
                states.append(side_states)
                reps.append(torch.cat(side_reps).requires_grad_())
        loss = loss_fn(reps[0], reps[1])  # pass 2
    with span("train.backward"):
        rep_grads = torch.autograd.grad(loss, reps)
        for (encode, chunks), side_states, g in zip(sides, states,
                                                    rep_grads):
            for chunk, state, g_chunk in zip(chunks, side_states,
                                             g.chunk(len(chunks))):  # pass 3
                if generator is not None:
                    generator.set_state(state)
                encode(chunk, generator).backward(g_chunk)
    return loss.detach()
