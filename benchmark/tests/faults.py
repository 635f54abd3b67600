"""Faults planted under the timed path, for the tests that see the output
check catch them. The training faults patch the program through pytest's
``monkeypatch``; the others wrap a method of the program."""

from __future__ import annotations

import torch


def unchanged_step(monkeypatch):
    """A step that returns its state unchanged: the optimizer does
    nothing."""
    from openmatch_tpu_torch.train.state import OptaxAdam

    monkeypatch.setattr(OptaxAdam, "step", lambda self, closure=None: None)


def half_batch(monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    from openmatch_tpu_torch.train import dr_trainer

    full = dr_trainer.simple_contrastive_loss

    def half(q, p, **kw):
        return full(q[:q.shape[0] // 2], p[:p.shape[0] // 2], **kw)

    monkeypatch.setattr(dr_trainer, "simple_contrastive_loss", half)


def every_other_row_zeroed(encode):
    """Half of each batch left out: the reps of rows 0, 2, 4, ... zeroed."""
    def wrapped(self, input_ids, attention_mask, *args, **kw):
        reps = encode(self, input_ids, attention_mask, *args, **kw).clone()
        reps[0::2] = 0
        return reps
    return wrapped


def rows_rolled(encode):
    """An answer altered where it is produced: each row gets its
    neighbour's rep."""
    def wrapped(self, input_ids, attention_mask, *args, **kw):
        return torch.roll(encode(self, input_ids, attention_mask, *args,
                                 **kw), 1, dims=0)
    return wrapped


def first_hit_replaced(search):
    """An answer altered where it is produced: each query's best document
    replaced by the next row of the index."""
    def wrapped(self, queries):
        scores, ids = search(self, queries)
        ids = ids.clone()
        ids[:, 0] = (ids[:, 0] + 1) % self.n_docs
        return scores, ids
    return wrapped


def stale(search):
    """A search that returns its previous answer of as many rows (its
    state unchanged)."""
    last = {}

    def wrapped(self, queries):
        out = search(self, queries)
        prev = last.get(queries.shape[0], out)
        last[queries.shape[0]] = out
        return prev
    return wrapped
