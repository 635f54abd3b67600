"""Cross-encoder trainer on one device (port of
``openmatch_tpu/train/rr_trainer.py``).

Each step scores a batch of positive and a batch of negative (query,
passage) pairs and takes ``RRModel.loss`` (``mr``, ``smr``, ``bce`` or
``ce``; monoT5 always ``ce``) and one backward. Everything else is
``DRTrainer``'s: one process and one device (more processes, ``dp_size >
1`` or ``tp_size > 1`` raise), the ``OptaxAdam`` update under the
warmup-then-decay schedule (``train/state.py``), dropout masks from a
generator seeded by (``seed``, step), the loss kept on the device between
logging steps, and checkpoints in the JAX package's format plus the
port's ``train_state.pt``.
"""

from __future__ import annotations

import torch

from .dr_trainer import DRTrainer


class RRTrainer(DRTrainer):
    """``model``: an ``RRModel``; batches are ``{"pos_pairs",
    "neg_pairs"}`` (``PairCollator``)."""

    def loss_and_grads(self, batch) -> torch.Tensor:
        """The step's pairwise loss (detached, on the device), with its
        gradients in the parameters' ``.grad``."""
        generator = self._step_generator()
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        loss, _ = self.model.loss(self._to_device(batch["pos_pairs"]),
                                  self._to_device(batch["neg_pairs"]),
                                  generator)
        loss.backward()
        return loss.detach()
