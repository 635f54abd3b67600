"""Cross-encoder trainer (port of ``openmatch_tpu/train/rr_trainer.py``).

Each step scores a batch of positive and a batch of negative (query,
passage) pairs and takes ``RRModel.loss`` (``mr``, ``smr``, ``bce`` or
``ce``; monoT5 always ``ce``) and one backward. Pairwise losses couple no
two examples, so data parallelism is the whole story: each rank's loss over
its own pairs, loss and gradients averaged over the data group (JAX's
``pmean``), the same update as one process over the global batch. Tensor
parallelism is refused, as in JAX. Everything else is ``DRTrainer``'s: the
``OptaxAdam`` update under the warmup-then-decay schedule
(``train/state.py``), dropout masks from a generator seeded by (``seed``,
step, data index), the loss kept on the device between logging steps, and
checkpoints (rank 0's) in the JAX package's format, ``train_state.msgpack``
included.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel.mesh import MODEL_AXIS, Mesh, make_mesh
from .dr_trainer import DRTrainer


class RRTrainer(DRTrainer):
    """``model``: an ``RRModel``; batches are ``{"pos_pairs",
    "neg_pairs"}`` (``PairCollator``), this rank's rows of them."""

    def __init__(self, model, train_args, total_steps: int, device="cuda",
                 mesh: Optional[Mesh] = None):
        mesh = mesh if mesh is not None else make_mesh(
            train_args.dp_size, train_args.tp_size, device)
        if mesh.shape[MODEL_AXIS] > 1:
            raise ValueError(
                "RRTrainer does not implement tensor parallelism: params "
                "would be fully replicated and tp_size would only shrink "
                "the data axis — train with tp_size=1 (DRTrainer is the "
                "TP-capable trainer)")
        super().__init__(model, train_args, total_steps, device, mesh)

    def _grads_summed(self) -> bool:
        return False

    def loss_and_grads(self, batch) -> torch.Tensor:
        """This rank's pairwise loss (detached, on the device), with its
        gradients in the parameters' ``.grad``."""
        generator = self._step_generator()
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        loss, _ = self.model.loss(self._to_device(batch["pos_pairs"]),
                                  self._to_device(batch["neg_pairs"]),
                                  generator)
        loss.backward()
        return loss.detach()
