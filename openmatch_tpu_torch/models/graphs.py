"""The inference encode replayed as CUDA graphs, one per input shape.

Eager, ``DRModel.encode`` launches each aten operation from the host: about
420 for a BERT-base query batch and 1,100 for a T5-base ``t5_encdec``
passage batch, each tens of µs of host time, so the host paces the card.
``EncodeGraphs`` captures the whole encode (the encoder, the pooling or
the decoder step, the head and the normalisation) once per input shape
as one CUDA graph and replays it: the same kernels in the same order on
the same operands, launched by one call.

``engages`` is the rule: a call replays only where the eager encode would
draw nothing and record nothing that a replay could not repeat: its input
on a card, autograd off, the model in eval mode, no dropout generator and
no tensor-parallel context (``parallel/tp.shard_model``). Any other call
runs eagerly.

A graph is kept under the tower, the inputs' shapes, dtypes and device,
whether inference mode is on (a static buffer made in inference mode
cannot be written outside it) and the matmul precision settings. All of
a model's graphs are dropped once a parameter's or a buffer's storage
moves (``p.data = ...``, ``.to()``): a replay would read freed memory.
In-place updates (Adam's ``_foreach_add_``) keep them valid, since the
fp32 -> bf16 weight casts are inside the graph and read the parameters
at every replay. At most ``MAX_GRAPHS`` shapes are kept; a further shape
runs eagerly, with no eviction. The graphs' pool (about the eager
encode's peak at its largest shape) stays allocated while the model
lives, or until ``release``.

A capture runs the encode once eagerly on a side stream (it fills lazy
state: T5's bucket tables, cuBLAS's handle and workspace), then captures
it on that stream into one memory pool that the model's graphs share,
from static input buffers allocated outside the pool. A call copies its
inputs in, replays and returns a clone of the static output, all under
the cache's lock: graphs that share a pool may overwrite each other's
memory, so no two replays interleave and each output is cloned right
after its own replay. A tensor the encode reads that is neither a
parameter nor made in the graph (a cached bucket table) is kept alive by
the graph through ``hold``.
"""

from __future__ import annotations

import threading
from typing import Dict, NamedTuple, Optional

import torch
from torch import nn

from ..utils.profiling import span

MAX_GRAPHS = 4

# Bumped whenever any module registers a parameter, a buffer or a
# submodule, so a cache rereads a model's tensors after one was replaced.
_registrations = 0


def _registered(*_):
    global _registrations
    _registrations += 1


_module = nn.modules.module
for _register in (_module.register_module_parameter_registration_hook,
                  _module.register_module_buffer_registration_hook,
                  _module.register_module_module_registration_hook):
    _register(_registered)


class _Capturing(threading.local):
    held: Optional[list] = None  # the capture's outside tensors


_capturing = _Capturing()


def hold(t: torch.Tensor) -> torch.Tensor:
    """``t``, kept alive by the graph being captured in this thread, if
    any: for a tensor a graph reads from a cache that may let it go."""
    held = _capturing.held
    if held is not None:
        held.append(t)
    return t


def engages(model, input_ids, generator) -> bool:
    """Whether ``model.encode(input_ids, ..., generator=generator)`` may
    replay a graph."""
    return (input_ids.is_cuda and not torch.is_grad_enabled()
            and not model.training and generator is None
            and not model._graphs.tensor_parallel(model))


class _Graph(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    ids: torch.Tensor  # static inputs, outside the pool
    mask: torch.Tensor
    reps: torch.Tensor  # static output, in the pool
    held: list


class EncodeGraphs:
    """One model's graphs. ``stats`` counts ``captures``, ``replays`` and
    the calls that ran ``eager``."""

    def __init__(self):
        self.stats = {"captures": 0, "replays": 0, "eager": 0}
        self._lock = threading.Lock()
        self._graphs: Dict[tuple, _Graph] = {}
        self._pool = None
        self._fingerprint = None
        self._scanned = None  # ``_registrations`` at the last scan
        self._tensors = self._tp_modules = ()

    def __getstate__(self):
        return {}  # a copy of the model starts with no graphs

    def __setstate__(self, state):
        self.__init__()

    def _scan(self, model):
        if self._scanned != _registrations:
            self._scanned = _registrations
            self._tensors = (list(model.parameters())
                             + list(model.buffers()))
            self._tp_modules = [m for m in model.modules()
                                if hasattr(m, "tp")]

    def release(self):
        """Drop every graph and the pool they share (the counts stay);
        the next call captures anew."""
        with self._lock:
            self._graphs.clear()
            self._pool = self._fingerprint = None

    def tensor_parallel(self, model) -> bool:
        """Whether a module of ``model`` carries a ``tp`` context."""
        self._scan(model)
        return any(m.tp is not None for m in self._tp_modules)

    def encode(self, model, is_query: bool, input_ids: torch.Tensor,
               attention_mask: torch.Tensor) -> Optional[torch.Tensor]:
        """``model.encode_eager``'s reps by a replay, capturing first for
        a new key; None when ``MAX_GRAPHS`` other keys are held."""
        self._scan(model)
        fingerprint = tuple([t.data_ptr() for t in self._tensors])
        matmul = torch.backends.cuda.matmul
        key = (is_query, input_ids.shape, input_ids.dtype,
               attention_mask.shape, attention_mask.dtype, input_ids.device,
               torch.is_inference_mode_enabled(),
               torch.get_float32_matmul_precision(),
               matmul.allow_bf16_reduced_precision_reduction,
               matmul.allow_fp16_reduced_precision_reduction)
        with self._lock, torch.cuda.device(input_ids.device):
            if fingerprint != self._fingerprint:
                self._graphs.clear()
                self._pool, self._fingerprint = None, fingerprint
            g = self._graphs.get(key)
            if g is None:
                if len(self._graphs) >= MAX_GRAPHS:
                    return None
                with span("model.graph_capture"):
                    g = self._capture(model, is_query, input_ids,
                                      attention_mask)
                self._graphs[key] = g
                self.stats["captures"] += 1
            with span("model.graph_replay"):
                g.ids.copy_(input_ids)
                g.mask.copy_(attention_mask)
                g.graph.replay()
                reps = g.reps.clone()
            self.stats["replays"] += 1
        return reps

    def _capture(self, model, is_query, input_ids, attention_mask) -> _Graph:
        ids, mask = input_ids.clone(), attention_mask.clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            model.encode_eager(ids, mask, is_query)
        torch.cuda.current_stream().wait_stream(side)
        # the warm run's cached blocks go back to the card before the
        # capture fills its own pool: a model near the card's size cannot
        # hold both
        torch.cuda.empty_cache()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        _capturing.held = held = []
        try:
            with torch.cuda.graph(graph, pool=self._pool, stream=side,
                                  capture_error_mode="thread_local"):
                reps = model.encode_eager(ids, mask, is_query)
        finally:
            _capturing.held = None
        return _Graph(graph, ids, mask, reps, held)
