"""Tensor parallelism over the "model" axis, Megatron style (port of
``openmatch_tpu/parallel/tp.py``).

The JAX package gives each parameter a ``PartitionSpec`` and lets GSPMD
insert the collectives. The port cuts each parameter to this rank's slice
(``place_params``) and puts the two collectives in the model's forward
itself (``TPContext``): a copy-to-model-group (identity forward,
all-reduce backward) before each column-parallel product and a
reduce-from-model-group (all-reduce forward, identity backward) after each
row-parallel product, whose bias is then added once. So each attention and
each FFN block costs one all-reduce forward and one backward.

The JAX specs mapped onto the port's ``nn.Linear`` [out, in] layout:

BERT (``models/bert.py``):
  attention.qkv.weight [3*H*hd, d] -> each third's rows, this rank's heads
  attention.qkv.bias   [3*H*hd]    -> as the weight's rows
  attention.out.weight [d, H*hd]   -> columns (this rank's heads)
  intermediate.weight  [f, d]      -> rows; intermediate.bias [f] -> rows
  output.weight        [d, f]      -> columns
T5 (``models/t5.py``):
  q/k/v.weight [H*d_kv, d] -> rows (heads); o.weight [d, H*d_kv] -> columns
  wi/wi_0/wi_1.weight [f, d] -> rows; wo.weight [d, f] -> columns

Everything else (embeddings, norms, the row-parallel biases, the T5
relative-position tables, heads) stays replicated. A spec is ``(dim,
groups, unit)``: the tensor is viewed as ``groups`` equal blocks along
``dim``, and each block is split over the model axis in whole ``unit``s
(a head, or one FFN column).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .mesh import MODEL_AXIS, Mesh, all_gather, all_reduce

Spec = Optional[Tuple[int, int, int]]

_HEAD_ROWS = {"q", "k", "v"}  # T5 attention: [H*d_kv, d]
_HEAD_COLS = {"o", "out"}  # T5 / BERT attention output: [d, H*hd]
_FFN_ROWS = {"intermediate", "wi", "wi_0", "wi_1"}
_FFN_COLS = {"output", "wo"}


def head_dim(config) -> int:
    """The width of one attention head of a BERT or T5 config."""
    if hasattr(config, "d_kv"):
        return config.d_kv
    return config.hidden_size // config.num_attention_heads


def _spec_for(name: str, ndim: int, hd: int) -> Spec:
    parts = name.split(".")
    if len(parts) < 2:
        return None
    module, param = parts[-2], parts[-1]
    if module == "qkv":
        return (0, 3, hd)  # weight rows and bias alike
    if param != "weight" and not (module in _FFN_ROWS and param == "bias"):
        return None
    if module in _HEAD_ROWS and ndim == 2:
        return (0, 1, hd)
    if module in _HEAD_COLS and ndim == 2:
        return (1, 1, hd)
    if module in _FFN_ROWS:
        return (0, 1, 1)
    if module in _FFN_COLS and ndim == 2:
        return (1, 1, 1)
    return None


def param_partition_specs(state: Dict[str, torch.Tensor],
                          hd: int) -> Dict[str, Spec]:
    """{name: spec or None (replicated)} for a state dict whose attention
    heads are ``hd`` wide."""
    return {name: _spec_for(name, t.dim(), hd) for name, t in state.items()}


def validate_tp(state: Dict[str, torch.Tensor], specs: Dict[str, Spec],
                tp_size: int):
    """Every sharded dimension must split into whole heads (or columns)
    over ``tp_size``; raise naming the parameter."""
    if tp_size <= 1:
        return
    for name, spec in specs.items():
        if spec is None:
            continue
        dim, groups, unit = spec
        shape = tuple(state[name].shape)
        if (shape[dim] // groups // unit) % tp_size:
            raise ValueError(
                f"tensor-parallel axis size {tp_size} does not divide "
                f"dim {dim} of param '{name}' (shape {shape}); "
                "pick tp_size dividing num_heads and the FFN width")


def _blocks(shape, spec) -> list:
    dim, groups, _ = spec
    return list(shape[:dim]) + [groups, shape[dim] // groups] \
        + list(shape[dim + 1:])


def local_slice(x: torch.Tensor, spec: Spec, tp: int, t: int) -> torch.Tensor:
    """Rank ``t``'s slice (a copy) of ``x`` under ``spec`` over ``tp``."""
    if spec is None or tp == 1:
        return x
    dim, groups, _ = spec
    view = x.reshape(_blocks(x.shape, spec))
    part = view.shape[dim + 1] // tp
    out = view.narrow(dim + 1, t * part, part)
    shape = list(x.shape)
    shape[dim] = groups * part
    return out.reshape(shape).clone()


def place_params(state: Dict[str, torch.Tensor], mesh: Mesh,
                 hd: int) -> Dict[str, torch.Tensor]:
    """A full state dict cut to this rank's slices (``mesh.tp`` 1: the
    state itself)."""
    if mesh.tp == 1:
        return dict(state)
    specs = param_partition_specs(state, hd)
    validate_tp(state, specs, mesh.tp)
    return {name: local_slice(t, specs[name], mesh.tp, mesh.model_index)
            for name, t in state.items()}


def gather_params(local: Dict[str, torch.Tensor], mesh: Mesh,
                  hd: int) -> Dict[str, torch.Tensor]:
    """The inverse of ``place_params``: every rank of the model group gets
    the full tensors (one all-gather for all sharded tensors)."""
    if mesh.tp == 1:
        return dict(local)
    specs = param_partition_specs(local, hd)
    names = [n for n, s in specs.items() if s is not None]
    full = dict(local)
    if not names:
        return full
    flat = torch.cat([local[n].detach().reshape(-1) for n in names])
    parts = all_gather(flat, mesh, MODEL_AXIS).chunk(mesh.tp)
    sizes = [local[n].numel() for n in names]
    per_rank = [p.split(sizes) for p in parts]
    for i, name in enumerate(names):
        dim, groups, _ = specs[name]
        shape = list(local[name].shape)
        views = [pr[i].reshape(_blocks(shape, specs[name]))
                 for pr in per_rank]
        shape[dim] *= mesh.tp
        full[name] = torch.cat(views, dim=dim + 1).reshape(shape)
    return full


class _CopyToModel(torch.autograd.Function):
    """Identity forward, all-reduce (fp32) of the gradient backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        g = all_reduce(grad.float().clone(), ctx.mesh, MODEL_AXIS)
        return g.to(grad.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce (fp32) forward, identity backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce(x.float().clone(), mesh, MODEL_AXIS).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class TPContext:
    """What a model's blocks need under tensor parallelism: the two
    collectives and this rank's place among the heads."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.index = mesh.model_index

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyToModel.apply(x, self.mesh)

    def reduce_out(self, x: torch.Tensor) -> torch.Tensor:
        return _ReduceFromModel.apply(x, self.mesh)

    def heads(self, bias: torch.Tensor, n_local: int) -> torch.Tensor:
        """This rank's heads of a [B, H, Sq, Sk] bias (a bias shared by all
        heads, [B, 1, Sq, Sk], as it is)."""
        if bias.shape[1] == 1:
            return bias
        lo = self.index * n_local
        return bias[:, lo:lo + n_local]


def shard_model(model: torch.nn.Module, mesh: Mesh):
    """Cut ``model``'s parameters (in place) to this rank's slices and
    give its blocks the ``TPContext``; a mesh with ``tp`` 1 leaves it as
    it is. ``model.encoder_config`` gives the head width."""
    if mesh.tp == 1:
        return
    local = place_params(model.state_dict(), mesh,
                         head_dim(model.encoder_config))
    for name, p in model.named_parameters():
        p.data = local[name]
    ctx = TPContext(mesh)
    for module in model.modules():
        if hasattr(module, "tp"):
            module.tp = ctx
