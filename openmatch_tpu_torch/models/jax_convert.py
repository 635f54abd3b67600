"""Carry weights between the JAX package's parameter trees and the port.

``params_from_jax`` takes a Flax parameter tree with numpy leaves (what
``flax.serialization.msgpack_restore`` returns for ``params.msgpack``, or
``jax.tree.map(np.asarray, params)``) and returns a ``state_dict`` for the
port's modules. Flax layouts it undoes:

- ``Dense`` kernels are [in, out]; ``nn.Linear.weight`` is [out, in].
- ``attention/qkv`` is a ``DenseGeneral`` with kernel [d, 3, H, hd] and
  bias [3, H, hd]: one [3*d, d] linear with q, k, v rows, head-major.
- ``attention/out`` kernel is [H, hd, d]: a [d, d] linear over the
  concatenated heads.
- ``LayerNorm`` has ``scale``/``bias``; ``Embed`` has ``embedding``.

``params_to_jax`` is the inverse: a port ``state_dict`` -> the Flax tree
(fp32 numpy leaves, keys sorted as ``jax.tree.map`` leaves them), which
``DRModel.save`` writes as ``params.msgpack``: the bytes the JAX
``DRModel.save`` writes for the same weights.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float32))


def _dense(tree: Mapping, prefix: str, out: Dict[str, torch.Tensor]):
    out[f"{prefix}.weight"] = _t(np.asarray(tree["kernel"]).T)
    if "bias" in tree:
        out[f"{prefix}.bias"] = _t(tree["bias"])


def _layer_norm(tree: Mapping, prefix: str, out: Dict[str, torch.Tensor]):
    out[f"{prefix}.weight"] = _t(tree["scale"])
    out[f"{prefix}.bias"] = _t(tree["bias"])


def encoder_state_from_jax(tree: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A ``BertEncoder`` Flax tree -> the port's ``BertEncoder`` state."""
    p = f"{prefix}." if prefix else ""
    out: Dict[str, torch.Tensor] = {}
    for name in ("word_embeddings", "position_embeddings",
                 "token_type_embeddings"):
        out[f"{p}{name}.weight"] = _t(tree[name]["embedding"])
    _layer_norm(tree["embeddings_ln"], f"{p}embeddings_ln", out)
    if "embeddings_project" in tree:
        _dense(tree["embeddings_project"], f"{p}embeddings_project", out)
    if "pooler" in tree:
        _dense(tree["pooler"], f"{p}pooler", out)
    layers = sorted((int(m.group(1)), key) for key in tree
                    if (m := re.fullmatch(r"layer_(\d+)", key)))
    for i, key in layers:
        lt = tree[key]
        lp = f"{p}layers.{i}"
        qkv = lt["attention"]["qkv"]
        kernel = np.asarray(qkv["kernel"])  # [d, 3, H, hd]
        d = kernel.shape[0]
        out[f"{lp}.attention.qkv.weight"] = _t(kernel.reshape(d, -1).T)
        out[f"{lp}.attention.qkv.bias"] = _t(np.asarray(qkv["bias"]).reshape(-1))
        o = lt["attention"]["out"]
        o_kernel = np.asarray(o["kernel"])  # [H, hd, d]
        out[f"{lp}.attention.out.weight"] = _t(
            o_kernel.reshape(-1, o_kernel.shape[-1]).T)
        out[f"{lp}.attention.out.bias"] = _t(o["bias"])
        _layer_norm(lt["attention_ln"], f"{lp}.attention_ln", out)
        _dense(lt["intermediate"], f"{lp}.intermediate", out)
        _dense(lt["output"], f"{lp}.output", out)
        _layer_norm(lt["output_ln"], f"{lp}.output_ln", out)
    return out


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A Flax parameter tree (numpy leaves) -> a state_dict.

    A ``DRModel`` tree (keys ``encoder_q``, optional ``encoder_p``,
    ``head_q``, ``head_p``) maps onto the port's ``DRModel``; a bare
    ``BertEncoder`` tree maps onto ``BertEncoder``."""
    if "encoder_q" not in tree:
        return encoder_state_from_jax(tree)
    out: Dict[str, torch.Tensor] = {}
    for tower in ("encoder_q", "encoder_p"):
        if tower in tree:
            out.update(encoder_state_from_jax(tree[tower], tower))
    for head in ("head_q", "head_p"):
        if head in tree:
            _dense(tree[head]["linear"], f"{head}.linear", out)
    return out


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def _dense_to_jax(sd: Mapping, prefix: str) -> dict:
    out = {"kernel": _np(sd[f"{prefix}.weight"]).T.copy()}
    if f"{prefix}.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


def _layer_norm_to_jax(sd: Mapping, prefix: str) -> dict:
    return {"scale": _np(sd[f"{prefix}.weight"]),
            "bias": _np(sd[f"{prefix}.bias"])}


def encoder_state_to_jax(sd: Mapping, prefix: str, num_heads: int) -> dict:
    """The port's ``BertEncoder`` state -> its Flax tree."""
    p = f"{prefix}." if prefix else ""
    tree = {name: {"embedding": _np(sd[f"{p}{name}.weight"])}
            for name in ("word_embeddings", "position_embeddings",
                         "token_type_embeddings")}
    tree["embeddings_ln"] = _layer_norm_to_jax(sd, f"{p}embeddings_ln")
    if f"{p}embeddings_project.weight" in sd:
        tree["embeddings_project"] = _dense_to_jax(sd,
                                                   f"{p}embeddings_project")
    layers = sorted({int(m.group(1)) for key in sd
                     if (m := re.match(re.escape(p) + r"layers\.(\d+)\.",
                                       key))})
    for i in layers:
        lp = f"{p}layers.{i}"
        w = _np(sd[f"{lp}.attention.qkv.weight"])  # [3*d, d]
        d = w.shape[1]
        hd = d // num_heads
        o = _np(sd[f"{lp}.attention.out.weight"])  # [d, H*hd]
        tree[f"layer_{i}"] = {
            "attention": {
                "qkv": {"kernel": w.T.reshape(d, 3, num_heads, hd).copy(),
                        "bias": _np(sd[f"{lp}.attention.qkv.bias"]).reshape(
                            3, num_heads, hd)},
                "out": {"kernel": o.T.reshape(num_heads, hd, -1).copy(),
                        "bias": _np(sd[f"{lp}.attention.out.bias"])},
            },
            "attention_ln": _layer_norm_to_jax(sd, f"{lp}.attention_ln"),
            "intermediate": _dense_to_jax(sd, f"{lp}.intermediate"),
            "output": _dense_to_jax(sd, f"{lp}.output"),
            "output_ln": _layer_norm_to_jax(sd, f"{lp}.output_ln"),
        }
    if f"{p}pooler.weight" in sd:
        tree["pooler"] = _dense_to_jax(sd, f"{p}pooler")
    return tree


def params_to_jax(state_dict: Mapping, num_heads: int) -> dict:
    """A port ``state_dict`` -> the JAX package's Flax tree (the inverse of
    ``params_from_jax``). A ``DRModel`` state (``encoder_q.`` keys) gives
    ``{"encoder_q", ["encoder_p"], ["head_q"], ["head_p"]}``; a bare
    ``BertEncoder`` state gives the encoder tree. ``num_heads`` splits the
    fused attention weights into the ``DenseGeneral`` layouts."""
    if not any(k.startswith("encoder_q.") for k in state_dict):
        return _sorted(encoder_state_to_jax(state_dict, "", num_heads))
    tree = {}
    for tower in ("encoder_q", "encoder_p"):
        if any(k.startswith(tower + ".") for k in state_dict):
            tree[tower] = encoder_state_to_jax(state_dict, tower, num_heads)
    for head in ("head_q", "head_p"):
        if f"{head}.linear.weight" in state_dict:
            tree[head] = {"linear": _dense_to_jax(state_dict,
                                                  f"{head}.linear")}
    return _sorted(tree)


def _sorted(tree):
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree
