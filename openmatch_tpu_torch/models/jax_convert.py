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
- T5 (``T5Encoder``, ``T5EncoderDecoderStep``): ``q``, ``k``, ``v`` are
  ``DenseGeneral`` kernels [d, H, d_kv], each a [H*d_kv, d] linear; ``o`` is
  [H, d_kv, d], a [d, H*d_kv] linear; ``rel_bias``, ``enc_rel_bias`` and
  ``dec_rel_bias`` are [buckets, H] tables; ``RMSNorm`` keeps its
  ``weight``; ``shared`` is an ``Embed``; ``lm_head`` a ``Dense``.

Trees: a ``DRModel`` tree has ``encoder_q`` (and ``encoder_p``, ``head_q``,
``head_p``), an ``RRModel`` tree ``encoder`` (and ``head``); any other tree
is a bare encoder. Each encoder is BERT or T5, told apart by its keys.

``params_to_jax`` is the inverse: a port ``state_dict`` -> the Flax tree
(fp32 numpy leaves, keys sorted as ``jax.tree.map`` leaves them), which
``DRModel.save`` and ``RRModel.save`` write as ``params.msgpack``: the bytes
the JAX package's ``save`` writes for the same weights.

``v1_params_from_jax`` / ``v1_params_to_jax`` do the same for the v1
rerankers (``v1/models.py``): an ``Embedder``'s ``embedding``; a
``Conv1DEncoder``'s ``conv_N`` kernels, [W, in, out] in Flax and
[out, in, W] for ``conv1d``; TK's attention ``q``/``k``/``v``
(``DenseGeneral`` kernels [D, H, hd], biases [H, hd]) and ``out``
([H, hd, D]); its ``mixer``; ``Dense`` heads; and a ``bert`` subtree, which
is ``encoder_state_from_jax``'s.

``mlm_params_from_jax`` / ``mlm_params_to_jax`` carry ``research.mlm``'s
``MLMModel`` (a ``bert`` encoder, the ``transform`` Dense, the
``transform_ln`` LayerNorm and ``decoder_bias``), ``policy_params_*``
``research.reinfoselect``'s ``DataSelectionPolicy`` (Dense ``fc1``, ``fc2``).
``T5Seq2Seq`` has ``T5EncoderDecoderStep``'s tree, which ``t5_state_*``
carry.
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


def _t5_layers_from_jax(tree: Mapping, jax_name: str, ours: str,
                        out: Dict[str, torch.Tensor]):
    layers = sorted((int(m.group(1)), key) for key in tree
                    if (m := re.fullmatch(jax_name + r"_(\d+)", key)))
    for i, key in layers:
        lt, lp = tree[key], f"{ours}.{i}"
        for attn in ("self_attn", "cross_attn"):
            if attn not in lt:
                continue
            for n in ("q", "k", "v"):
                kernel = np.asarray(lt[attn][n]["kernel"])  # [d, H, d_kv]
                out[f"{lp}.{attn}.{n}.weight"] = _t(
                    kernel.reshape(kernel.shape[0], -1).T)
            o = np.asarray(lt[attn]["o"]["kernel"])  # [H, d_kv, d]
            out[f"{lp}.{attn}.o.weight"] = _t(o.reshape(-1, o.shape[-1]).T)
        for ln in ("self_attn_ln", "cross_attn_ln", "ff_ln"):
            if ln in lt:
                out[f"{lp}.{ln}.weight"] = _t(lt[ln]["weight"])
        for n, dense in lt["ff"].items():
            _dense(dense, f"{lp}.ff.{n}", out)


def t5_state_from_jax(tree: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A ``T5Encoder`` or ``T5EncoderDecoderStep`` Flax tree -> the port's
    module state."""
    p = f"{prefix}." if prefix else ""
    out = {f"{p}shared.weight": _t(tree["shared"]["embedding"])}
    for name in ("rel_bias", "enc_rel_bias", "dec_rel_bias"):
        if name in tree:
            out[f"{p}{name}"] = _t(tree[name])
    for name in ("final_ln", "enc_final_ln", "dec_final_ln"):
        if name in tree:
            out[f"{p}{name}.weight"] = _t(tree[name]["weight"])
    if "lm_head" in tree:
        _dense(tree["lm_head"], f"{p}lm_head", out)
    for jax_name, ours in (("layer", "layers"), ("enc_layer", "enc_layers"),
                           ("dec_layer", "dec_layers")):
        _t5_layers_from_jax(tree, jax_name, f"{p}{ours}", out)
    return out


def _any_encoder_from_jax(tree: Mapping, prefix: str = ""):
    if "shared" in tree:
        return t5_state_from_jax(tree, prefix)
    return encoder_state_from_jax(tree, prefix)


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A Flax parameter tree (numpy leaves) -> a state_dict.

    A ``DRModel`` tree (keys ``encoder_q``, optional ``encoder_p``,
    ``head_q``, ``head_p``) maps onto the port's ``DRModel``, an
    ``RRModel`` tree (``encoder``, optional ``head``) onto ``RRModel``; a
    bare encoder tree maps onto ``BertEncoder`` or the T5 module."""
    if "encoder_q" in tree:
        towers, heads = ("encoder_q", "encoder_p"), ("head_q", "head_p")
    elif "encoder" in tree:
        towers, heads = ("encoder",), ("head",)
    else:
        return _any_encoder_from_jax(tree)
    out: Dict[str, torch.Tensor] = {}
    for tower in towers:
        if tower in tree:
            out.update(_any_encoder_from_jax(tree[tower], tower))
    for head in heads:
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


def _t5_layers_to_jax(sd: Mapping, ours: str, jax_name: str,
                      num_heads: int, tree: dict):
    layers = sorted({int(m.group(1)) for key in sd
                     if (m := re.match(re.escape(ours) + r"\.(\d+)\.",
                                       key))})
    for i in layers:
        lp, lt = f"{ours}.{i}", {}
        for attn in ("self_attn", "cross_attn"):
            if f"{lp}.{attn}.q.weight" not in sd:
                continue
            lt[attn] = {}
            for n in ("q", "k", "v"):
                w = _np(sd[f"{lp}.{attn}.{n}.weight"])  # [H*d_kv, d]
                lt[attn][n] = {"kernel": w.T.reshape(
                    w.shape[1], num_heads, -1).copy()}
            o = _np(sd[f"{lp}.{attn}.o.weight"])  # [d, H*d_kv]
            lt[attn]["o"] = {"kernel": o.T.reshape(num_heads, -1,
                                                   o.shape[0]).copy()}
        for ln in ("self_attn_ln", "cross_attn_ln", "ff_ln"):
            if f"{lp}.{ln}.weight" in sd:
                lt[ln] = {"weight": _np(sd[f"{lp}.{ln}.weight"])}
        lt["ff"] = {n: _dense_to_jax(sd, f"{lp}.ff.{n}")
                    for n in ("wi", "wi_0", "wi_1", "wo")
                    if f"{lp}.ff.{n}.weight" in sd}
        tree[f"{jax_name}_{i}"] = lt


def t5_state_to_jax(sd: Mapping, prefix: str, num_heads: int) -> dict:
    """The port's T5 module state -> its Flax tree."""
    p = f"{prefix}." if prefix else ""
    tree = {"shared": {"embedding": _np(sd[f"{p}shared.weight"])}}
    for name in ("rel_bias", "enc_rel_bias", "dec_rel_bias"):
        if f"{p}{name}" in sd:
            tree[name] = _np(sd[f"{p}{name}"])
    for name in ("final_ln", "enc_final_ln", "dec_final_ln"):
        if f"{p}{name}.weight" in sd:
            tree[name] = {"weight": _np(sd[f"{p}{name}.weight"])}
    if f"{p}lm_head.weight" in sd:
        tree["lm_head"] = _dense_to_jax(sd, f"{p}lm_head")
    for ours, jax_name in (("layers", "layer"), ("enc_layers", "enc_layer"),
                           ("dec_layers", "dec_layer")):
        _t5_layers_to_jax(sd, f"{p}{ours}", jax_name, num_heads, tree)
    return tree


def _any_encoder_to_jax(sd: Mapping, prefix: str, num_heads: int) -> dict:
    p = f"{prefix}." if prefix else ""
    if f"{p}shared.weight" in sd:
        return t5_state_to_jax(sd, prefix, num_heads)
    return encoder_state_to_jax(sd, prefix, num_heads)


def params_to_jax(state_dict: Mapping, num_heads: int) -> dict:
    """A port ``state_dict`` -> the JAX package's Flax tree (the inverse of
    ``params_from_jax``). A ``DRModel`` state (``encoder_q.`` keys) gives
    ``{"encoder_q", ["encoder_p"], ["head_q"], ["head_p"]}``, an ``RRModel``
    state (``encoder.`` keys) ``{"encoder", ["head"]}``; a bare encoder
    state gives the encoder tree. ``num_heads`` splits the attention
    weights into the ``DenseGeneral`` layouts."""
    if any(k.startswith("encoder_q.") for k in state_dict):
        towers, heads = ("encoder_q", "encoder_p"), ("head_q", "head_p")
    elif any(k.startswith("encoder.") for k in state_dict):
        towers, heads = ("encoder",), ("head",)
    else:
        return _sorted(_any_encoder_to_jax(state_dict, "", num_heads))
    tree = {}
    for tower in towers:
        if any(k.startswith(tower + ".") for k in state_dict):
            tree[tower] = _any_encoder_to_jax(state_dict, tower, num_heads)
    for head in heads:
        if f"{head}.linear.weight" in state_dict:
            tree[head] = {"linear": _dense_to_jax(state_dict,
                                                  f"{head}.linear")}
    return _sorted(tree)


def _sorted(tree):
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


# ---- the v1 rerankers -------------------------------------------------------


def _v1_encoder_from_jax(tree: Mapping, name: str,
                         out: Dict[str, torch.Tensor]):
    """A ``Conv1DEncoder`` or ``TransformerEncoder`` subtree."""
    for key, sub in tree.items():
        if key.startswith("conv_"):
            kernel = np.asarray(sub["kernel"])  # [W, in, out]
            out[f"{name}.convs.{key}.weight"] = _t(kernel.transpose(2, 1, 0))
            out[f"{name}.convs.{key}.bias"] = _t(sub["bias"])
            continue
        lp = f"{name}.layers.{int(key.split('_')[1])}"
        for n in ("q", "k", "v"):
            kernel = np.asarray(sub[n]["kernel"])  # [D, H, hd]
            out[f"{lp}.{n}.weight"] = _t(kernel.reshape(kernel.shape[0], -1).T)
            out[f"{lp}.{n}.bias"] = _t(np.asarray(sub[n]["bias"]).reshape(-1))
        kernel = np.asarray(sub["out"]["kernel"])  # [H, hd, D]
        out[f"{lp}.out.weight"] = _t(kernel.reshape(-1, kernel.shape[-1]).T)
        out[f"{lp}.out.bias"] = _t(sub["out"]["bias"])
        for ln in ("attn_ln", "ff_ln"):
            _layer_norm(sub[ln], f"{lp}.{ln}", out)
        for fc in ("fc1", "fc2"):
            _dense(sub[fc], f"{lp}.{fc}", out)


def v1_params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A v1 model's Flax parameter tree (numpy leaves) -> the state_dict of
    its ``v1/models.py`` counterpart."""
    out: Dict[str, torch.Tensor] = {}
    for name, sub in tree.items():
        if name == "bert":
            out.update(encoder_state_from_jax(sub, "bert"))
        elif name == "mixer":
            out["mixer"] = _t(sub)
        elif "embedding" in sub:
            out[f"{name}.embedding"] = _t(sub["embedding"])
        elif "kernel" in sub:
            _dense(sub, name, out)
        else:
            _v1_encoder_from_jax(sub, name, out)
    return out


def _v1_encoder_to_jax(sd: Mapping, name: str, num_heads: int) -> dict:
    tree = {}
    for key in sd:
        m = re.fullmatch(re.escape(name) + r"\.convs\.(conv_\d+)\.weight", key)
        if m:
            prefix = f"{name}.convs.{m.group(1)}"
            tree[m.group(1)] = {
                "kernel": _np(sd[key]).transpose(2, 1, 0).copy(),
                "bias": _np(sd[f"{prefix}.bias"])}
    layers = sorted({int(m.group(1)) for key in sd if (m := re.match(
        re.escape(name) + r"\.layers\.(\d+)\.", key))})
    for i in layers:
        lp, lt = f"{name}.layers.{i}", {}
        for n in ("q", "k", "v"):
            w = _np(sd[f"{lp}.{n}.weight"])  # [H*hd, D]
            lt[n] = {"kernel": w.T.reshape(w.shape[1], num_heads, -1).copy(),
                     "bias": _np(sd[f"{lp}.{n}.bias"]).reshape(num_heads, -1)}
        o = _np(sd[f"{lp}.out.weight"])  # [D, H*hd]
        lt["out"] = {"kernel": o.T.reshape(num_heads, -1, o.shape[0]).copy(),
                     "bias": _np(sd[f"{lp}.out.bias"])}
        for ln in ("attn_ln", "ff_ln"):
            lt[ln] = _layer_norm_to_jax(sd, f"{lp}.{ln}")
        for fc in ("fc1", "fc2"):
            lt[fc] = _dense_to_jax(sd, f"{lp}.{fc}")
        tree[f"layer_{i}"] = lt
    return tree


def v1_params_to_jax(state_dict: Mapping, num_heads: int = 1) -> dict:
    """A v1 model's ``state_dict`` (or any mapping of its parameter names,
    such as Adam's moments) -> the Flax tree, keys sorted (the inverse of
    ``v1_params_from_jax``). ``num_heads``: TK's ``head_num`` or the BERT
    encoder's ``num_attention_heads``, which split the attention
    weights."""
    tree = {}
    for name in sorted({k.split(".")[0] for k in state_dict}):
        if name == "bert":
            tree["bert"] = encoder_state_to_jax(state_dict, "bert", num_heads)
        elif name == "mixer":
            tree["mixer"] = _np(state_dict["mixer"])
        elif f"{name}.embedding" in state_dict:
            tree[name] = {"embedding": _np(state_dict[f"{name}.embedding"])}
        elif f"{name}.weight" in state_dict:
            tree[name] = _dense_to_jax(state_dict, name)
        else:
            tree[name] = _v1_encoder_to_jax(state_dict, name, num_heads)
    return _sorted(tree)


# ---- the research recipes ---------------------------------------------------


def mlm_params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """An ``MLMModel`` Flax tree (``bert``, ``transform``, ``transform_ln``,
    ``decoder_bias``) -> the port's ``research.mlm.MLMModel`` state."""
    out = encoder_state_from_jax(tree["bert"], "bert")
    _dense(tree["transform"], "transform", out)
    _layer_norm(tree["transform_ln"], "transform_ln", out)
    out["decoder_bias"] = _t(tree["decoder_bias"])
    return out


def mlm_params_to_jax(state_dict: Mapping, num_heads: int) -> dict:
    """The port's ``MLMModel`` state (or a mapping of its parameter names,
    such as Adam's moments) -> the Flax tree, keys sorted."""
    return _sorted({
        "bert": encoder_state_to_jax(state_dict, "bert", num_heads),
        "transform": _dense_to_jax(state_dict, "transform"),
        "transform_ln": _layer_norm_to_jax(state_dict, "transform_ln"),
        "decoder_bias": _np(state_dict["decoder_bias"]),
    })


def policy_params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A ``DataSelectionPolicy`` Flax tree (``fc1``, ``fc2``) -> the port's
    module state."""
    out: Dict[str, torch.Tensor] = {}
    for name in ("fc1", "fc2"):
        _dense(tree[name], name, out)
    return out


def policy_params_to_jax(state_dict: Mapping) -> dict:
    """The port's ``DataSelectionPolicy`` state -> the Flax tree."""
    return {name: _dense_to_jax(state_dict, name) for name in ("fc1", "fc2")}
