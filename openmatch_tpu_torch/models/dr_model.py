"""Bi-encoder dense retrieval model as an ``nn.Module``.

Port of ``openmatch_tpu/models/dr_model.py`` for inference: tied or untied
query/passage towers, "first"/"mean" pooling, an optional bias-free head
and optional L2 normalisation. ``DRModel.load`` reads the JAX package's
checkpoint directory (``openmatch_config.json`` plus flax-msgpack
``params.msgpack``), so a model trained there serves here unchanged.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from ..device import resolve_device, resolve_dtype
from .bert import BertConfig, BertEncoder
from .jax_convert import params_from_jax
from .pooling import LinearHead, pool_hidden

OPENMATCH_CONFIG = "openmatch_config.json"
_T5_TODO = ("T5 backbones ({}) are not ported to PyTorch yet; they follow "
            "in the port's T5 step (ROADMAP.md, P7)")


class DRModel(nn.Module):
    def __init__(
        self,
        encoder_config: BertConfig,
        backbone_type: str = "bert",
        tied: bool = True,
        feature: str = "last_hidden_state",
        pooling: str = "first",
        normalize: bool = False,
        has_head: bool = False,
        head_in_dim: int = 768,
        head_out_dim: int = 768,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if backbone_type in ("t5", "t5_encdec"):
            raise NotImplementedError(_T5_TODO.format(backbone_type))
        if backbone_type != "bert":
            raise ValueError(f"Unknown backbone type {backbone_type}")
        self.encoder_config = encoder_config
        self.backbone_type = backbone_type
        self.tied = tied
        self.feature = feature
        self.pooling = pooling
        self.normalize = normalize
        self.has_head = has_head
        self.head_in_dim = head_in_dim
        self.head_out_dim = head_out_dim
        self.dtype = dtype
        self.encoder_q = BertEncoder(encoder_config, dtype)
        self.encoder_p = None if tied else BertEncoder(encoder_config, dtype)
        self.head_q = LinearHead(head_in_dim, head_out_dim) if has_head else None
        self.head_p = (LinearHead(head_in_dim, head_out_dim)
                       if has_head and not tied else None)

    @property
    def out_dim(self) -> int:
        return self.head_out_dim if self.has_head \
            else self.encoder_config.hidden_size

    def encode(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
               is_query: bool = False) -> torch.Tensor:
        """Token ids [B, S] -> representations [B, D] in ``dtype``."""
        query_tower = is_query or self.tied
        encoder = self.encoder_q if query_tower else self.encoder_p
        head = self.head_q if query_tower else self.head_p
        hidden = encoder(input_ids, attention_mask)[self.feature]
        reps = pool_hidden(hidden, attention_mask, self.pooling)
        if head is not None:
            reps = head(reps)
        if self.normalize:
            norm = torch.linalg.vector_norm(reps, dim=-1, keepdim=True)
            reps = reps / norm.clamp_min(1e-12)
        return reps

    def encode_query(self, input_ids, attention_mask):
        return self.encode(input_ids, attention_mask, is_query=True)

    def encode_passage(self, input_ids, attention_mask):
        return self.encode(input_ids, attention_mask, is_query=False)

    # ---- construction ---------------------------------------------------

    def config_dict(self) -> Dict[str, Any]:
        return {
            "tied": self.tied,
            "plm_backbone": {"type": self.backbone_type,
                             "feature": self.feature},
            "pooling": self.pooling,
            "linear_head": self.has_head,
            "normalize": self.normalize,
            "head_in_dim": self.head_in_dim,
            "head_out_dim": self.head_out_dim,
            "encoder_config": self.encoder_config.to_dict(),
        }

    @classmethod
    def from_config_dict(cls, cfg: Dict[str, Any],
                         dtype: torch.dtype = torch.float32) -> "DRModel":
        backbone = cfg["plm_backbone"]["type"]
        if backbone in ("t5", "t5_encdec"):
            raise NotImplementedError(_T5_TODO.format(backbone))
        return cls(
            encoder_config=BertConfig(**cfg["encoder_config"]),
            backbone_type=backbone,
            tied=cfg["tied"],
            feature=cfg["plm_backbone"]["feature"],
            pooling=cfg["pooling"],
            normalize=cfg["normalize"],
            has_head=cfg["linear_head"],
            head_in_dim=cfg.get("head_in_dim", 768),
            head_out_dim=cfg.get("head_out_dim", 768),
            dtype=dtype,
        )

    @classmethod
    def load(cls, ckpt_dir: str, dtype=torch.float32,
             device="cuda") -> "DRModel":
        """Read a JAX-package checkpoint directory; weights stay fp32 and
        ``dtype`` is the compute dtype. Returns the model in eval mode on
        ``device``: the card unless the caller names the CPU. The device is
        resolved first, so asking for a card that is not there raises before
        anything is read."""
        device = resolve_device(device)
        with open(os.path.join(ckpt_dir, OPENMATCH_CONFIG)) as f:
            cfg = json.load(f)
        model = cls.from_config_dict(cfg, resolve_dtype(dtype))
        tree = read_flax_msgpack(os.path.join(ckpt_dir, "params.msgpack"))
        model.load_state_dict(params_from_jax(tree), strict=True)
        return model.to(device).eval()

    @classmethod
    def build(cls, model_args, device="cuda") -> "DRModel":
        """``ModelArguments`` -> a loaded model (the drivers' entry), on the
        card unless the caller names the CPU."""
        device = resolve_device(device)
        path = model_args.model_name_or_path
        if path and os.path.exists(os.path.join(path, OPENMATCH_CONFIG)):
            return cls.load(path, dtype=model_args.dtype, device=device)
        raise NotImplementedError(
            f"{path!r} is not an OpenMatch checkpoint directory (no "
            f"{OPENMATCH_CONFIG}). The PyTorch port loads those only; "
            "convert a raw HuggingFace checkpoint with openmatch_tpu's "
            "DRModel.build(...) followed by DRModel.save(...).")


# ---- flax msgpack ---------------------------------------------------------


def _ndarray_from_bytes(msgpack, data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":  # widen bf16 bit patterns to fp32 exactly
        bits = np.frombuffer(buffer, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())
                         ).reshape(shape)


def _unchunk(d):
    """Reassemble arrays that flax split into chunks (leaves > 1 GiB)."""
    if isinstance(d, dict):
        if "__msgpack_chunked_array__" in d:
            shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
            chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in d.items()}
    return d


def read_flax_msgpack(path: str) -> Dict[str, Any]:
    """``flax.serialization.msgpack_restore`` without flax: ndarray leaves
    are msgpack ext type 1 holding (shape, dtype name, C-order bytes)."""
    try:
        import msgpack
    except ImportError:
        raise RuntimeError(f"reading {path} needs the 'msgpack' package, "
                           "which is not installed") from None

    def ext_hook(code, data):
        if code == 1:  # ndarray
            return _ndarray_from_bytes(msgpack, data)
        if code == 2:  # native complex
            re_, im = msgpack.unpackb(data)
            return complex(re_, im)
        if code == 3:  # numpy scalar
            return _ndarray_from_bytes(msgpack, data)[()]
        return msgpack.ExtType(code, data)

    with open(path, "rb") as f:
        tree = msgpack.unpackb(f.read(), ext_hook=ext_hook, raw=False)
    return _unchunk(tree)
