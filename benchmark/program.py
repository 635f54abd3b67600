"""The system under test, built from a configuration and seeded weights.

The only place the harness reaches into the program
(``openmatch_tpu_torch``) to build it: the dense-retrieval model through
the program's own HuggingFace converters, so its weights are the
benchmark's published-layout ones."""

from __future__ import annotations

from typing import Dict

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}


def encoder_config_and_state(cfg: dict, hf: Dict[str, torch.Tensor]):
    """(backbone, encoder config, encoder state in the program's names)."""
    if cfg["model_type"] == "bert":
        from openmatch_tpu_torch.models.hf_convert import (
            bert_config_from_hf, encoder_state_from_hf)

        enc_cfg = bert_config_from_hf(cfg)
        return "bert", enc_cfg, encoder_state_from_hf(hf, enc_cfg)
    if cfg["model_type"] == "t5":
        from openmatch_tpu_torch.models.t5 import (encdec_state_from_hf,
                                                   t5_config_from_hf)

        enc_cfg = t5_config_from_hf(cfg)
        return "t5_encdec", enc_cfg, encdec_state_from_hf(hf, enc_cfg)
    raise ValueError(f"no program model for model_type "
                     f"{cfg['model_type']!r}")


def dr_model(cfg: dict, hf: Dict[str, torch.Tensor], device):
    """The configuration's ``DRModel`` (tied towers) on ``device``, its
    parameters fp32 and its compute in ``cfg["dr"]["dtype"]``."""
    from openmatch_tpu_torch.models.dr_model import DRModel

    dr = cfg["dr"]
    backbone, enc_cfg, state = encoder_config_and_state(cfg, hf)
    with torch.device(device):
        model = DRModel(encoder_config=enc_cfg, backbone_type=backbone,
                        tied=True, pooling=dr.get("pooling", "first"),
                        normalize=dr.get("normalize", False),
                        dtype=DTYPES[dr["dtype"]])
    model.load_state_dict({f"encoder_q.{k}": v for k, v in state.items()})
    return model


def published_leaf_ids(cfg: dict, device) -> tuple:
    """(published names, {program leaf: int32 tensor}): for each element
    of each program leaf, the index of the published (HuggingFace) leaf it
    is loaded from, found by loading leaves filled with their own index
    through the program's converter. Norms can then be taken per published
    leaf whatever the program fuses (its qkv holds the key bias, whose
    gradient is rounding alone)."""
    from .weights import SHAPES

    shapes = SHAPES[cfg["model_type"]](cfg)
    names = [n for n, _, _ in shapes]
    filled = {n: torch.full(s, float(i), device=device)
              for i, (n, s, _) in enumerate(shapes)}
    state = encoder_config_and_state(cfg, filled)[2]
    return names, {k: v.to(torch.int32) for k, v in state.items()}


def published_norms(tensors: Dict[str, torch.Tensor], leaf_ids: dict,
                    n_published: int) -> torch.Tensor:
    """The L2 norm per published leaf [n_published] of program-named
    ``tensors`` (keys without the tower prefix)."""
    sq = None
    for name, t in tensors.items():
        ids = leaf_ids[name].reshape(-1).long()
        part = torch.zeros(n_published, dtype=torch.float64,
                           device=t.device).index_add_(
            0, ids, t.detach().reshape(-1).double().square())
        sq = part if sq is None else sq + part
    return sq.sqrt()
