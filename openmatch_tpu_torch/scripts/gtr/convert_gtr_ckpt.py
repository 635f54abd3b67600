"""Convert a sentence-transformers GTR checkpoint to an OpenMatch
``DRModel`` directory (twin of ``scripts/gtr/convert_gtr_ckpt.py``).

    python -m openmatch_tpu_torch.scripts.gtr.convert_gtr_ckpt \
        --input gtr-t5-base-dir --output om_gtr

GTR ships as a sentence-transformers directory: a T5 encoder, mean
pooling, a ``2_Dense`` linear head and L2 normalisation. The output is a
``DRModel`` checkpoint (``openmatch_config.json``, ``params.msgpack``)
with backbone ``t5`` (the encoder alone), mean pooling, the head and
``normalize=True``; without a ``2_Dense`` directory, no head. The encoder
is read by ``models.t5.load_t5_encoder``, the head's ``linear.weight``
from ``2_Dense/pytorch_model.bin`` or ``2_Dense/model.safetensors``, and
the checkpoint written by ``DRModel.save``: the bytes the JAX script
writes.
"""

import argparse
import json
import os

import torch

from ...models.dr_model import DRModel
from ...models.hf_convert import read_safetensors
from ...models.t5 import load_t5_encoder


def load_dense_head(dense_dir: str):
    """A sentence-transformers Dense module (``config.json`` and weights;
    GTR's has no bias) -> (in_features, out_features, weight [out, in])."""
    with open(os.path.join(dense_dir, "config.json")) as f:
        cfg = json.load(f)
    for name in ("pytorch_model.bin", "model.safetensors"):
        path = os.path.join(dense_dir, name)
        if os.path.exists(path):
            if name.endswith(".bin"):
                sd = torch.load(path, map_location="cpu", weights_only=True)
            else:
                sd = read_safetensors(path)
            break
    else:
        raise FileNotFoundError(f"no weights in {dense_dir}")
    return cfg["in_features"], cfg["out_features"], \
        sd["linear.weight"].float()


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--input", required=True,
                        help="sentence-transformers GTR dir")
    parser.add_argument("--output", required=True)
    args = parser.parse_args(argv)

    enc_cfg, enc_state = load_t5_encoder(args.input)
    dense_dir = os.path.join(args.input, "2_Dense")
    has_head = os.path.isdir(dense_dir)
    if has_head:
        in_dim, out_dim, weight = load_dense_head(dense_dir)
    else:
        in_dim = out_dim = enc_cfg.d_model

    model = DRModel(encoder_config=enc_cfg, backbone_type="t5", tied=True,
                    pooling="mean", normalize=True, has_head=has_head,
                    head_in_dim=in_dim, head_out_dim=out_dim)
    state = {f"encoder_q.{k}": v for k, v in enc_state.items()}
    if has_head:
        state["head_q.linear.weight"] = weight
    model.load_state_dict(state, strict=True)
    model.save(args.output)
    print(f"converted GTR -> {args.output} (head={has_head}, dim "
          f"{in_dim}->{out_dim})")


if __name__ == "__main__":
    main()
