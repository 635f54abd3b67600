"""Scale T5 weights for reduced-precision stability (twin of
``scripts/scale_t5_weights.py``).

    python -m openmatch_tpu_torch.scripts.scale_t5_weights \
        --input_model_path in --output_model_path out [--num_layers 12]

Divides the attention output projections and the shared embedding by 100
and the FFN weights by 10, so fp16 / bf16 activations stay in range. An
OpenMatch checkpoint (``openmatch_config.json``) is scaled in its
``params.msgpack`` Flax tree, read and written with the port's codec
(``models/flax_msgpack.py``): the bytes the JAX script writes. Any other
directory is an HF T5 checkpoint, read with the port's HF reader and laid
out as ``transformers.AutoModel`` (``T5Model``) holds it: the encoder and
decoder keys, each ``embed_tokens`` a copy of ``shared`` when the file
leaves it out, no ``lm_head``, fp32. Then, as the JAX script does, only
``wi`` and ``wo`` of the FFNs and only ``shared.weight`` among the
embeddings are scaled, the result goes to ``pytorch_model.bin``
(``torch.save``), and every other file of the directory is copied.
"""

import argparse
import json
import os
import re
import shutil

import torch

from ..models.flax_msgpack import read_flax_msgpack, write_flax_msgpack
from ..models.hf_convert import read_hf_state_dict


def scale_flax_encdec(params: dict, num_layers: int) -> dict:
    """Scale a ``T5EncoderDecoderStep`` Flax tree in place."""
    for i in range(num_layers):
        for stack in ("enc", "dec"):
            blk = params.get(f"{stack}_layer_{i}")
            if blk is None:
                continue
            blk["self_attn"]["o"]["kernel"] = \
                blk["self_attn"]["o"]["kernel"] / 100
            if "cross_attn" in blk:
                blk["cross_attn"]["o"]["kernel"] = \
                    blk["cross_attn"]["o"]["kernel"] / 100
            for w in ("wi", "wi_0", "wi_1", "wo"):
                if w in blk["ff"]:
                    blk["ff"][w]["kernel"] = blk["ff"][w]["kernel"] / 10
    params["shared"]["embedding"] = params["shared"]["embedding"] / 100
    return params


def scale_flax_encoder(params: dict, num_layers: int) -> dict:
    """Scale a ``T5Encoder`` Flax tree in place."""
    for i in range(num_layers):
        blk = params.get(f"layer_{i}")
        if blk is None:
            continue
        blk["self_attn"]["o"]["kernel"] = blk["self_attn"]["o"]["kernel"] / 100
        for w in ("wi", "wi_0", "wi_1", "wo"):
            if w in blk["ff"]:
                blk["ff"][w]["kernel"] = blk["ff"][w]["kernel"] / 10
    params["shared"]["embedding"] = params["shared"]["embedding"] / 100
    return params


def _scale_tree(tree: dict, num_layers: int):
    if any(k.startswith("enc_layer_") for k in tree):
        scale_flax_encdec(tree, num_layers)
    else:
        scale_flax_encoder(tree, num_layers)


# T5Model's registration order, for the state dict's key order
_MODULE_ORDER = ("embed_tokens", "block", "final_layer_norm")
_SUB_ORDER = ("SelfAttention", "EncDecAttention", "DenseReluDense",
              "layer_norm")
_LEAF_ORDER = ("q", "k", "v", "o", "relative_attention_bias", "wi", "wi_0",
               "wi_1", "wo", "weight")


def _t5model_key(key: str):
    """Sort key of ``key`` in ``T5Model.state_dict()``'s order."""
    if key == "shared.weight":
        return (0,)
    parts = key.split(".")
    stack = ("encoder", "decoder").index(parts[0]) + 1
    module = _MODULE_ORDER.index(parts[1])
    if parts[1] != "block":
        return (stack, module)
    block, layer = int(parts[2]), int(parts[4])
    rest = [_SUB_ORDER.index(parts[5])]
    rest += [_LEAF_ORDER.index(p) for p in parts[6:] if p in _LEAF_ORDER]
    return (stack, module, block, layer, *rest)


def t5model_state(sd: dict) -> dict:
    """An HF T5 checkpoint's state dict as ``AutoModel`` (``T5Model``)
    holds it: ``shared``, the encoder and (when present) the decoder, each
    stack's ``embed_tokens`` a copy of ``shared`` when the file leaves it
    out, fp32, in the module's order."""
    stacks = ["encoder"] + (["decoder"] if any(
        k.startswith("decoder.") for k in sd) else [])
    shared = sd["shared.weight"] if "shared.weight" in sd \
        else sd["encoder.embed_tokens.weight"]
    out = {"shared.weight": shared}
    for stack in stacks:
        out.setdefault(f"{stack}.embed_tokens.weight", shared)
    out.update({k: v for k, v in sd.items()
                if re.match(r"(encoder|decoder)\.", k)
                and k.split(".")[0] in stacks})
    return {k: out[k].float().clone()
            for k in sorted(out, key=_t5model_key)}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--input_model_path", type=str, required=True)
    parser.add_argument("--output_model_path", type=str, required=True)
    parser.add_argument("--num_layers", type=int, default=12)
    args = parser.parse_args(argv)

    om_cfg = os.path.join(args.input_model_path, "openmatch_config.json")
    if os.path.exists(om_cfg):
        params = read_flax_msgpack(os.path.join(args.input_model_path,
                                                "params.msgpack"))
        with open(om_cfg) as f:
            cfg = json.load(f)
        _scale_tree(params.get("encoder_q", params.get("encoder")),
                    args.num_layers)
        if "encoder_p" in params:
            _scale_tree(params["encoder_p"], args.num_layers)
        os.makedirs(args.output_model_path, exist_ok=True)
        write_flax_msgpack(params, os.path.join(args.output_model_path,
                                                "params.msgpack"))
        with open(os.path.join(args.output_model_path,
                               "openmatch_config.json"), "w") as f:
            json.dump(cfg, f, indent=4)
    else:
        sd = t5model_state(read_hf_state_dict(args.input_model_path))
        for i in range(args.num_layers):
            sd[f"encoder.block.{i}.layer.0.SelfAttention.o.weight"] /= 100
            sd[f"encoder.block.{i}.layer.1.DenseReluDense.wi.weight"] /= 10
            sd[f"encoder.block.{i}.layer.1.DenseReluDense.wo.weight"] /= 10
            if f"decoder.block.{i}.layer.0.SelfAttention.o.weight" in sd:
                sd[f"decoder.block.{i}.layer.1.EncDecAttention.o.weight"] /= 100
                sd[f"decoder.block.{i}.layer.0.SelfAttention.o.weight"] /= 100
                sd[f"decoder.block.{i}.layer.2.DenseReluDense.wi.weight"] /= 10
                sd[f"decoder.block.{i}.layer.2.DenseReluDense.wo.weight"] /= 10
        sd["shared.weight"] /= 100
        os.makedirs(args.output_model_path, exist_ok=True)
        torch.save(sd, os.path.join(args.output_model_path,
                                    "pytorch_model.bin"))
        for name in os.listdir(args.input_model_path):
            if name not in ("pytorch_model.bin", "model.safetensors"):
                src = os.path.join(args.input_model_path, name)
                if os.path.isfile(src):
                    shutil.copy(src, args.output_model_path)
    print(f"scaled -> {args.output_model_path}")


if __name__ == "__main__":
    main()
