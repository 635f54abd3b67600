"""Domain-adaptive MLM pretraining of a BERT encoder (port of the JAX
``train_mlm`` driver).

    python -m openmatch_tpu_torch.drivers.train_mlm \
        --model_name_or_path bert-base-uncased --train_path corpus.txt \
        --output_dir mlm_out --max_steps 10000 [--device cuda]

Input: one text per line (txt) or jsonl with a "text" field, cycled
until ``--max_steps`` (10,000 when unset). The head is ``research.mlm``'s
(seeded with ``--seed``), the encoder an HF BERT / RoBERTa / ELECTRA
directory; the masks are drawn from a ``torch.Generator`` seeded with
``--seed`` on the device. ``--output_dir`` receives ``train_state.msgpack``
in the JAX package's layout (the ``MLMModel`` tree and optax's chain
state), the encoder exported as a ``DRModel`` checkpoint
(``openmatch_config.json``, ``params.msgpack``) that both packages load,
and the tokenizer when it has ``save_pretrained``. ``main`` takes
``tokenizer=`` (an HF-style tokenizer with ``mask_token_id`` and
``all_special_ids``) in place of loading one.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..config import (ArgumentParser, DataArguments, ModelArguments,
                      TrainingArguments)
from ..data.loader import batched, prefetch
from ..models.dr_model import DRModel
from ..models.flax_msgpack import write_flax_msgpack
from ..models.hf_convert import load_bert_encoder
from ..models.jax_convert import mlm_params_to_jax
from ..research.mlm import MLMModel, mask_tokens, mlm_logits, mlm_loss
from ..train.state import make_optimizer, optax_state_tree
from .common import (load_tokenizer, refuse_ranks, setup_logging,
                     split_device_flag)

TRAIN_STATE = "train_state.msgpack"


def iter_texts(path: str):
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if path.endswith((".json", ".jsonl")):
                yield json.loads(line).get("text", "")
            else:
                yield line


def save_mlm_state(step: int, model: MLMModel, optimizer, output_dir: str):
    """``train_state.msgpack`` ({"step", "params", "opt_state"} in the JAX
    package's layout) and ``train_state.json``."""
    os.makedirs(output_dir, exist_ok=True)
    heads = model.config.num_attention_heads
    payload = {
        "step": np.asarray(step, np.int32),
        "params": mlm_params_to_jax(model.state_dict(), heads),
        "opt_state": optax_state_tree(
            optimizer, model.named_parameters(),
            lambda named: mlm_params_to_jax(named, heads)),
    }
    write_flax_msgpack(payload, os.path.join(output_dir, TRAIN_STATE))
    with open(os.path.join(output_dir, "train_state.json"), "w") as f:
        json.dump({"step": int(step)}, f)


def main(argv=None, tokenizer=None):
    """Returns {"losses": the logged mean losses, "final_step",
    "model": the trained ``MLMModel``}."""
    setup_logging()
    device, rest = split_device_flag(argv)
    parser = ArgumentParser((ModelArguments, DataArguments,
                             TrainingArguments))
    model_args, data_args, train_args = parser.parse(rest)
    refuse_ranks("train_mlm")

    if tokenizer is None:
        tokenizer = load_tokenizer(model_args)
    config, enc_state = load_bert_encoder(model_args.model_name_or_path)
    model = MLMModel(config)
    model.init_head(train_args.seed)
    model.bert.load_state_dict(enc_state, strict=True)
    model.to(device).train()

    total_steps = train_args.max_steps if train_args.max_steps > 0 \
        else 10_000
    optimizer, scheduler = make_optimizer(list(model.parameters()),
                                          train_args, total_steps)
    generator = torch.Generator(device=device).manual_seed(train_args.seed)
    mask_id = tokenizer.mask_token_id
    special = tuple(tokenizer.all_special_ids)

    def encode(text):
        enc = tokenizer(text, truncation=True,
                        max_length=data_args.p_max_len,
                        padding="max_length", return_tensors="np")
        return (enc["input_ids"][0].astype(np.int64),
                enc["attention_mask"][0].astype(np.int64))

    def batches():
        while True:
            stream = (encode(t) for t in iter_texts(data_args.train_path))
            yield from batched(
                stream, train_args.per_device_train_batch_size,
                lambda xs: (np.stack([x[0] for x in xs]),
                            np.stack([x[1] for x in xs])),
                drop_last=True)

    step, log_loss, losses = 0, 0.0, []
    for ids, mask in prefetch(batches(), depth=4):
        if step >= total_steps:
            break
        ids = torch.from_numpy(ids).to(device)
        mask = torch.from_numpy(mask).to(device)
        masked, labels = mask_tokens(ids, mask, mask_id, config.vocab_size,
                                     special, generator=generator)
        optimizer.zero_grad(set_to_none=True)
        loss = mlm_loss(mlm_logits(model, masked, mask), labels)
        loss.backward()
        optimizer.step()
        scheduler.step()
        step += 1
        log_loss += float(loss.detach())
        if step % train_args.logging_steps == 0:
            avg = log_loss / train_args.logging_steps
            print(f"step {step}/{total_steps} mlm loss {avg:.4f}")
            losses.append(avg)
            log_loss = 0.0

    out_dir = train_args.output_dir
    save_mlm_state(step, model, optimizer, out_dir)
    # the encoder alone, in the DRModel layout
    dr = DRModel(encoder_config=config, tied=True)
    dr.encoder_q.load_state_dict(model.bert.state_dict(), strict=True)
    dr.save(out_dir)
    if hasattr(tokenizer, "save_pretrained"):
        tokenizer.save_pretrained(out_dir)
    print(f"saved MLM-adapted encoder -> {out_dir}")
    return {"losses": losses, "final_step": step, "model": model}


if __name__ == "__main__":
    main()
