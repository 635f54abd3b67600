"""Train a dense retriever (port of the JAX ``train_dr`` driver).

    python -m openmatch_tpu_torch.drivers.train_dr \
        --model_name_or_path bert-base-uncased \
        --train_path train.jsonl --output_dir out \
        [--negatives_x_device] [--grad_cache] [--device cuda]

``--model_name_or_path`` is an OpenMatch checkpoint directory or a raw
HuggingFace BERT / RoBERTa / ELECTRA directory. On N ranks,

    torchrun --nproc_per_node=N -m openmatch_tpu_torch.drivers.train_dr \
        ... [--dp_size D --tp_size T]

each rank reads the dataset shard ``rank // tp`` of ``dp`` and feeds
``per_device_train_batch_size`` rows a step; steps are counted in global
batches of ``per_device_train_batch_size x dp`` (JAX ``train_dr``). Rank 0
writes the model. A ``checkpoint-N`` under ``--output_dir`` written by this
port is resumed on every rank.
"""

from __future__ import annotations

import math

from ..config import (ArgumentParser, DataArguments, ModelArguments,
                      TrainingArguments)
from ..data.collators import QPCollator
from ..data.train_dataset import DRTrainDataset
from ..models.dr_model import DRModel
from ..parallel.mesh import make_mesh
from ..train.dr_trainer import DRTrainer
from .common import (epochs_iterator, load_tokenizer, maybe_init_distributed,
                     setup_logging, split_device_flag)


def main(argv=None, tokenizer=None):
    """``tokenizer``: used as given; by default ``load_tokenizer``. Returns
    the trainer's ``{"losses", "final_step"}``."""
    setup_logging()
    device, rest = split_device_flag(argv)
    parser = ArgumentParser((ModelArguments, DataArguments,
                             TrainingArguments))
    model_args, data_args, train_args = parser.parse(rest)
    maybe_init_distributed(device)
    mesh = make_mesh(train_args.dp_size, train_args.tp_size, device)

    if tokenizer is None:
        tokenizer = load_tokenizer(model_args)
    model = DRModel.build(model_args, device=device)
    dataset = DRTrainDataset(tokenizer, data_args,
                             shuffle_seed=train_args.seed,
                             shard_index=mesh.data_index,
                             num_shards=mesh.shape["data"])
    batch = train_args.per_device_train_batch_size
    global_batch = batch * mesh.shape["data"]
    steps_per_epoch = max(len(dataset) // max(global_batch, 1), 1)
    num_epochs = int(math.ceil(train_args.num_train_epochs))
    total_steps = (train_args.max_steps if train_args.max_steps > 0
                   else steps_per_epoch * num_epochs)

    trainer = DRTrainer(model, train_args, total_steps=total_steps,
                        device=device, mesh=mesh)
    trainer.maybe_resume()
    collator = QPCollator(pad_token_id=tokenizer.pad_token_id or 0,
                          q_max_len=data_args.q_max_len,
                          p_max_len=data_args.p_max_len)
    data_iter = epochs_iterator(dataset, collator, batch, num_epochs,
                                train_args.seed)
    result = trainer.train(data_iter)
    trainer.save_model()
    if mesh.rank == 0 and hasattr(tokenizer, "save_pretrained"):
        tokenizer.save_pretrained(train_args.output_dir)
    return result


if __name__ == "__main__":
    main()
