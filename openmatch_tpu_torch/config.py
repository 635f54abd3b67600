"""Configuration dataclasses and the argument parser.

The port's own copy of ``openmatch_tpu/config.py``: the four argument
dataclasses, ``_coerce``, ``ArgumentParser`` and ``save_config``, field for
field, so a flag list or a ``.json`` config parses to the same values in
both packages. The JAX module's ``resolve_dtype`` maps names to
``jax.numpy`` types; the port's is ``device.resolve_dtype``.

Parsing takes either CLI flags or a single path to a ``.json`` config file,
as the reference drivers do.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass
class ModelArguments:
    model_name_or_path: str = field(default=None, metadata={"help": "HF model id or local checkpoint dir"})
    target_model_path: Optional[str] = field(default=None, metadata={"help": "reranker target model path"})
    config_name: Optional[str] = None
    tokenizer_name: Optional[str] = None
    cache_dir: Optional[str] = None

    # modeling
    untie_encoder: bool = field(default=False, metadata={"help": "no weight sharing between query/passage encoders"})
    feature: str = field(default="last_hidden_state")
    pooling: str = field(default="first", metadata={"help": "first | mean"})
    add_linear_head: bool = False
    projection_in_dim: int = 768
    projection_out_dim: int = 768
    dtype: str = field(default="bfloat16", metadata={"help": "compute dtype: float32 | bfloat16 | float16"})
    param_dtype: str = field(default="float32", metadata={"help": "parameter dtype"})
    encoder_only: bool = field(default=False, metadata={"help": "use only the encoder stack of T5"})
    pos_token: Optional[str] = field(default=None, metadata={"help": "monoT5 'relevant' token"})
    neg_token: Optional[str] = field(default=None, metadata={"help": "monoT5 'irrelevant' token"})
    normalize: bool = field(default=False, metadata={"help": "L2-normalize embeddings"})


@dataclass
class DataArguments:
    train_dir: Optional[str] = None
    train_path: Optional[str] = None
    eval_path: Optional[str] = None
    query_path: Optional[str] = None
    corpus_path: Optional[str] = None
    data_dir: Optional[str] = None
    data_path: Optional[str] = None
    processed_data_path: Optional[str] = None
    dataset_name: Optional[str] = None
    passage_field_separator: str = " "
    dataset_proc_num: int = 4
    train_n_passages: int = 8
    positive_passage_no_shuffle: bool = False
    negative_passage_no_shuffle: bool = False

    encode_in_path: Optional[List[str]] = None
    encode_is_qry: bool = False
    encode_num_shard: int = 1
    encode_shard_index: int = 0

    q_max_len: int = 32
    p_max_len: int = 128
    data_cache_dir: Optional[str] = None

    query_template: str = "<text>"
    query_column_names: str = "id,text"
    doc_template: str = "Title: <title> Text: <text>"
    doc_column_names: str = "id,title,text"


@dataclass
class TrainingArguments:
    """Training config (replaces HF TrainingArguments); the same fields as
    the JAX package's, so one config file serves both."""

    output_dir: str = field(default="./output")
    do_train: bool = True
    seed: int = 42

    per_device_train_batch_size: int = 8
    learning_rate: float = 5e-6
    weight_decay: float = 0.0
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 1.0
    optimizer: str = field(default="adamw", metadata={
        "help": "adamw | lamb; lamb is the reference ANCE recipe's optimizer "
                "(v1/retrievers/ANCE/utils/lamb.py) for large-batch training"})
    num_train_epochs: float = 3.0
    max_steps: int = -1
    warmup_ratio: float = 0.1
    warmup_steps: int = 0
    logging_steps: int = 100
    save_steps: int = 10000
    eval_steps: Optional[int] = None

    # parallelism: product of mesh axes must equal device count.
    dp_size: int = field(default=-1, metadata={"help": "data-parallel axis size; -1 = all devices"})
    tp_size: int = field(default=1, metadata={"help": "tensor/model-parallel axis size"})

    # dense-retrieval specifics (reference: arguments.py:157-168)
    negatives_x_device: bool = field(default=False, metadata={"help": "share in-batch negatives across the dp axis"})
    grad_cache: bool = False
    gc_q_chunk_size: int = 4
    gc_p_chunk_size: int = 32
    dual_learning: bool = field(default=False, metadata={"help": "DANCE-style passage->query dual loss"})
    dual_weight: float = 0.1
    score_temperature: float = field(default=1.0, metadata={
        "help": "divide similarity scores by this in the contrastive loss; "
                "essential when --normalize bounds scores to [-1, 1] "
                "(try 0.01-0.05), harmless at 1.0 otherwise"})

    # reranker specifics (reference: arguments.py:171-181)
    margin: float = 1.0
    loss_fn: str = field(default="bce", metadata={"help": "mr | smr | bce | ce"})

    # data feeding
    dataloader_prefetch: int = 2
    shuffle_buffer_size: int = 10_000

    @property
    def train_batch_size(self) -> int:
        return self.per_device_train_batch_size


@dataclass
class InferenceArguments:
    output_dir: str = field(default="./output")
    per_device_eval_batch_size: int = 128
    encoded_save_path: Optional[str] = None
    trec_save_path: Optional[str] = None
    trec_run_path: Optional[str] = None
    id_key_name: str = "id"
    reranking_depth: Optional[int] = None
    retrieve_depth: int = 100
    search_method: str = field(default="auto", metadata={
        "help": "exact-MIPS engine: auto (pallas kernels on TPU, scan on "
                "CPU) | pallas | pyramid | hier2 | hier | topk | approx"})
    search_partition: str = field(default="docs", metadata={
        "help": "multi-chip search layout: docs (corpus row-sharded over "
                "the mesh, candidate all-gather merge) | queries (corpus "
                "replicated per chip, query batch split, no collectives "
                "- fastest when the index fits each chip's HBM)"})
    search_n_segs: int = field(default=1, metadata={
        "help": "hold the single-chip pallas index as this many HBM "
                "segment arrays (same search cost; use >1 when one "
                "index-sized allocation fails on a fragmented chip)"})
    max_inmem_docs: int = field(
        default=4_000_000,
        metadata={"help": "docs per partition for successive (memory-bounded) retrieval"},
    )
    seed: int = 42
    dtype: str = "bfloat16"


# Aliases matching the reference naming so recipes translate 1:1.
DRTrainingArguments = TrainingArguments
RRTrainingArguments = TrainingArguments


def _coerce(field_type, value):
    """Best-effort coercion of a CLI string to the dataclass field type."""
    import typing

    origin = typing.get_origin(field_type)
    if origin is typing.Union:  # Optional[X]
        args = [a for a in typing.get_args(field_type) if a is not type(None)]
        if value is None:
            return None
        return _coerce(args[0], value)
    if field_type is bool or origin is bool:
        if isinstance(value, bool):
            return value
        return str(value).lower() in ("1", "true", "yes", "y")
    if origin is list or field_type is list or origin is List:
        if isinstance(value, list):
            return value
        return [v for v in str(value).split(",") if v]
    if field_type is int:
        return int(value)
    if field_type is float:
        return float(value)
    return value


class ArgumentParser:
    """Parse one or more dataclasses from CLI flags or a single JSON file.

    Usage matches HfArgumentParser's subset used by the reference drivers:

        parser = ArgumentParser((ModelArguments, DataArguments, TrainingArguments))
        model_args, data_args, train_args = parser.parse()
    """

    def __init__(self, dataclass_types):
        if not isinstance(dataclass_types, (list, tuple)):
            dataclass_types = (dataclass_types,)
        self.dataclass_types = tuple(dataclass_types)

    def parse(self, args: Optional[List[str]] = None) -> Tuple:
        if args is None:
            args = sys.argv[1:]
        if len(args) == 1 and args[0].endswith(".json"):
            return self.parse_json(args[0])
        return self.parse_args(args)

    def parse_json(self, path: str) -> Tuple:
        with open(path) as f:
            data = json.load(f)
        return self.parse_dict(data)

    def parse_dict(self, data: dict) -> Tuple:
        import typing

        outputs = []
        consumed = set()
        for dtype in self.dataclass_types:
            hints = typing.get_type_hints(dtype)
            kwargs = {}
            for f in dataclasses.fields(dtype):
                if f.name in data:
                    kwargs[f.name] = _coerce(hints[f.name], data[f.name])
                    consumed.add(f.name)
            outputs.append(dtype(**kwargs))
        unknown = set(data) - consumed
        if unknown:
            raise ValueError(f"Unknown config keys: {sorted(unknown)}")
        return tuple(outputs)

    def format_help(self) -> str:
        lines = []
        for dtype in self.dataclass_types:
            lines.append(f"{dtype.__name__}:")
            for f in dataclasses.fields(dtype):
                default = f.default if f.default is not dataclasses.MISSING else ""
                help_txt = (f.metadata or {}).get("help", "")
                entry = f"  --{f.name}"
                if default not in ("", None):
                    entry += f" (default: {default})"
                if help_txt:
                    entry += f"  {help_txt}"
                lines.append(entry)
            lines.append("")
        lines.append("Alternatively pass a single path to a .json config file.")
        return "\n".join(lines)

    def parse_args(self, args: List[str]) -> Tuple:
        # flags --name value  or  --name (bool true)  or --name=value
        data = {}
        i = 0
        known = {
            f.name: f for dtype in self.dataclass_types for f in dataclasses.fields(dtype)
        }
        while i < len(args):
            tok = args[i]
            if tok in ("--help", "-h"):
                print(self.format_help())
                raise SystemExit(0)
            if not tok.startswith("--"):
                raise ValueError(f"Expected flag, got {tok!r}")
            if "=" in tok:
                name, value = tok[2:].split("=", 1)
                i += 1
            else:
                name = tok[2:]
                if i + 1 < len(args) and not args[i + 1].startswith("--"):
                    value = args[i + 1]
                    i += 2
                else:
                    value = True  # bare boolean flag
                    i += 1
            if name not in known:
                raise ValueError(f"Unknown flag --{name}")
            if value is True and known[name].type not in (bool, "bool"):
                # only declared-bool fields accept the bare-flag form:
                # '--model_name_or_path --do_train' would otherwise set the
                # path to True, and a bare '--max_steps' become int(True)=1
                raise ValueError(
                    f"--{name} expects a value (it is not a boolean flag)")
            data[name] = value
        return self.parse_dict(data)


def save_config(obj, path: str):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(dataclasses.asdict(obj), f, indent=2, default=str)
