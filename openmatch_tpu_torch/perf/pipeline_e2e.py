"""The driver chain end to end, each stage its own process:
build_index -> retrieve -> evaluate.

Twin of ``scripts/perf/pipeline_e2e.py``:

    python -m openmatch_tpu_torch.perf.pipeline_e2e [--n-docs 100000]
        [--n-queries 512] [--depth 100] [--tiny] [--workdir DIR]
        [--device cpu]

The data are the JAX script's, from the same seed: N docs of 24 words
``term<j>`` (j < 180) as a jsonl corpus, and queries that repeat the text
of N_QUERIES of them, each with its doc as the one relevant doc. A query
and its doc tokenize alike (the docs are indexed with ``--doc_template
<text>``), so with one encoder the doc scores its own rep's square norm
and MRR@10 of about 1 is a functional check riding the timing
(``functional_pass``: MRR@10 > 0.99).

The model is a BERT-base-shaped encoder over a 256-word vocabulary (a
1-layer, 16-wide one with ``--tiny``, whose near-equal reps tie), written
by this script in HuggingFace's layout (``config.json``,
``pytorch_model.bin``) from a seeded generator (``write_hf_bert``: HF's
initial scales, unit-variance word embeddings). Each stage
runs as ``python -m openmatch_tpu_torch.perf.pipeline_e2e --stage NAME
...``, a fresh process that calls ``drivers.<stage>.main(argv,
tokenizer=TermTokenizer())`` (``perf/serve_load.py``'s tokenizer of the
script's 205-word vocabulary, so no stage needs ``transformers``);
the retrieve stage prints the kernels its search launched, each with its
count (``_build.launches``), on a line of its own (``launches {...}``).
Wall seconds per stage, MRR@10 and those launches are printed as one JSON
line and returned.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import List, Optional

import numpy as np
import torch

from . import add_device_arg, device_of

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
VOCAB = 256  # the checkpoint's word rows; TermTokenizer uses the first 205
STAGE_PREFIX = "launches "


def gen_data(workdir: str, n_docs: int, n_queries: int, seed: int = 0):
    """The JAX script's corpus, queries and qrels, byte for byte."""
    rng = np.random.RandomState(seed)
    corpus = os.path.join(workdir, "corpus.jsonl")
    with open(corpus, "w") as f:
        for i in range(n_docs):
            words = " ".join(f"term{w}" for w in rng.randint(0, 180, size=24))
            f.write(json.dumps({"id": f"d{i}", "text": words}) + "\n")
    # queries repeat the first n_queries docs' text verbatim -> the
    # matching doc is the exact-cosine-1 nearest neighbor
    qids = rng.choice(n_docs, size=n_queries, replace=False)
    queries = os.path.join(workdir, "queries.tsv")
    qrels = os.path.join(workdir, "qrels.txt")
    with open(corpus) as f:
        docs = [json.loads(line) for line in f]
    with open(queries, "w") as fq, open(qrels, "w") as fr:
        for qi, di in enumerate(qids):
            fq.write(f"q{qi}\t{docs[di]['text']}\n")
            fr.write(f"q{qi} 0 d{di} 1\n")
    return corpus, queries, qrels


def write_hf_bert(rng: np.random.Generator, cfg, path: str):
    """A raw HuggingFace-layout BERT checkpoint of ``cfg``'s shape from
    seeded weights (config.json and pytorch_model.bin under HF's key
    names): HF's initial scales, but unit-variance word embeddings, so
    after embeddings_ln a token's identity, not its position, dominates
    its hidden state (as in a pretrained model) and the reps tell texts
    apart from the first step."""
    d, ff = cfg.hidden_size, cfg.intermediate_size

    def n(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                * 0.02)

    def ln(prefix):
        return {f"{prefix}.weight": torch.ones(d),
                f"{prefix}.bias": torch.zeros(d)}

    sd = {"embeddings.word_embeddings.weight": n(cfg.vocab_size, d) / 0.02,
          "embeddings.position_embeddings.weight":
              n(cfg.max_position_embeddings, d),
          "embeddings.token_type_embeddings.weight":
              n(cfg.type_vocab_size, d),
          **ln("embeddings.LayerNorm")}
    for i in range(cfg.num_hidden_layers):
        p = f"encoder.layer.{i}"
        for name in ("attention.self.query", "attention.self.key",
                     "attention.self.value", "attention.output.dense"):
            sd[f"{p}.{name}.weight"], sd[f"{p}.{name}.bias"] = n(d, d), n(d)
        sd.update(ln(f"{p}.attention.output.LayerNorm"))
        sd[f"{p}.intermediate.dense.weight"] = n(ff, d)
        sd[f"{p}.intermediate.dense.bias"] = n(ff)
        sd[f"{p}.output.dense.weight"] = n(d, ff)
        sd[f"{p}.output.dense.bias"] = n(d)
        sd.update(ln(f"{p}.output.LayerNorm"))
    sd["pooler.dense.weight"], sd["pooler.dense.bias"] = n(d, d), n(d)
    os.makedirs(path, exist_ok=True)
    torch.save(sd, os.path.join(path, "pytorch_model.bin"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"model_type": "bert", "vocab_size": cfg.vocab_size,
                   "hidden_size": d, "num_hidden_layers":
                   cfg.num_hidden_layers, "num_attention_heads":
                   cfg.num_attention_heads, "intermediate_size": ff,
                   "hidden_act": "gelu", "max_position_embeddings":
                   cfg.max_position_embeddings, "type_vocab_size":
                   cfg.type_vocab_size, "layer_norm_eps": 1e-12,
                   "pad_token_id": 0, "hidden_dropout_prob": 0.1,
                   "attention_probs_dropout_prob": 0.1}, f)


def make_checkpoint(workdir: str, tiny: bool) -> str:
    """The run's BERT checkpoint (``write_hf_bert``, seed 0)."""
    from ..models.bert import BertConfig

    cfg = (BertConfig(vocab_size=VOCAB, hidden_size=16, num_hidden_layers=1,
                      num_attention_heads=2, intermediate_size=32) if tiny
           else BertConfig(vocab_size=VOCAB))
    ckpt = os.path.join(workdir, "ckpt")
    write_hf_bert(np.random.default_rng(0), cfg, ckpt)
    return ckpt


def run_stage_here(stage: str, argv: List[str]):
    """One stage in this process: ``drivers.<stage>.main`` on ``argv``."""
    from ..drivers import build_index, evaluate, retrieve
    from ..ops import _build
    from .serve_load import TermTokenizer

    if stage == "build_index":
        build_index.main(argv, tokenizer=TermTokenizer())
    elif stage == "retrieve":
        retrieve.main(argv, tokenizer=TermTokenizer())
        # the stage's own process: the counter holds its launches alone
        print(STAGE_PREFIX + json.dumps(_build.launches), flush=True)
    elif stage == "evaluate":
        evaluate.main(argv)
    else:
        raise SystemExit(f"unknown stage {stage}")


def run_stage(name: str, argv: List[str], env: dict, timings: dict) -> str:
    """One stage as its own process; its stdout. Raises if it fails."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "openmatch_tpu_torch.perf.pipeline_e2e",
         "--stage", name, "--"] + argv, env=env, capture_output=True,
        text=True)
    dt = time.perf_counter() - t0
    timings[name] = dt
    tail = "\n".join((proc.stdout + proc.stderr).strip().splitlines()[-3:])
    print(f"[{name}] {dt:.1f}s rc={proc.returncode}\n{tail}", flush=True)
    if proc.returncode != 0:
        raise RuntimeError(f"pipeline_e2e: stage {name} failed (exit code "
                           f"{proc.returncode}):\n{proc.stderr[-4000:]}")
    return proc.stdout


def parse(argv: Optional[List[str]]):
    ap = argparse.ArgumentParser(
        prog="python -m openmatch_tpu_torch.perf.pipeline_e2e",
        description=__doc__.splitlines()[0])
    ap.add_argument("--n-docs", type=int, default=100_000)
    ap.add_argument("--n-queries", type=int, default=512)
    ap.add_argument("--depth", type=int, default=100)
    ap.add_argument("--tiny", action="store_true", help="tiny model (smoke)")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--stage", default=None, help=argparse.SUPPRESS)
    add_device_arg(ap)
    return ap.parse_known_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    args, rest = parse(argv)
    if args.stage:
        run_stage_here(args.stage, rest[1:] if rest[:1] == ["--"] else rest)
        return {}
    if rest:
        raise SystemExit(f"unrecognized arguments: {' '.join(rest)}")
    dev = device_of(args)  # raises without a card
    workdir = args.workdir or tempfile.mkdtemp(prefix="pipeline_e2e_")
    os.makedirs(workdir, exist_ok=True)
    print(f"workdir {workdir}", flush=True)
    corpus, queries, qrels = gen_data(workdir, args.n_docs, args.n_queries)
    ckpt = make_checkpoint(workdir, args.tiny)
    emb = os.path.join(workdir, "emb")
    run = os.path.join(workdir, "run.trec")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + (":" + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    device = ["--device", str(dev)]
    timings = {}
    run_stage("build_index", [
        "--model_name_or_path", ckpt, "--corpus_path", corpus,
        "--encoded_save_path", emb, "--p_max_len", "32",
        "--per_device_eval_batch_size", "512",
        # identity functional check: doc text must tokenize exactly like
        # the query text (the default doc template prepends "Title: ...")
        "--doc_template", "<text>"] + device, env, timings)
    out = run_stage("retrieve", [
        "--model_name_or_path", ckpt, "--query_path", queries,
        "--encoded_save_path", emb, "--trec_save_path", run,
        "--q_max_len", "32", "--retrieve_depth", str(args.depth),
        "--per_device_eval_batch_size", "128"] + device, env, timings)
    launches = [json.loads(line[len(STAGE_PREFIX):])
                for line in out.splitlines() if line.startswith(STAGE_PREFIX)]
    out = run_stage("evaluate", ["-m", "mrr_cut.10", qrels, run], env,
                    timings)
    mrr = float(out.strip().splitlines()[-1].split()[-1])
    result = {"n_docs": args.n_docs, "n_queries": args.n_queries,
              "device": dev.type, "stage_s": timings,
              "total_s": sum(timings.values()), "mrr_cut_10": mrr,
              "functional_pass": mrr > 0.99,
              "retrieve_launches": launches[-1] if launches else None}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
