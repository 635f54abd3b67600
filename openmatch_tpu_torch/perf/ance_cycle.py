"""One full ANCE refresh cycle on the card, every phase timed (twin of
``scripts/perf/ance_cycle.py``).

    python -m openmatch_tpu_torch.perf.ance_cycle [N_DOCS] [N_QUERIES] [STEPS] \
        [--tiny] [--device cuda|cpu] [--model_name_or_path DIR] \
        [--pooling first|mean] [--dtype bfloat16|float32] [--workdir DIR]
    torchrun --nproc_per_node=N -m openmatch_tpu_torch.perf.ance_cycle ...

Defaults: 100k docs (seq 128), 1k queries (seq 32), 50 train steps per
generation, BERT-base bf16, batch 8x8, encode batch 512,
topk_training=200 / negative_sample=20 (the reference's ANCE defaults).
Two generations through ``ance.run_ance_alternating`` and the port's
``DRTrainer``: gen0 trains on random negatives, the refresh encodes the
corpus and the queries with the trainer's live module through
``Retriever``, searches, mines hard negatives and publishes them, and gen1
trains on the published ann file. The per-step loss jump on the swapped
data is the "loss landscape changed" check.

Over several ranks (``torch.distributed`` initialised by ``spawn_ranks``,
or by this script under ``torchrun``) the cycle runs on every rank, as the
JAX script runs over every device: ``DRTrainer(mesh=make_mesh())``, each
rank training its rows of every global batch (``shard_batch``; the seeded
order is the same on every rank, so the global batch is one process's).
Every rank refreshes alike: it encodes the corpus and the queries with its
bit-identical replica, the docs-partitioned ``Retriever(mesh=)`` splits the
search, every rank mines the same negatives from the merged run, and
``write_ann_data(mesh=)`` publishes the file once, from rank 0. Rank 0
alone prints; ``main`` returns the same numbers on every rank, and the
ranks share rank 0's ``--workdir``. Tensor parallelism is not ported here
(``--tp_size`` > 1 raises).

The model is ``--model_name_or_path`` (an OpenMatch or HuggingFace
checkpoint directory, built with ``--pooling`` in ``--dtype``, bf16 by
default), else BERT-base (or the ``--tiny`` config) drawn from a generator
seeded with 0. Token ids are
rows of two tables drawn in bulk from seeded generators, so the train
file, the tokenized dicts and the encode streams agree; the JAX script
seeds one generator per doc instead, a host cost that its encode clock
times along with the encoder. The card is synchronised where a phase's clock starts
and where the cycle ends, so each phase is charged its own device work.
``main`` prints the per-phase table (training timed per generation as
well as their mean, the JAX script's ``train_gen_s``) and returns the
phases, the losses, the trainer and the refresh's embeddings, negatives
and ann file.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from ..device import resolve_dtype
from . import add_device_arg, sync

D_QL, D_PL = 32, 128
B, NP = 8, 8
ENCODE_BS = 512
TOPK_TRAINING, NEGATIVE_SAMPLE = 200, 20


def build_model(args, device):
    """The cycle's DRModel in ``--dtype`` on ``device``."""
    from ..config import ModelArguments
    from ..models.bert import BertConfig
    from ..models.dr_model import DRModel

    if args.model_name_or_path:
        return DRModel.build(ModelArguments(
            model_name_or_path=args.model_name_or_path,
            pooling=args.pooling, dtype=args.dtype), device=device)
    if args.tiny:
        cfg = BertConfig(vocab_size=64, hidden_size=16, num_hidden_layers=1,
                         num_attention_heads=2, intermediate_size=32,
                         add_pooler=False)
    else:
        cfg = BertConfig(add_pooler=False)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = DRModel(encoder_config=cfg, pooling=args.pooling,
                        dtype=resolve_dtype(args.dtype))
    return model.to(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m openmatch_tpu_torch.perf.ance_cycle",
        description="one ANCE cycle, every phase timed")
    ap.add_argument("n_docs", nargs="?", type=int, default=100_000)
    ap.add_argument("n_queries", nargs="?", type=int, default=1_000)
    ap.add_argument("steps", nargs="?", type=int, default=50)
    ap.add_argument("--tiny", action="store_true",
                    help="a 1-layer, 16-wide BERT over a 64-token vocab")
    add_device_arg(ap)
    ap.add_argument("--model_name_or_path", default=None)
    ap.add_argument("--pooling", default="first", help="first | mean")
    ap.add_argument("--dtype", default="bfloat16",
                    help="compute dtype: bfloat16 | float32")
    ap.add_argument("--tp_size", type=int, default=1,
                    help="tensor-parallel ranks: only 1 (not ported)")
    ap.add_argument("--workdir", default=None,
                    help="where the train and ann files go (default: a new "
                         "temporary directory; over ranks rank 0's)")
    args = ap.parse_args(argv)
    if args.tp_size != 1:
        raise NotImplementedError(
            f"ance_cycle with tp_size={args.tp_size}: ANCE's alternating "
            "loop over tensor-parallel ranks is not ported; run it with "
            "tp_size=1 (data-parallel over every rank)")
    from ..drivers.common import maybe_init_distributed
    from ..parallel.mesh import (make_mesh, rank_device, shard_batch,
                                 world_size)

    device = rank_device(args.device)  # raises without a card
    maybe_init_distributed(device)
    mesh = make_mesh(device=device) if world_size() > 1 else None
    lead = mesh is None or mesh.rank == 0
    n_docs, n_queries, steps = args.n_docs, args.n_queries, args.steps

    from ..ance.loop import (AnceConfig, build_ann_lines,
                             generate_hard_negatives, run_ance_alternating,
                             write_ann_data)
    from ..config import DataArguments, InferenceArguments, TrainingArguments
    from ..data.collators import pad_ids
    from ..retriever.retriever import Retriever
    from ..train.dr_trainer import DRTrainer

    model = build_model(args, device)
    vocab = min(30000, model.encoder_config.vocab_size)
    train_args = TrainingArguments(per_device_train_batch_size=B,
                                   max_steps=10_000, logging_steps=10_000)
    trainer = DRTrainer(model, train_args, total_steps=10_000, device=device,
                        mesh=mesh)

    # deterministic synthetic token ids, made in bulk: doc i / query i are
    # row i of a seeded table
    doc_table = np.random.RandomState(0).randint(
        1, vocab, size=(n_docs, D_PL), dtype=np.int32)
    query_table = np.random.RandomState(1).randint(
        1, vocab, size=(n_queries, D_QL), dtype=np.int32)

    def doc_ids_(i):
        return doc_table[i].tolist()

    def query_ids_(i):
        return query_table[i].tolist()

    qrels = {f"q{i}": [f"d{i}"] for i in range(n_queries)}

    workdir = args.workdir
    if lead and workdir is None:
        workdir = tempfile.mkdtemp(prefix="ance_cycle_")
    if mesh is not None:  # the ranks share rank 0's files
        import torch.distributed as dist

        box = [workdir]
        dist.broadcast_object_list(box, src=0, group=mesh.group("world"))
        workdir = box[0]
    init_path = os.path.join(workdir, "gen_init.jsonl")
    if lead:
        os.makedirs(workdir, exist_ok=True)
        # gen0 train file: each query's positive + random negatives
        rng = np.random.RandomState(123)
        with open(init_path, "w") as f:
            for i in range(n_queries):
                negs = rng.randint(0, n_docs, size=NP - 1)
                f.write(json.dumps({
                    "query": query_ids_(i),
                    "positives": [doc_ids_(i)],
                    "negatives": [doc_ids_(int(j)) for j in negs],
                }) + "\n")
    if mesh is not None:
        dist.barrier(group=mesh.group("world"))

    losses = []  # device scalars; generation boundaries ride on the length

    def make_data_iter(path):
        with open(path) as f:
            rows = [json.loads(line) for line in f]
        order = np.random.RandomState(len(losses)).permutation(len(rows))

        def gen():
            for lo in range(0, len(order) - B + 1, B):
                chunk = [rows[j] for j in order[lo:lo + B]]
                q = pad_ids([r["query"] for r in chunk], D_QL, 0)
                psgs = []
                for r in chunk:
                    psgs.append(r["positives"][0])
                    negs = (r["negatives"] * NP)[:NP - 1]
                    psgs.extend(negs)
                yield {"query": q, "passage": pad_ids(psgs, D_PL, 0)}

        return gen()

    phases, refresh, marks = {}, {}, {}

    class TimedTrainer:
        """Keeps each step's loss on the device; run_ance_alternating
        drives the real trainer through it."""

        def __init__(self, tr):
            self._tr = tr

        @property
        def model(self):
            return self._tr.model

        @property
        def mesh(self):
            return mesh

        def train_step(self, batch):
            if mesh is not None:  # this rank's rows of the global batch
                batch = shard_batch(batch, mesh)
            loss = self._tr.train_step(batch)
            losses.append(loss)
            return loss

    data_args = DataArguments(q_max_len=D_QL, p_max_len=D_PL)
    inf_args = InferenceArguments(per_device_eval_batch_size=ENCODE_BS)
    acfg = AnceConfig(ann_dir=os.path.join(workdir, "ann"),
                      topk_training=TOPK_TRAINING,
                      negative_sample=NEGATIVE_SAMPLE)

    def refresh_fn(tr, generation):
        # wait for the generation's last steps BEFORE starting the encode
        # clock, so they are charged to the generation's training
        sync(device)
        marks["refresh"] = time.perf_counter()
        start_bytes = torch.cuda.memory_allocated(device) \
            if device.type == "cuda" else 0
        # the trainer's live module, not a copy: one model on the device;
        # over ranks each encodes alike and the docs partition splits the
        # search
        retriever = Retriever(tr.model, data_args, inf_args, pad_token_id=0,
                              device=device, mesh=tr.mesh)
        t0 = time.perf_counter()
        doc_emb, doc_ids = retriever.encode_corpus(
            {"id": f"d{i}", "input_ids": doc_ids_(i)} for i in range(n_docs))
        phases["encode_corpus_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        q_emb, qids = retriever.encode_queries(
            {"id": f"q{i}", "input_ids": query_ids_(i)}
            for i in range(n_queries))
        phases["encode_queries_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        retrieved = retriever.search(q_emb, qids, topk=acfg.topk_training)
        phases["search_s"] = time.perf_counter() - t0
        del retriever  # the index goes before the next generation trains
        t0 = time.perf_counter()
        negatives = generate_hard_negatives(retrieved, qrels, acfg, generation)
        tokenized_q = {f"q{i}": query_ids_(i) for i in range(n_queries)}
        needed = {d for negs in negatives.values() for d in negs}
        needed.update(p for ps in qrels.values() for p in ps)
        tokenized_c = {d: doc_ids_(int(d[1:])) for d in needed}
        path = write_ann_data(
            acfg.ann_dir, generation,
            build_ann_lines(negatives, qrels, tokenized_q, tokenized_c),
            mesh=tr.mesh)
        marks["trained"] = time.perf_counter()
        phases["mine_and_publish_s"] = marks["trained"] - t0
        refresh.update(doc_emb=doc_emb, doc_ids=doc_ids, q_emb=q_emb,
                       qids=qids, negatives=negatives, path=path,
                       left_bytes=(torch.cuda.memory_allocated(device)
                                   - start_bytes)
                       if device.type == "cuda" else 0)
        return path

    t0 = time.perf_counter()
    run_ance_alternating(TimedTrainer(trainer), make_data_iter, refresh_fn,
                         init_path, steps_per_generation=steps,
                         num_generations=2)
    sync(device)  # gen1 has no refresh after it to wait for its steps
    end = time.perf_counter()
    total = end - t0
    # gen0 from the start to the refresh, gen1 from the refresh's end
    phases["train_gen0_s"] = marks["refresh"] - t0
    phases["train_gen1_s"] = end - marks["trained"]
    phases["train_gen_s"] = (phases["train_gen0_s"]
                             + phases["train_gen1_s"]) / 2

    losses = [float(x) for x in losses]
    g0, g1 = losses[:steps], losses[steps:]
    ranks = world_size()
    if lead:
        print(f"ance_cycle: n_docs={n_docs} n_queries={n_queries} "
              f"steps/gen={steps} B={B}x{NP} seq q{D_QL}/p{D_PL} "
              f"device={device} ranks={ranks}", flush=True)
        for k in ("train_gen_s", "train_gen0_s", "train_gen1_s",
                  "encode_corpus_s", "encode_queries_s", "search_s",
                  "mine_and_publish_s"):
            print(f"  {k:>20}: {phases[k]:7.2f} s", flush=True)
        print(f"  {'cycle_total':>20}: {total:7.2f} s "
              f"({n_docs / phases['encode_corpus_s']:,.0f} docs/s encode)",
              flush=True)
        print(f"  loss gen0 first/last 10: {np.mean(g0[:10]):.4f} -> "
              f"{np.mean(g0[-10:]):.4f}; gen1 (mined negatives) first 10: "
              f"{np.mean(g1[:10]):.4f}", flush=True)
    return {"phases": phases, "total_s": total, "losses": losses,
            "trainer": trainer, "refresh": refresh, "qrels": qrels,
            "ann_dir": acfg.ann_dir, "workdir": workdir, "ranks": ranks}


if __name__ == "__main__":
    main()
