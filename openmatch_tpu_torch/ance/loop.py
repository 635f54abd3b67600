"""ANCE: asynchronous hard-negative refresh for dense retrieval.

The port's own copy of ``openmatch_tpu/ance/loop.py``, line for line, so
both packages publish the same bytes from the same run (held to it by
``tests/test_torch_ance.py``). Two cooperating programs in the reference's
design: a trainer that polls ``ann_dir`` for new ``ann_training_data_N``
files and swaps its dataset, and a generator that polls for new
checkpoints, re-encodes the corpus, searches top-k with the CURRENT model,
and samples fresh negatives. Communication is filesystem-only, which makes
the pair crash-tolerant by construction.

Two modes:

- ``run_ance_alternating``: ONE program alternating train-steps and
  negative refresh on the same device: no polling, no duplicate model
  copy. ``refresh_fn`` builds its ``Retriever`` on the trainer's live
  module (``trainer.model``) and drops it before the next generation
  trains, so one index is resident at a time.
- ``run_ance_generator`` (+ the trainer-side ``latest_ann_data`` helper):
  the two-program filesystem contract, for a trainer and a generator that
  run as separate programs. Its lazy imports are the port's
  ``train.state.latest_checkpoint`` and ``utils.metrics.evaluate_run``.

The ann data format is our standard tokenized train jsonl, so the regular
DRTrainDataset consumes refreshed files unchanged.

Over several ranks (``torchrun`` or ``parallel.mesh.spawn_ranks``) the
alternating mode runs on every rank alike: each rank trains its rows of
the global batch through ``DRTrainer(mesh=)``, refreshes through
``Retriever(mesh=)`` and mines the same negatives, and
``write_ann_data(..., mesh=)`` publishes each generation once, from rank
0, behind a barrier (``perf/ance_cycle.py``). The generator stays one
process, as the JAX package's builds its ``Retriever`` without a mesh.
"""

from __future__ import annotations

import json
import logging
import os
import random
import re
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Tuple

logger = logging.getLogger(__name__)


@dataclass
class AnceConfig:
    ann_dir: str = "ann_data"
    topk_training: int = 200
    negative_sample: int = 20
    eval_topk: int = 100
    measure: str = "ndcg_cut_10"
    poll_interval_s: float = 30.0
    seed: int = 0


# ---------------------------------------------------------------------------
# filesystem contract (reference run_ann.py:180-216 / run_ann_data_gen.py)
# ---------------------------------------------------------------------------

_ANN_RE = re.compile(r"ann_training_data_(\d+)$")


def latest_ann_data(ann_dir: str) -> Tuple[Optional[str], int, Optional[dict]]:
    """Return (path, generation, metrics) of the newest ann data, or
    (None, -1, None)."""
    best, best_gen = None, -1
    if os.path.isdir(ann_dir):
        for name in os.listdir(ann_dir):
            m = _ANN_RE.match(name)
            if m and int(m.group(1)) > best_gen:
                best, best_gen = os.path.join(ann_dir, name), int(m.group(1))
    metrics = None
    if best is not None:
        ndcg_path = os.path.join(ann_dir, f"ann_ndcg_{best_gen}")
        if os.path.exists(ndcg_path):
            with open(ndcg_path) as f:
                metrics = json.load(f)
    return best, best_gen, metrics


def write_ann_data(ann_dir: str, generation: int, lines: Iterable[str],
                   metrics: Optional[dict] = None, mesh=None) -> str:
    """Atomically publish a new generation of training data + metrics.

    ``mesh``: this rank's ``parallel.mesh.Mesh``, as ``DRTrainer(mesh=)``
    and ``Retriever(mesh=)`` take it. Over more than one rank, rank 0 alone
    writes (the other ranks' ``lines`` are never read), and every rank then
    meets at a barrier on the world group before the path is returned, so
    no rank reads a generation before it is whole. Without a mesh, or with
    one rank, it writes as the JAX package does."""
    os.makedirs(ann_dir, exist_ok=True)
    path = os.path.join(ann_dir, f"ann_training_data_{generation}")
    world = mesh.group("world") if mesh is not None else None
    if world is None or mesh.rank == 0:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            for line in lines:
                f.write(line + "\n")
        if metrics is not None:
            with open(os.path.join(ann_dir, f"ann_ndcg_{generation}"),
                      "w") as f:
                json.dump(metrics, f)
        os.replace(tmp, path)  # data file last: its presence signals readiness
    if world is not None:
        import torch.distributed as dist

        dist.barrier(group=world)
    return path


# ---------------------------------------------------------------------------
# negative generation (reference run_ann_data_gen.py:238-345)
# ---------------------------------------------------------------------------


def generate_hard_negatives(
    retrieved: Dict[str, Dict[str, float]],
    qrels: Dict[str, List[str]],
    config: AnceConfig,
    generation: int = 0,
) -> Dict[str, List[str]]:
    """Sample ``negative_sample`` non-positive doc ids from each query's
    top ``topk_training`` retrieved docs."""
    rng = random.Random(config.seed + generation)
    out: Dict[str, List[str]] = {}
    for qid, docs in retrieved.items():
        positives = set(qrels.get(qid, ()))
        ranked = sorted(docs.items(), key=lambda kv: kv[1], reverse=True)
        cands = [d for d, _ in ranked[: config.topk_training] if d not in positives]
        rng.shuffle(cands)
        out[qid] = cands[: config.negative_sample]
    return out


def build_ann_lines(
    negatives: Dict[str, List[str]],
    qrels: Dict[str, List[str]],
    tokenized_queries: Dict[str, List[int]],
    tokenized_corpus: Dict[str, List[int]],
) -> Iterable[str]:
    for qid, negs in negatives.items():
        positives = [p for p in qrels.get(qid, []) if p in tokenized_corpus]
        # filter BEFORE the emptiness guard: a published line with
        # "negatives": [] would crash the trainer's negative sampling a
        # whole generation after the expensive encode+search. Guard the
        # query too: one qid missing from tokenized_queries must not
        # abort the generation either.
        kept_negs = [n for n in negs if n in tokenized_corpus]
        if not positives or not kept_negs or qid not in tokenized_queries:
            continue
        yield json.dumps({
            "query": tokenized_queries[qid],
            "positives": [tokenized_corpus[p] for p in positives],
            "negatives": [tokenized_corpus[n] for n in kept_negs],
        })


# ---------------------------------------------------------------------------
# generator program
# ---------------------------------------------------------------------------


def run_ance_generator(
    build_retriever: Callable[[str], "object"],
    corpus_dataset_fn: Callable[[], Iterable[dict]],
    query_dataset_fn: Callable[[], Iterable[dict]],
    tokenized_queries: Dict[str, List[int]],
    tokenized_corpus: Dict[str, List[int]],
    qrels: Dict[str, List[str]],
    dev_qrels: Dict[str, Dict[str, int]],
    checkpoint_dir: str,
    config: AnceConfig,
    max_generations: int = -1,
):
    """Poll ``checkpoint_dir`` for checkpoints; per new checkpoint, encode,
    search, evaluate, and publish a fresh ann generation.

    build_retriever(ckpt_path) must return an object with
    ``encode_corpus``, ``encode_queries`` and ``search`` (our Retriever).
    """
    from ..train.state import latest_checkpoint
    from ..utils.metrics import evaluate_run

    seen = None
    # resume numbering after a crash/restart: publishing generation 0 again
    # would be ignored by trainers polling for the HIGHEST generation
    generation = latest_ann_data(config.ann_dir)[1] + 1
    published = 0
    while max_generations < 0 or published < max_generations:
        ckpt = latest_checkpoint(checkpoint_dir)
        if ckpt is None or ckpt == seen:
            time.sleep(config.poll_interval_s)
            continue
        seen = ckpt
        logger.info(f"ANCE generator: refreshing from {ckpt}")
        retriever = build_retriever(ckpt)
        retriever.encode_corpus(corpus_dataset_fn())
        q_emb, qids = retriever.encode_queries(query_dataset_fn())
        retrieved = retriever.search(q_emb, qids, topk=max(config.topk_training, config.eval_topk))
        metrics = evaluate_run(dev_qrels, retrieved, [config.measure]) if dev_qrels else {}
        negatives = generate_hard_negatives(retrieved, qrels, config, generation)
        lines = build_ann_lines(negatives, qrels, tokenized_queries, tokenized_corpus)
        path = write_ann_data(config.ann_dir, generation, lines,
                              {**metrics, "checkpoint": ckpt})
        logger.info(f"ANCE generator: wrote {path} ({metrics})")
        generation += 1
        published += 1


# ---------------------------------------------------------------------------
# single-program alternating mode
# ---------------------------------------------------------------------------


def run_ance_alternating(
    trainer,
    make_data_iter: Callable[[str], Iterable],
    refresh_fn: Callable[[object, int], str],
    initial_data_path: str,
    steps_per_generation: int,
    num_generations: int,
) -> List[str]:
    """Train ``steps_per_generation`` steps, then call
    ``refresh_fn(trainer, generation) -> new_data_path`` (which encodes +
    searches with the CURRENT in-memory params and writes a fresh data
    file), swap the iterator, repeat. Returns the data files used."""
    used = [initial_data_path]
    data_path = initial_data_path
    for generation in range(num_generations):
        it = iter(make_data_iter(data_path))
        # host-side step counter: each train_step is exactly one optimizer
        # update, and reading the step off the device would force a
        # device->host sync per iteration
        done = 0
        while done < steps_per_generation:
            try:
                batch = next(it)
            except StopIteration:
                it = iter(make_data_iter(data_path))
                try:
                    batch = next(it)
                except StopIteration:
                    # a bare StopIteration here would escape uncaught;
                    # name the actual problem instead
                    raise ValueError(
                        f"ANCE data file {data_path} yielded no batches "
                        "— did the generation publish an empty file?"
                    ) from None
            trainer.train_step(batch)
            done += 1
        if generation == num_generations - 1:
            # the last generation's refresh (a full corpus re-encode +
            # search, the most expensive op in the loop) would produce a
            # data file nothing ever trains on — skip it
            break
        data_path = refresh_fn(trainer, generation)
        used.append(data_path)
        logger.info(f"ANCE alternating: generation {generation} -> {data_path}")
    return used
