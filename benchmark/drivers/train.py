"""``train``: dense-retrieval training through the program's
``DRTrainer.train_step`` on one card.

Set-up draws the encoder's weights from the seed on the card, builds
``DRModel`` and ``DRTrainer``, and feeds ``train_step`` the collated
global batches (``QPCollator`` in the program's prefetch thread, as its
training driver does). It drives that same trainer through its first
``check_steps`` steps with the model's dropout rates at 0, since the plain
reference cannot draw the program's masks, recording each step's loss,
the first gradient as the optimizer took it (from Adam's first moment) and
each parameter's change; then it puts the configuration's rates back,
warms up and measures. Afterwards the plain float32 reference follows the
first steps on the same weights and batches."""

from __future__ import annotations

import contextlib
import dataclasses
import math
import sys
import time
from typing import List

import numpy as np
import torch

from .. import tracing, traffic
from ..common import (TAG_TEXT, TAG_WEIGHTS, Cell, Outcome, derived_seed,
                      judge, rng)
from ..weights import hf_state

MIN_LEAF = 1e-3  # leaves whose reference gradient is below this share of
#                  the median leaf's move by rounding alone: not compared


def global_batches(tr: dict, cfg: dict, seed: int, n: int) -> List[list]:
    """``n`` global batches of features (``{"query": ids, "passages":
    [ids, ...]}``, the positive first): BERT word ids framed by [CLS] and
    [SEP], lengths from the mix's fixed sets in the seed's order."""
    q_per = tr["queries"]
    p_per = tr["passages_per_query"]
    nq, npsg = n * q_per, n * q_per * p_per
    r = rng(seed, TAG_TEXT)
    cls, sep = tr["cls_sep"]
    qf, qs = traffic.ragged(r, traffic.lengths(tr["query_tokens"], nq, seed,
                                               1), tr["word_ids"],
                            (cls,), (sep,))
    pf, ps = traffic.ragged(r, traffic.lengths(tr["passage_tokens"], npsg,
                                               seed, 2), tr["word_ids"],
                            (cls,), (sep,))
    out = []
    for b in range(n):
        feats = []
        for j in range(q_per):
            i = b * q_per + j
            feats.append({"query": qf[qs[i]:qs[i + 1]],
                          "passages": [pf[ps[k]:ps[k + 1]] for k in
                                       range(i * p_per, (i + 1) * p_per)]})
        out.append(feats)
    return out


def train_args(tr: dict, seed: int):
    from openmatch_tpu_torch.config import TrainingArguments

    return TrainingArguments(
        seed=int(seed) % 2**31, per_device_train_batch_size=tr["queries"],
        learning_rate=tr["learning_rate"], warmup_ratio=tr["warmup_ratio"],
        max_grad_norm=tr["max_grad_norm"], weight_decay=tr["weight_decay"])


def build(device, cell: Cell, seed: int):
    """(trainer, batches): ``DRTrainer`` over the seed's weights, and the
    collated global batches from the program's prefetch thread."""
    from openmatch_tpu_torch.data.collators import QPCollator
    from openmatch_tpu_torch.data.loader import prefetch
    from openmatch_tpu_torch.train.dr_trainer import DRTrainer

    from ..program import dr_model

    tr, cfg = cell.traffic, cell.config
    weights = hf_state(cfg, derived_seed(seed, TAG_WEIGHTS), device)
    model = dr_model(cfg, weights, device)
    del weights
    trainer = DRTrainer(model, train_args(tr, seed),
                        total_steps=tr["total_steps"], device=device)
    collate = QPCollator(pad_token_id=cfg.get("pad_token_id", 0),
                         q_max_len=cfg["dr"]["q_max_len"],
                         p_max_len=cfg["dr"]["p_max_len"])
    pool = global_batches(tr, cfg, seed, tr["pool_steps"])

    def feed():
        s = 0
        while True:
            yield collate(pool[s % len(pool)])
            s += 1

    return trainer, prefetch(feed(), depth=tr.get("prefetch", 2))


# the program's dropout rates: the encoder configuration's, and the copies
# its layers keep
RATE_KEYS = ("hidden_dropout_prob", "attention_probs_dropout_prob",
             "dropout_rate")
RATE_ATTRS = ("hidden_rate", "probs_rate")


@contextlib.contextmanager
def dropout_off(model):
    """``model``'s dropout rates at 0 inside, the configuration's after:
    the encoder configuration (frozen, so swapped for a copy wherever the
    model holds it) and the rates its layers keep. Raises when the
    configuration states a rate and no layer keeps one this knows: the
    check steps would then draw masks the reference cannot follow."""
    cfg = model.encoder_config
    stated = [k for k in RATE_KEYS if getattr(cfg, k, 0.0)]
    layers = [(m, a, getattr(m, a)) for m in model.modules()
              for a in RATE_ATTRS if getattr(m, a, 0.0)]
    if stated and not layers:
        raise RuntimeError("benchmark: the configuration states dropout, "
                           "but no layer of the model keeps a rate in "
                           f"{RATE_ATTRS}; the check steps cannot turn it "
                           "off")
    holders = []
    if stated:
        holders = [(model, "encoder_config")] + [
            (m, "config") for m in model.modules()
            if getattr(m, "config", None) is cfg]
        off = dataclasses.replace(cfg, **{k: 0.0 for k in stated})
        for obj, attr in holders:
            setattr(obj, attr, off)
    for obj, attr, _ in layers:
        setattr(obj, attr, 0.0)
    try:
        yield
    finally:
        for obj, attr in holders:
            setattr(obj, attr, cfg)
        for obj, attr, value in layers:
            setattr(obj, attr, value)


def first_steps(trainer, batches, n: int, cfg: dict) -> dict:
    """Drive ``trainer`` through its first ``n`` steps: each step's loss,
    the first gradient as the optimizer took it (Adam's first moment over
    1 - b1) and each leaf's change over the ``n``, both as norms per
    published (HuggingFace) leaf."""
    from ..program import published_leaf_ids, published_norms

    names, leaf_ids = published_leaf_ids(cfg, trainer.device)
    named = {k.split("encoder_q.", 1)[-1]: p
             for k, p in trainer.model.named_parameters()}
    p0 = {k: p.detach().clone() for k, p in named.items()}
    losses, grads = [], None
    b1 = trainer.optimizer.param_groups[0]["b1"]
    for s in range(n):
        losses.append(trainer.train_step(next(batches)))
        if s == 0:  # a leaf the optimizer never touched reads 0
            first = {k: trainer.optimizer.state.get(p, {}).get(
                "mu", torch.zeros_like(p)) / (1 - b1)
                for k, p in named.items()}
            grads = published_norms(first, leaf_ids, len(names))
            del first
    change = published_norms({k: p.detach() - p0[k]
                              for k, p in named.items()}, leaf_ids,
                             len(names))
    return {"losses": [float(x) for x in losses],
            "grad_norms": dict(zip(names, grads.tolist())),
            "change_norms": dict(zip(names, change.tolist()))}


def window(trainer, batches, seconds: float, trace: bool) -> dict:
    """Steps until ``seconds`` have passed (the profiler over the first
    ``tracing.TRACE_S`` of them with ``trace``)."""
    device = trainer.device
    prof = tracing.Profiled(device) if trace else None
    if prof is not None:  # started before the window: starting takes time
        prof.start()
    t_wall = time.time()
    t0 = time.perf_counter()
    steps, traced_steps, prof_done, t_traced = 0, 0, None, 0.0
    while True:
        now = time.perf_counter() - t0
        if prof is not None and now >= min(tracing.TRACE_S, seconds):
            prof.stop()
            traced_steps, prof_done, prof = steps, prof, None
            t_traced = time.perf_counter() - t0
        if now >= seconds:
            break
        trainer.train_step(next(batches))
        steps += 1
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = time.perf_counter() - t0
    return dict(steps=steps, elapsed=elapsed, t_wall=t_wall,
                trace=prof_done.summary() if prof_done is not None else None,
                traced_steps=traced_steps, traced_s=t_traced)


def reference_readings(cell: Cell, seed: int, device,
                       variant: str = "reference") -> dict:
    """The plain reference's first steps on the run's weights and batches,
    mapped onto the program's leaves: losses, first-gradient norms and
    change norms. ``variant``: "reference" (float32), "fp8" (the
    control) or "half" (half of the batch left out, the mean over the
    rest)."""
    from ..reference import bert as ref_bert
    from ..reference.quant import exact_fp32
    from ..reference.train import Recipe, contrastive_loss, train

    tr, cfg = cell.traffic, cell.config
    w0 = hf_state(cfg, derived_seed(seed, TAG_WEIGHTS), device)
    pad = cfg.get("pad_token_id", 0)
    q_len, p_len = cfg["dr"]["q_max_len"], cfg["dr"]["p_max_len"]

    def collate(f):
        return {"query": traffic.pad_rows([x["query"] for x in f], q_len,
                                          pad),
                "passage": traffic.pad_rows(
                    [p for x in f for p in x["passages"]], p_len, pad)}

    feats = global_batches(tr, cfg, seed, tr["pool_steps"])[
        :tr["check_steps"]]
    if variant == "half":
        feats = [f[:len(f) // 2] for f in feats]
    batches = [{part: {k: torch.from_numpy(v.astype(np.int64)).to(device)
                       for k, v in arrays.items()}
                for part, arrays in collate(f).items()} for f in feats]
    steps = tr["check_steps"]
    recipe = Recipe(learning_rate=tr["learning_rate"],
                    total_steps=tr["total_steps"],
                    warmup_steps=int(tr["warmup_ratio"] * tr["total_steps"]),
                    weight_decay=tr["weight_decay"],
                    max_grad_norm=tr["max_grad_norm"])
    with exact_fp32():
        records, w_end = train(
            w0, lambda w, ids, mask, prec: ref_bert.reps(w, cfg, ids, mask,
                                                         prec),
            batches[:steps], recipe, contrastive_loss,
            "fp8" if variant == "fp8" else None)
    return {"losses": [r.loss for r in records],
            "grad_norms": {n: float(torch.linalg.vector_norm(g))
                           for n, g in records[0].grads.items()},
            "change_norms": {n: float(torch.linalg.vector_norm(w_end[n]
                                                               - w0[n]))
                             for n in w0}}


def compare(prog: dict, ref: dict) -> dict:
    """The three numbers: ``loss_gap`` (worst step, relative),
    ``grad_gap`` and ``change_gap`` (worst published leaf: the gap between
    the two norms over the larger of the reference's norm and the median
    leaf's).
    Leaves whose reference gradient is under ``MIN_LEAF`` of the median
    leaf's are left out of both (they move by rounding alone)."""
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(prog["losses"], ref["losses"]))
    pg, pc = prog["grad_norms"], prog["change_norms"]
    rg, rc = ref["grad_norms"], ref["change_norms"]
    if set(pg) != set(rg):
        return {"loss_gap": loss_gap, "grad_gap": 1.0, "change_gap": 1.0}
    med_g = float(np.median(list(rg.values())))
    kept = [n for n in rg if rg[n] >= MIN_LEAF * med_g]
    med_c = float(np.median([rc[n] for n in kept]))
    grad_gap = max(abs(pg[n] - rg[n]) / max(rg[n], med_g) for n in kept)
    change_gap = max(abs(pc[n] - rc[n]) / max(rc[n], med_c) for n in kept)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap}


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        t_start: float, device="cuda") -> Outcome:
    device = torch.device(device)
    tr, cfg = cell.traffic, cell.config
    trainer, batches = build(device, cell, seed)
    with dropout_off(trainer.model):
        prog = first_steps(trainer, batches, tr["check_steps"], cfg)
    for _ in range(tr["warm_steps"]):
        trainer.train_step(next(batches))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    w = window(trainer, batches, seconds, trace)
    batches.close()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    del trainer
    if device.type == "cuda":
        torch.cuda.empty_cache()
    q = tr["queries"]
    tokens_per_step = (q * cfg["dr"]["q_max_len"]
                       + q * tr["passages_per_query"] * cfg["dr"]["p_max_len"])
    rate = w["steps"] * tokens_per_step / w["elapsed"]
    print(f"train: {w['steps']} steps of {tokens_per_step} tokens in "
          f"{w['elapsed']:.3f} s "
          f"({1e3 * w['elapsed'] / max(w['steps'], 1):.3f} ms a step); "
          f"first losses {prog['losses']}", file=sys.stderr)
    numbers = compare(prog, reference_readings(cell, seed, device))
    checks = {name: (value, cell.limits.get(name))
              for name, value in numbers.items()}
    summary = w["trace"]
    finite = all(math.isfinite(x) for x in prog["losses"])
    return Outcome(
        correct=judge(checks) and finite, attempted=w["steps"], failed=0,
        metrics={"train_tokens_per_s": rate,
                 "setup_s": w["t_wall"] - t_start},
        memory_peak_bytes=peak, chips=1, checks=checks,
        # the steps after the traced part, for the per-layer rates: the
        # profiler slows the host
        layer={"trace": summary, "traced_steps": w["traced_steps"],
               "steps": w["steps"] - w["traced_steps"],
               "elapsed": w["elapsed"] - w["traced_s"],
               "config": cfg, "queries": q,
               "passages_per_query": tr["passages_per_query"]},
        busy_s=summary.busy_s if summary else None,
        window_s=summary.window_s if summary else None,
        breakdown=summary.breakdown() if summary else None)
