"""``encode_kimi``: corpus encoding with a Kimi-Linear last-token retriever
(the ``kimi_linear`` backbone, one card's share of its routed experts)
through the program's ``retriever.encoder.encode_dataset``, the path of
``build_index``, the ANCE refresh and BEIR, as ``encode_lm`` drives
DeepSeek-V3.

The program's ``kimi_linear`` module is imported first, so a program
without the backbone fails at once. Set-up builds the program's
``DRModel`` on the card with its weights in bf16, loads the seed's draws
(``kimi_weights``, the held experts only) tensor by tensor through the
program's converter (``models.kimi_linear.load_hf_tensor``), builds the
pool of documents (lengths from the mix's fixed set in the seed's order,
ids from the seed, each ending in the end id) and warms the one shape
(its CUDA graph's capture included). The window and its traced part are
``encode``'s; the program's counters are zeroed before the window, the
held slots read after the traced part and after the window.

The check is ``encode_lm``'s: the sample of the window's documents (the
longest and a seeded draw) encoded once more by the program, eagerly, in
batches padded as the window's, with its expert choices recorded (the
graphs are dropped first: their pool and an eager batch do not fit the
card together); then, the program freed, the plain float32 reference
(``reference/kimi_linear``: KDA token by token, the same expert share)
computes the sample's reps along those choices, its weights drawn again
from the seed layer by layer. ``rep_err``, ``route_err`` and ``order``
as ``encode_lm`` defines them."""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import tracing
from ..common import Cell, Outcome, judge
from ..kimi_weights import KimiDrawn
from ..program import DTYPES
from ..reference.quant import exact_fp32
from .encode import Stream, passages
from .encode_lm import compare, program_routes, rows_of, sample


def program_config(cfg: dict):
    """The program's ``KimiLinearConfig``: the router over the published
    experts, the configuration's share of them held."""
    from openmatch_tpu_torch.models.kimi_linear import (
        kimi_linear_config_from_hf)

    return kimi_linear_config_from_hf(
        dict(cfg, num_experts=cfg["published_num_experts"]))


def build(cfg: dict, seed: int, device):
    """The configuration's ``DRModel`` on ``device``, weights in
    ``cfg["dr"]["dtype"]``, loaded from the seed's draws."""
    from openmatch_tpu_torch.models.dr_model import DRModel
    from openmatch_tpu_torch.models.kimi_linear import load_hf_tensor

    dr = cfg["dr"]
    dtype = DTYPES[dr["dtype"]]
    pcfg = program_config(cfg)
    with torch.device(device):
        model = DRModel(encoder_config=pcfg, backbone_type="kimi_linear",
                        tied=True, pooling=dr["pooling"],
                        normalize=dr["normalize"], dtype=dtype)
    dest = model.encoder_q.state_dict()
    drawn = KimiDrawn(cfg, seed, device, dtype)
    for name in drawn:
        load_hf_tensor(dest, name, drawn[name], pcfg)
    return model.eval()


@dataclass
class Setup:
    cell: Cell
    seed: int
    device: torch.device
    model: object
    flat: np.ndarray
    starts: np.ndarray
    setup_s: float


def setup(cell: Cell, seed: int, device, t_start: float) -> Setup:
    from openmatch_tpu_torch.retriever.encoder import encode_dataset

    device = torch.device(device)
    tr, cfg = cell.traffic, cell.config
    model = build(cfg, seed, device)
    flat, starts = passages(tr, seed)
    bs = tr["batch_size"]
    warm = [{"id": i, "input_ids": flat[starts[i]:starts[i + 1]]}
            for i in range(bs * tr["warm_batches"])]
    encode_dataset(model, warm, batch_size=bs,
                   max_len=cfg["dr"]["p_max_len"],
                   pad_token_id=cfg["pad_token_id"], device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return Setup(cell, seed, device, model, flat, starts,
                 time.time() - t_start)


def window(s: Setup, seconds: float, trace: bool) -> dict:
    """The measured window (its first seconds traced with ``trace``): the
    reps, the documents' ids and what the readers need."""
    from openmatch_tpu_torch.retriever.encoder import encode_dataset

    tr, cfg, model = s.cell.traffic, s.cell.config, s.model
    bs = tr["batch_size"]

    def encode(stream):
        return encode_dataset(model, stream, batch_size=bs,
                              max_len=cfg["dr"]["p_max_len"],
                              pad_token_id=cfg["pad_token_id"],
                              device=s.device)

    counter = model.encoder_q
    counter.reset_expert_slots()
    graphs0 = dict(model.graph_stats)
    prof = tracing.Profiled(s.device) if trace else None
    if prof is not None:  # started before the window: starting takes time
        prof.start()
    t0 = time.perf_counter()
    parts = []
    if prof is not None:
        parts.append(encode(Stream(s.flat, s.starts,
                                   t0 + min(tracing.TRACE_S, seconds))))
        prof.stop()
    traced_held = counter.held_slots.cpu().numpy().copy()
    done = sum(len(p[1]) for p in parts)
    t_rest = time.perf_counter()
    parts.append(encode(Stream(s.flat, s.starts, t0 + seconds, done)))
    elapsed = time.perf_counter() - t0
    rest_s = time.perf_counter() - t_rest
    held = counter.held_slots.cpu().numpy().copy()
    graphs = {k: v - graphs0[k] for k, v in model.graph_stats.items()}
    n_pool = len(s.starts) - 1
    lengths = np.diff(s.starts)
    traced = np.asarray(parts[0][1] if prof is not None else [], np.int64)
    rest = np.asarray(parts[-1][1], np.int64)
    summary = prof.summary() if prof is not None else None
    ids = [i for p in parts for i in p[1]]
    peak = (torch.cuda.max_memory_allocated(s.device)
            if s.device.type == "cuda" else 0)
    print(f"encode_kimi: {len(ids)} documents in {elapsed:.3f} s of window "
          f"({len(ids) / elapsed:.2f}/s) in batches of {bs}; graphs in the "
          f"window {graphs}; peak {peak / 2**30:.2f} GiB", file=sys.stderr)
    return {"reps": np.concatenate([p[0] for p in parts]), "ids": ids,
            "elapsed": elapsed, "peak": peak, "summary": summary,
            "layer": {"trace": summary, "config": cfg, "batch_size": bs,
                      "traced_lengths": lengths[traced % n_pool],
                      "traced_batches": -(-len(traced) // bs),
                      "traced_held_slots": traced_held,
                      "rest_lengths": lengths[rest % n_pool],
                      "rest_held_slots": float((held - traced_held).sum()),
                      "window_s": rest_s, "graphs": graphs}}


def program_sample(s: Setup, w: dict) -> tuple:
    """The sample's window positions and the program's expert choices for
    it (an eager pass, the graphs dropped first)."""
    tr = s.cell.traffic
    which = sample(tr, s.seed, s.starts, w["ids"]) if len(w["ids"]) >= 2 \
        else []
    s.model.release_graphs()
    if s.device.type == "cuda":
        torch.cuda.empty_cache()
    routes = program_routes(s.model, s.cell.config, s.flat, s.starts, which,
                            tr["batch_size"])
    return which, routes


def release_program(s: Setup):
    s.model = None
    if s.device.type == "cuda":
        torch.cuda.empty_cache()


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        t_start: float, device="cuda") -> Outcome:
    from openmatch_tpu_torch.models import kimi_linear  # noqa: F401

    s = setup(cell, seed, device, t_start)
    w = window(s, seconds, trace)
    which, routes = program_sample(s, w)
    release_program(s)
    numbers = check(cell.config, seed, s.flat, s.starts, w["reps"],
                    w["ids"], which, routes, s.device)
    checks = {name: (value, cell.limits.get(name))
              for name, value in numbers.items()}
    n, summary = len(w["ids"]), w["summary"]
    return Outcome(
        correct=judge(checks), attempted=n, failed=0,
        metrics={"encode_passages_per_s": n / w["elapsed"],
                 "setup_s": s.setup_s},
        memory_peak_bytes=w["peak"], chips=1, checks=checks,
        layer=w["layer"],
        busy_s=summary.busy_s if summary else None,
        window_s=summary.window_s if summary else None,
        breakdown=summary.breakdown() if summary else None)


def reference_reps(cfg, seed, flat, starts, which, device, precision=None,
                   routes=None) -> torch.Tensor:
    """The plain reference's reps [len(which), d] of pool documents
    ``which`` (cycled), the weights drawn again from ``seed``, routed as
    ``routes`` (a ``reference.deepseek_v3.Routes``) says."""
    from ..reference import kimi_linear as ref

    rows = rows_of(cfg, flat, starts, which)
    width = max(len(r) for r in rows)
    ids = np.full((len(rows), width), cfg["pad_token_id"], np.int64)
    mask = np.zeros_like(ids)
    for i, r in enumerate(rows):
        ids[i, :len(r)], mask[i, :len(r)] = r, 1
    weights = KimiDrawn(cfg, seed, device, DTYPES[cfg["dr"]["dtype"]])
    with exact_fp32(), torch.no_grad():
        return ref.reps(weights, cfg, torch.from_numpy(ids).to(device),
                        torch.from_numpy(mask).to(device), precision, routes)


def check(cfg, seed, flat, starts, reps, ids, which, routes,
          device) -> dict:
    """``rep_err`` and ``route_err`` over the sample ``which``, routed as
    the program chose (``routes``), and ``order``: 1 when the reps do not
    come back one per document in the order given, else 0."""
    from ..reference.deepseek_v3 import Routes

    n = len(ids)
    if n < 2 or list(ids) != list(range(n)) or reps.shape[0] != n:
        return {"rep_err": 1.0, "route_err": 1.0, "order": 1.0}
    along = Routes(routes)
    want = reference_reps(cfg, seed, flat, starts, which, device,
                          routes=along)
    got = torch.from_numpy(np.asarray(reps[which], np.float32)).to(device)
    return dict(compare(got, want, along), order=0.0)
