"""``encode_lm``: corpus encoding with a last-token LM retriever (the
``deepseek_v3`` backbone) through the program's
``retriever.encoder.encode_dataset``, the path of ``build_index``, the
ANCE refresh and BEIR, as ``encode`` drives it for T5.

Set-up builds the program's ``DRModel`` on the card with its weights held
in bf16 and loads the seed's weights into it tensor by tensor through the
program's own converter (``models.deepseek_v3.load_hf_tensor``), so no
fp32 copy and no second copy of the model is ever made; the program's
module is imported first, so a program without the backbone fails at once.
Then a pool of passages (lengths from the mix's fixed set in the seed's
order, ids from the seed, each ending in the end id) and a few batches to
warm the one shape (the capture of its CUDA graph included). The window
and its traced part are ``encode``'s. The program's per-expert counter is
zeroed before the window and read after it.

The check. The sample of the window's passages (``encode.pick``) is
encoded once more by the program, eagerly (bit for bit the graph the
window replays) in batches padded as the window's are, with its expert
choices recorded (``recording_routes``). Then, with the program's model
freed, the plain float32 reference (``reference/deepseek_v3``) computes
the sample's reps along those choices (``Routes``), its weights drawn
again from the seed layer by layer. In bf16 a token whose k-th and
(k + 1)-th expert scores lie within rounding of each other may take
either, and on seeded weights such changes compound over 26 MoE layers
until the reps differ as far as fp8's; so the reference accepts the
program's choices where they lie within rounding of its own top k, and
holds each to it (``route_err``). ``route_err``: the largest shortfall of
a choice of the program below the reference's top k (score plus bias),
over every real token of the sample in every MoE layer. ``rep_err``: the
largest, over the sample, of a window rep's L2 gap from the reference's
over the reference rep's distance from the sample's mean reference rep.
The reps are centred on that mean because the end id's embedding, shared
by every passage, could otherwise dominate a random model's last-token
reps and hide a broken context path. ``order`` as in ``encode``."""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from .. import tracing
from ..common import Cell, Outcome, judge
from ..lm_weights import Drawn
from ..program import DTYPES
from ..reference.quant import exact_fp32
from .encode import Stream, passages, pick


def build(cfg: dict, seed: int, device):
    """The configuration's ``DRModel`` on ``device``, weights in
    ``cfg["dr"]["dtype"]``, loaded from the seed's draws."""
    from openmatch_tpu_torch.models.deepseek_v3 import (
        deepseek_v3_config_from_hf, load_hf_tensor)
    from openmatch_tpu_torch.models.dr_model import DRModel

    dr = cfg["dr"]
    dtype = DTYPES[dr["dtype"]]
    with torch.device(device):
        model = DRModel(encoder_config=deepseek_v3_config_from_hf(cfg),
                        backbone_type="deepseek_v3", tied=True,
                        pooling=dr["pooling"], normalize=dr["normalize"],
                        dtype=dtype)
    dest = model.encoder_q.state_dict()
    drawn = Drawn(cfg, seed, device, dtype)
    for name in drawn:
        load_hf_tensor(dest, name, drawn[name])
    return model.eval()


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        t_start: float, device="cuda") -> Outcome:
    from openmatch_tpu_torch.retriever.encoder import encode_dataset

    device = torch.device(device)
    tr, cfg = cell.traffic, cell.config
    model = build(cfg, seed, device)
    flat, starts = passages(tr, seed)
    bs, p_len = tr["batch_size"], cfg["dr"]["p_max_len"]
    lengths = np.diff(starts)

    def encode(stream):
        return encode_dataset(model, stream, batch_size=bs, max_len=p_len,
                              pad_token_id=cfg["pad_token_id"], device=device)

    warm = [{"id": i, "input_ids": flat[starts[i]:starts[i + 1]]}
            for i in range(bs * tr["warm_batches"])]
    encode(warm)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.time() - t_start
    counter = model.encoder_q
    counter.reset_expert_slots()
    graphs0 = dict(model.graph_stats)

    prof = tracing.Profiled(device) if trace else None
    if prof is not None:  # started before the window: starting takes time
        prof.start()
    t0 = time.perf_counter()
    parts = []
    if prof is not None:
        parts.append(encode(Stream(flat, starts,
                                   t0 + min(tracing.TRACE_S, seconds))))
        prof.stop()
    done = sum(len(p[1]) for p in parts)
    t_rest = time.perf_counter()
    parts.append(encode(Stream(flat, starts, t0 + seconds, done)))
    elapsed = time.perf_counter() - t0
    reps = np.concatenate([p[0] for p in parts])
    ids = [i for p in parts for i in p[1]]
    rest_s = time.perf_counter() - t_rest
    n_pool = len(starts) - 1
    traced = np.asarray(parts[0][1] if prof is not None else [], np.int64)
    rest = np.asarray(parts[-1][1], np.int64)
    summary = prof.summary() if prof is not None else None
    slots = counter.expert_slots.cpu().numpy().copy()
    graphs = {k: v - graphs0[k] for k, v in model.graph_stats.items()}
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    n = len(ids)
    print(f"encode_lm: {n} passages in {elapsed:.3f} s of window "
          f"({n / elapsed:.2f}/s) in batches of {bs}; graphs in the window "
          f"{graphs}; peak {peak / 2**30:.2f} GiB", file=sys.stderr)
    which = sample(tr, seed, starts, ids) if n >= 2 else []
    routes = program_routes(model, cfg, flat, starts, which, bs)
    del model, counter
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = check(cfg, seed, flat, starts, reps, ids, which, routes,
                    device)
    checks = {name: (value, cell.limits.get(name))
              for name, value in numbers.items()}
    return Outcome(
        correct=judge(checks), attempted=n, failed=0,
        metrics={"encode_passages_per_s": n / elapsed, "setup_s": setup_s},
        memory_peak_bytes=peak, chips=1, checks=checks,
        layer={"trace": summary, "config": cfg, "batch_size": bs,
               "traced_lengths": lengths[traced % n_pool],
               "traced_batches": -(-len(traced) // bs),
               "rest_lengths": lengths[rest % n_pool], "window_s": rest_s,
               "expert_slots": slots, "graphs": graphs},
        busy_s=summary.busy_s if summary else None,
        window_s=summary.window_s if summary else None,
        breakdown=summary.breakdown() if summary else None)


def sample(tr, seed, starts, ids) -> np.ndarray:
    """The window positions the check reads (``encode.pick``)."""
    n = len(ids)
    lengths = np.diff(starts)[np.arange(n) % (len(starts) - 1)]
    return pick(ids, lengths, tr["check_sample"], seed)


def rows_of(cfg, flat, starts, which) -> list:
    """The ids of pool passages ``which`` (cycled), cut to p_max_len."""
    n_pool = len(starts) - 1
    p_len = cfg["dr"]["p_max_len"]
    return [flat[starts[j % n_pool]:starts[j % n_pool + 1]][:p_len]
            for j in which]


def program_routes(model, cfg, flat, starts, which, batch_size) -> list:
    """The program's expert choices for pool passages ``which``: its
    eager encode of them in batches of ``batch_size`` padded as
    ``encode_dataset`` pads the window's, each MoE layer's ids [T, k] over
    the real positions, row after row (``reference.Routes``'s layout)."""
    from openmatch_tpu_torch.data.collators import InferenceCollator
    from openmatch_tpu_torch.data.loader import batched

    collate = InferenceCollator(pad_token_id=cfg["pad_token_id"],
                                max_len=cfg["dr"]["p_max_len"])
    device = next(model.parameters()).device
    rows = [{"id": i, "input_ids": r}
            for i, r in enumerate(rows_of(cfg, flat, starts, which))]
    layers = []
    with torch.inference_mode():
        for (_, batch), n_valid in batched(rows, batch_size, collate,
                                           pad_to_full=True):
            ids = torch.from_numpy(batch["input_ids"]).to(device)
            mask = torch.from_numpy(batch["attention_mask"]).to(device)
            with model.encoder_q.recording_routes() as log:
                model.encode_eager(ids, mask)
            real = mask[:n_valid].bool().reshape(-1)
            per = [t[:real.numel()][real] for t in log]
            layers = per if not layers else [
                torch.cat([a, b]) for a, b in zip(layers, per)]
    return layers


def reference_reps(cfg, seed, flat, starts, which, device,
                   precision=None, routes=None) -> torch.Tensor:
    """The plain reference's reps [len(which), d] of pool passages
    ``which`` (cycled), the weights drawn again from ``seed``, routed as
    ``routes`` (a ``reference.Routes``) says."""
    from ..reference import deepseek_v3 as ref

    rows = rows_of(cfg, flat, starts, which)
    width = max(len(r) for r in rows)
    ids = np.full((len(rows), width), cfg["pad_token_id"], np.int64)
    mask = np.zeros_like(ids)
    for i, r in enumerate(rows):
        ids[i, :len(r)], mask[i, :len(r)] = r, 1
    weights = Drawn(cfg, seed, device, DTYPES[cfg["dr"]["dtype"]])
    with exact_fp32(), torch.no_grad():
        return ref.reps(weights, cfg, torch.from_numpy(ids).to(device),
                        torch.from_numpy(mask).to(device), precision, routes)


def centred_gaps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Each rep's L2 gap from the reference's, over the reference rep's
    distance from the sample's mean reference rep."""
    centre = want.mean(0, keepdim=True)
    return (torch.linalg.vector_norm(got - want, dim=1)
            / torch.linalg.vector_norm(want - centre, dim=1))


def mean_cosine(reps: torch.Tensor) -> float:
    """The mean pairwise cosine of ``reps`` (1: every rep the same)."""
    unit = torch.nn.functional.normalize(reps.double(), dim=1)
    n = unit.shape[0]
    return float(((unit @ unit.T).sum() - n) / (n * (n - 1)))


def compare(got: torch.Tensor, want: torch.Tensor, routes) -> dict:
    """``rep_err`` and ``route_err`` of reps ``got`` against the
    reference's ``want``, computed along ``routes``."""
    gaps = centred_gaps(got, want)
    q = torch.quantile(gaps.double(), torch.tensor(
        [0.0, 0.25, 0.5, 0.75, 1.0], dtype=torch.float64,
        device=gaps.device))
    print(f"encode_lm: reference reps' mean pairwise cosine "
          f"{mean_cosine(want):.4f} over {len(want)}; centred gaps min, "
          f"quartiles, max {[round(float(x), 4) for x in q]}; largest "
          f"route shortfall {routes.shortfall:.3g}", file=sys.stderr)
    return {"rep_err": float(gaps.max()), "route_err": routes.shortfall}


def check(cfg, seed, flat, starts, reps, ids, which, routes,
          device) -> dict:
    """``rep_err`` and ``route_err`` over the sample ``which``, routed as
    the program chose (``routes``), and ``order``: 1 when the reps do not
    come back one per passage in the order given, else 0."""
    from ..reference.deepseek_v3 import Routes

    n = len(ids)
    if n < 2 or list(ids) != list(range(n)) or reps.shape[0] != n:
        return {"rep_err": 1.0, "route_err": 1.0, "order": 1.0}
    along = Routes(routes)
    want = reference_reps(cfg, seed, flat, starts, which, device,
                          routes=along)
    got = torch.from_numpy(np.asarray(reps[which], np.float32)).to(device)
    return dict(compare(got, want, along), order=0.0)
