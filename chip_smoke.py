#!/usr/bin/env python3
"""Drive the PyTorch port's dense-retrieval serving path once on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device   the card's name and power limit (nvidia-smi).
2. build    nvcc-builds the hand-written kernels of
            openmatch_tpu_torch/ops/csrc from this checkout (one nvcc per
            source, all at once).
3. kernels  each kernel against its plain PyTorch version at serving
            shapes (Q in {64, 128}, D = 768, a 2^20 + 29 doc corpus whose
            last tile and N % 8 tail are ragged; the segment kernels over
            the same corpus cut into 3 segments; the block-row gmax over
            its [131075, 8 * 768] block-row view, the score kernel over
            the 8-doc body, the strided-group kernels at tile 2048 and
            1024 over the whole corpus, whose last tile is ragged), with
            median times.
4. serve    a BERT-base DRModel (bf16 compute, seeded random weights)
            encodes 4,096 passages through encode_dataset; the npz shard is
            written and reloaded; the index is filled on the device to all
            8,841,823 MS MARCO rows; a Searcher(k=1000) and a
            RetrievalService(max_batch=64) answer GET /health and 8
            concurrent POST /search requests of 8 queries over HTTP. The
            kernel launch counters must rise during the requests, every
            response must hold k finite non-increasing scores, and an
            exactness audit against a chunked fp32 top-k over the whole
            device index must pass. Then each kernel is compared with its
            plain version once more at the exact shapes the requests gave
            it; the rescore kernels K3 and K5 also at the all-distinct
            selection (64 x 1,000 blocks of a seeded permutation of the
            index's 1,105,227, none repeated: every one read from HBM),
            each selection with its distinct count, queries per block,
            kernel time (behind an untimed call, and behind a device spin:
            the card's work alone), plain time and bound.
            The segmented index: the same rows rebuilt as 6 separately
            allocated segments behind a Searcher(k=1000, n_segs=6) and a
            second RetrievalService answer the same 8 concurrent requests;
            the segment kernels' counters must rise (and the single-buffer
            kernels' stay at 0), the answers must equal the single-buffer
            answers above the k-th score's tie band and pass the fp32
            audit, and K5 must equal K3 bit for bit at both selections.
            At Q=64, plain_topk_prepared with pipeline=True (the
            pipelined rescore kernel must launch) and with c_split=4 must
            equal the default above the tie band. Each segment kernel is
            compared with its plain version at the requests' shapes, and
            the pipelined kernel K6 (one cooperative launch) at the
            serving and the all-distinct selections, timed and bounded as
            K3 is.
            The alternative layouts, at Q=64 and k=1000 over the same
            single-buffer index (a view, never a copy):
            block_topk_prepared with rescore "xla" and "dma",
            block_score_topk_prepared, hier2_search and hier2_rescore at
            tile 2048. Each must equal the default answer above the tie
            band, launch its kernels (and no other layout's), and
            allocate less than 13 GB beyond what was resident; each of
            their kernels is compared with its plain version at the
            shapes the paths gave it. Each kernel's bound (the larger of
            its bytes over the HBM rate and its operations over the bf16
            tensor-core rate, from this run's inputs; the rescore kernels
            count the distinct blocks selected) and, for K8, one
            torch.mm computing the same scores (library_ms).
5. perf     after the index is freed, the perf-script path at the scripts'
            default sizes: the phase-ablation kernel K11's four variants
            at Q=512 over 2,210,456 docs (276,480 blocks) against their
            plain versions; K11 runs on the wgmma mainloop K2 and K8 run,
            so a3base must be bit-equal to K2 and a3nomax to K8's every
            8th score, a3notr bit-equal to a3base's transpose, and
            a3mxutr within 2^-22 x |g| of a3base; every phase of
            perf/score_path_phases.py and a set of perf/micro.py modes
            (the library yardsticks, one per kernel, hier2_full and
            xla_full_pyramid) through their main(argv), each launching
            exactly the kernels it names; last, one K11 launch under
            utils.profiling.trace, whose Chrome trace must be written and
            parse.
6. stages   after every timing (a profiler session can slow the host's
            later launches), the rescore's device time by stage
            (torch.profiler) for K3, K5 and K6 at the selections the serve
            phase timed, replayed over seeded rows of the index's shape
            (the stages' work depends on the block ids, not the values);
            K6 must show as exactly one device kernel per call and no
            memset.

The second-to-last line is the kernel table as one JSON object (``ms``
and ``library_ms`` are device time, each timed call queued behind an
untimed one; ``plain_ms`` brackets the plain version's call with one CUDA
event pair), the last line {"ok": true, "device": {...}}. It needs CUDA: without a card it
raises before printing any result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
N_MSMARCO = 8_841_823
D = 768
K = 1000
MAX_BATCH = 64
REL_TOL = 1e-3  # |kernel - plain| <= REL_TOL * max|score|: bf16 inputs,
# fp32 sums in another order; masked entries must be bit-equal
N_SEGS = 6  # the segmented index of the reference's 8.8M-doc headline
CSRC = "openmatch_tpu_torch/ops/csrc/"
TPU = "openmatch_tpu/ops/pallas_mips.py:"
# kernel-table name -> (source, the TPU kernel it replaces)
KERNELS = {
    "plain_gmax": (CSRC + "plain_gmax.cu", TPU + "562"),
    "gather_rescore": (CSRC + "gather_rescore.cu", TPU + "970"),
    "plain_gmax_segs": (CSRC + "plain_gmax.cu", TPU + "732"),
    "gather_rescore_seg": (CSRC + "gather_rescore.cu", TPU + "1013"),
    # K3 and K5 again at the all-distinct selection (no block repeats)
    "gather_rescore_distinct": (CSRC + "gather_rescore.cu", TPU + "970"),
    "gather_rescore_seg_distinct": (CSRC + "gather_rescore.cu", TPU + "1013"),
    "gather_rescore_pipelined": (CSRC + "gather_rescore_pipelined.cu",
                                 TPU + "1114"),
    # K6 again at the all-distinct selection
    "gather_rescore_pipelined_distinct": (
        CSRC + "gather_rescore_pipelined.cu", TPU + "1114"),
    "block_gmax": (CSRC + "plain_gmax.cu", TPU + "469"),
    "scores": (CSRC + "scores.cu", TPU + "1591"),
    "score_gmax": (CSRC + "score_tiles.cu", TPU + "133"),
    "gmax_only": (CSRC + "score_tiles.cu", TPU + "254"),
    "gmax_phase": (CSRC + "gmax_phases.cu",
                   "scripts/perf/score_path_phases.py:164"),
}
CORPUS_COPY = 13e9  # bytes: a layout path allocating this much copied the index
HBM_BYTES_PER_S = 3.35e12  # H100 SXM: HBM3 rate and dense bf16 tensor-core
BF16_FLOPS = 989e12        # rate (NVIDIA's data sheet, 700 W)
MXU_TR_REL = 2.0**-22  # a3mxutr vs a3base: the tf32 split is exact; 2 ulp


def log(msg: str):
    print(msg, flush=True)


def cuda_time_ms(fn, warmup: int = 3, reps: int = 15) -> float:
    """Median device time of ``fn`` in ms, one CUDA event pair per run (the
    perf twins' timer)."""
    from openmatch_tpu_torch.perf import time_ms

    return time_ms(fn, torch.device("cuda", 0), warmup, reps)


def kernel_ms(fn, warmup: int = 3, reps: int = 15, queue: str = "call") -> float:
    """Median device time of one call of ``fn`` in ms, for the kernel
    table's ``ms`` and ``library_ms``: each timed call is queued behind an
    untimed one (``perf.event_ms``), so its CUDA event pair does not hold
    the host's time to reach the launch (up to 0.4 ms per call while the
    serving threads run), but does hold the host's enqueue of the call
    where that takes longer than the card's run of the call before.
    ``queue="spin"`` leaves that out too: the card's work alone."""
    from openmatch_tpu_torch.perf import time_ms

    return time_ms(fn, torch.device("cuda", 0), warmup, reps, queue)


def reset_launches(cm):
    """Set every kernel wrapper's launch count to 0."""
    cm.fused_plain_gmax.launches = 0
    cm.fused_plain_gmax_segs.launches = 0
    cm.gather_rescore.launches = 0
    cm.gather_rescore.seg_launches = 0
    cm.gather_rescore.pipelined_launches = 0
    cm.fused_block_gmax.launches = 0
    cm.fused_scores.launches = 0
    cm.fused_score_gmax.launches = 0
    cm.fused_gmax_only.launches = 0
    cm.fused_gmax_phase.launches = 0


def read_launches(cm) -> dict:
    return {"plain_gmax": cm.fused_plain_gmax.launches,
            "plain_gmax_segs": cm.fused_plain_gmax_segs.launches,
            "gather_rescore": cm.gather_rescore.launches,
            "gather_rescore_seg": cm.gather_rescore.seg_launches,
            "gather_rescore_pipelined": cm.gather_rescore.pipelined_launches,
            "block_gmax": cm.fused_block_gmax.launches,
            "scores": cm.fused_scores.launches,
            "score_gmax": cm.fused_score_gmax.launches,
            "gmax_only": cm.fused_gmax_only.launches,
            "gmax_phase": cm.fused_gmax_phase.launches}


def compare(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Max abs error of ``got`` vs ``want``; raises past REL_TOL * max|want|
    on finite entries and unless masked (finfo.min) entries are bit-equal."""
    neg = torch.finfo(torch.float32).min
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    masked = want == neg
    if not torch.equal(got == neg, masked):
        raise AssertionError(f"{name}: masked entries differ")
    live = ~masked
    err = (got[live] - want[live]).abs().max().item() if live.any() else 0.0
    scale = want[live].abs().max().item() if live.any() else 0.0
    if not err <= REL_TOL * max(scale, 1e-30):
        raise AssertionError(f"{name}: max abs err {err} > {REL_TOL} * {scale}")
    log(f"  {name}: max_abs_err={err:.3e} (max|score|={scale:.3e}, "
        f"masked={int(masked.sum())})")
    return err


def bound(n_bytes: float, n_ops: float) -> tuple:
    """(bound_ms, bound_by): the least time the card could take for work
    that moves ``n_bytes`` (each input read once, each output written
    once) and does ``n_ops`` bf16 tensor-core operations."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / BF16_FLOPS
    return (max(t_bytes, t_ops) * 1000,
            "bytes" if t_bytes >= t_ops else "operations")


def gmax_bound(q: torch.Tensor, row_elems: int, out_elems: int) -> tuple:
    """Bound of a kernel that scores ``row_elems`` bf16 corpus values once
    against every query and writes ``out_elems`` fp32 values: 2 ops a
    multiply-add."""
    return bound(row_elems * 2 + q.numel() * 2 + out_elems * 4,
                 2 * q.shape[0] * row_elems)


def rescore_bound(q: torch.Tensor, bid: torch.Tensor) -> tuple:
    """Bound of a gather-rescore: the distinct selected blocks' 8 rows read
    once (counted on the card), queries and ids in, k * 8 fp32 scores out."""
    D = q.shape[1]
    distinct = torch.unique(bid).numel()
    return bound(distinct * 8 * D * 2 + q.numel() * 2 + bid.numel() * 4
                 + bid.numel() * 8 * 4, 2 * bid.numel() * 8 * D)


def distinct_selection(nb: int, dev) -> torch.Tensor:
    """[MAX_BATCH, K] int32 block ids from a seeded permutation of all nb
    blocks: no block repeats, so the rescore must read every selected
    block from HBM (its worst case; the serving selection repeats)."""
    g = torch.Generator(device=dev).manual_seed(7)
    perm = torch.randperm(nb, generator=g, device=dev)
    return perm[:MAX_BATCH * K].view(MAX_BATCH, K).to(torch.int32)


def rescore_row(cm, name: str, reps, body, bid, replay: list,
                pipeline: bool = False) -> tuple:
    """K3 (single buffer), K5 (segments) or K6 (``pipeline``) at one
    selection: compared with the plain version, timed beside it, and
    bounded over the distinct blocks; (name, queries, ids, segment count,
    pipeline) joins ``replay`` for the stage breakdown. Returns (err, ms,
    plain ms, (bound ms, bound by), None)."""
    def run():
        return cm.gather_rescore(reps, body, bid, pipeline=pipeline)

    err = compare(name, run(), cm.gather_rescore_reference(reps, body, bid))
    ms = kernel_ms(run)
    spin = kernel_ms(run, queue="spin")
    plain_ms = cuda_time_ms(lambda: cm.gather_rescore_reference(
        reps, body, bid), 1, 5)
    b = rescore_bound(reps, bid)
    _, per_block = torch.unique(torch.cat([row.unique() for row in bid]),
                                return_counts=True)  # queries per block
    hist = torch.bincount(per_block, minlength=65)
    log(f"serve: {name}: {per_block.numel()} distinct of {bid.numel()} "
        f"selected blocks ({int(hist[1])} of 1 query, {int(hist[2])} of 2, "
        f"{int(hist[3:].sum())} of 3 to {int(per_block.max())}; blocks by "
        f"queries 1-64: {hist[1:].tolist()}), kernel {ms:.4f} ms behind an "
        f"untimed call, {spin:.4f} ms behind a device spin, plain "
        f"{plain_ms:.4f} ms, bound {b[0]:.4f} ms ({b[1]})")
    segs = len(body) if isinstance(body, tuple) else 1
    replay.append((name, reps.clone(), bid.clone(), segs, pipeline))
    return err, ms, plain_ms, b, None


def phase_stages(dev, replay: list):
    """Each replayed rescore's device time by stage, over seeded rows of
    the serving index's shape cut as the serve phase cut it. K6 must show
    as one device kernel per call and no memset."""
    from openmatch_tpu_torch.ops import cuda_mips as cm
    from openmatch_tpu_torch.perf import normal

    with torch.inference_mode():
        rows = normal((N_MSMARCO, D), 3, dev)
        bodies = {1: cm.prepare_plain_corpus(rows).plain}
        for _, _, _, segs, _ in replay:
            if segs not in bodies:
                bodies[segs] = cm.prepare_plain_corpus(rows, segs).plain
        for name, reps, bid, segs, pipe in replay:
            ops = device_ops(lambda: cm.gather_rescore(
                reps, bodies[segs], bid, pipeline=pipe))
            log(f"stages: {name}, device us (launches) per call by stage "
                "(torch.profiler): " + (", ".join(
                    f"{n} {us:.1f} ({c:g})" for n, (us, c) in ops.items())
                    or "no device time in the trace"))
            want = {"gather_rescore_pipelined_kernel": 1.0}
            if pipe and {n: c for n, (_, c) in ops.items()} != want:
                raise AssertionError(f"stages: {name} ran {ops}, expected "
                                     "one K6 kernel a call and no memset")
    del rows, bodies
    torch.cuda.empty_cache()


def device_ops(fn, calls: int = 5) -> dict:
    """{kernel or memset: (mean device us per call, launches per call)} of
    what ``fn`` runs on the card, from ``torch.profiler``: the rescore's
    stages."""
    import re

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ops = {}
    for e in prof.key_averages():
        name = re.search(r"\w+_kernel|Memset", e.key)
        dt = getattr(e, "device_time_total", 0) or getattr(
            e, "cuda_time_total", 0)
        if name and dt:
            us, n = ops.get(name.group(0), (0.0, 0.0))
            ops[name.group(0)] = (us + dt / calls, n + e.count / calls)
    return ops


def check_k11(cm, q: torch.Tensor, body: torch.Tensor, label: str) -> float:
    """K11's four variants against their plain versions over the 8-doc
    body; on the wgmma mainloop K2 and K8 run, a3base bit-equal to K2 and
    a3nomax to K8's every 8th score; a3notr bit-equal to a3base
    transposed, a3mxutr within MXU_TR_REL x |g| of a3base (entries not
    bit-equal are counted). Returns the largest max abs error against the
    plain versions."""
    err = 0.0
    base = cm.fused_gmax_phase(q, body, "a3base")
    if not torch.equal(base, cm.fused_plain_gmax(q, body)):
        raise AssertionError(f"K11 a3base != K2 ({label})")
    for phase in cm.GMAX_PHASES:
        got = base if phase == "a3base" else cm.fused_gmax_phase(q, body,
                                                                 phase)
        err = max(err, compare(f"K11 {phase} {label}", got,
                               cm.gmax_phase_reference(q, body, phase)))
        if phase == "a3notr" and not torch.equal(got, base.T):
            raise AssertionError(f"K11 a3notr != a3base.T ({label})")
        if phase == "a3mxutr":
            off = (got - base).abs() > MXU_TR_REL * base.abs()
            if off.any():
                raise AssertionError(f"K11 a3mxutr: {int(off.sum())} entries "
                                     f"beyond 2^-22 x |a3base| ({label})")
            log(f"  K11 a3mxutr {label}: {int((got != base).sum())} of "
                f"{base.numel()} entries not bit-equal to a3base")
        if phase == "a3nomax" and not torch.equal(
                got, cm.fused_scores(q, body)[:, ::8]):
            raise AssertionError(f"K11 a3nomax != K8[:, ::8] ({label})")
        del got
    log(f"  K11 {label}: a3base == K2, a3nomax == K8[:, ::8], a3notr == "
        "a3base.T, bit for bit")
    return err


# ---------------------------------------------------------------------------


def phase_device() -> dict:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"device: {name} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} visible)")
    log(smi.splitlines()[0])
    return {"name": name, "smi": smi.splitlines()[0]}


def phase_build():
    from openmatch_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_library()
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_info['seconds']:.2f} s) -> "
        f"{os.path.relpath(_build.build_info['library'], REPO)}")
    for line in _build.build_info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")


def phase_kernels(dev):
    from openmatch_tpu_torch.ops import cuda_mips as cm

    g = torch.Generator(device=dev).manual_seed(1)
    N = 2**20 + 29  # 131075 blocks: the last 16-block tile holds 3; tail 5
    NB = N // 8
    corpus = (torch.randn(N, D, generator=g, device=dev) * 0.05).to(
        torch.bfloat16)
    prep = cm.prepare_plain_corpus(corpus)
    segs = cm.prepare_plain_corpus(corpus, n_segs=3).plain
    cb = cm.prepare_block_corpus(corpus).cb
    log(f"kernels: 3 segments of {[s.shape[0] // 8 for s in segs]} blocks; "
        f"block rows {tuple(cb.shape)}")
    for Q in (64, 128):
        q = torch.randn(Q, D, generator=g, device=dev).to(torch.bfloat16)
        nb_valid = NB - 37
        g1, l1 = cm.fused_plain_gmax(q, prep.plain, emit_l1=8,
                                     nb_valid=nb_valid)
        r1, rl1 = cm.plain_gmax_reference(q, prep.plain, emit_l1=8,
                                          nb_valid=nb_valid)
        torch.cuda.synchronize()
        compare(f"K1 gmax Q={Q}", g1, r1)
        compare(f"K1 l1 Q={Q}", l1, rl1)
        lo, n = 1001, 50_003  # a window that starts and ends mid-tile
        gw, lw = cm.fused_plain_gmax(q, prep.plain, blk_lo=lo, n_blk=n,
                                     emit_l1=8, nb_valid=lo + n - 11)
        rw, rlw = cm.plain_gmax_reference(q, prep.plain, blk_lo=lo, n_blk=n,
                                          emit_l1=8, nb_valid=lo + n - 11)
        compare(f"K1 window gmax Q={Q}", gw, rw)
        compare(f"K1 window l1 Q={Q}", lw, rlw)
        g2 = cm.fused_plain_gmax(q, prep.plain)
        compare(f"K2 gmax Q={Q}", g2, cm.plain_gmax_reference(
            q, prep.plain))
        g4, l4 = cm.fused_plain_gmax_segs(q, segs, emit_l1=8,
                                          nb_valid=nb_valid)
        r4, rl4 = cm.plain_gmax_segs_reference(q, segs, emit_l1=8,
                                               nb_valid=nb_valid)
        compare(f"K4 gmax Q={Q}", g4, r4)
        compare(f"K4 l1 Q={Q}", l4, rl4)
        if not (torch.equal(g4, g1) and torch.equal(l4, l1)):
            raise AssertionError("K4 over 3 segments != K1 over one buffer")
        bids = torch.randint(0, NB, (Q, K), generator=g, device=dev,
                             dtype=torch.int32)
        bids[:, :4] = bids[:, 4:8]  # repeated ids
        bids[:, -1] = NB - 1        # the last block
        cuts = torch.tensor([0] + [s.shape[0] // 8 for s in segs],
                            device=dev).cumsum(0)
        bids[:, 8:11] = cuts[1:].int() - 1  # each segment's last block
        bids[:, 11:14] = cuts[:-1].int()    # ... and its first
        s3 = cm.gather_rescore(q, prep.plain, bids)
        r3 = cm.gather_rescore_reference(q, prep.plain, bids)
        compare(f"K3 rescore Q={Q}", s3, r3)
        s5 = cm.gather_rescore(q, segs, bids)
        compare(f"K5 rescore Q={Q}", s5, r3)
        if not torch.equal(s5, s3):
            raise AssertionError("K5 over 3 segments != K3 over one buffer")
        s6 = cm.gather_rescore(q, prep.plain, bids, pipeline=True)
        compare(f"K6 rescore Q={Q}", s6, r3)
        t = {
            "K1": (kernel_ms(lambda: cm.fused_plain_gmax(
                q, prep.plain, emit_l1=8, nb_valid=nb_valid)),
                cuda_time_ms(lambda: cm.plain_gmax_reference(
                    q, prep.plain, emit_l1=8, nb_valid=nb_valid))),
            "K2": (kernel_ms(lambda: cm.fused_plain_gmax(q, prep.plain)),
                   cuda_time_ms(lambda: cm.plain_gmax_reference(
                       q, prep.plain))),
            "K4": (kernel_ms(lambda: cm.fused_plain_gmax_segs(
                q, segs, emit_l1=8, nb_valid=nb_valid)),
                cuda_time_ms(lambda: cm.plain_gmax_segs_reference(
                    q, segs, emit_l1=8, nb_valid=nb_valid))),
            "K3": (kernel_ms(lambda: cm.gather_rescore(
                q, prep.plain, bids)),
                cuda_time_ms(lambda: cm.gather_rescore_reference(
                    q, prep.plain, bids))),
            "K5": (kernel_ms(lambda: cm.gather_rescore(q, segs, bids)),
                   cuda_time_ms(lambda: cm.gather_rescore_reference(
                       q, segs, bids))),
            "K6": (kernel_ms(lambda: cm.gather_rescore(
                q, prep.plain, bids, pipeline=True)),
                cuda_time_ms(lambda: cm.gather_rescore_reference(
                    q, prep.plain, bids))),
        }
        t.update(layout_kernels(cm, q, corpus, prep.plain, cb))
        check_k11(cm, q, prep.plain, f"Q={Q}")
        for phase in cm.GMAX_PHASES:
            t[f"K11 {phase}"] = (
                kernel_ms(lambda: cm.fused_gmax_phase(q, prep.plain,
                                                      phase)),
                cuda_time_ms(lambda: cm.gmax_phase_reference(
                    q, prep.plain, phase), 1, 3))
        for key, (ms, plain_ms) in t.items():
            log(f"  {key} Q={Q} N={N}: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms")
    del corpus, prep, segs, cb
    torch.cuda.empty_cache()


def layout_kernels(cm, q, corpus, body, cb) -> dict:
    """K7-K10 against their plain versions on the kernels phase's corpus:
    K7 over the block-row view (bit-equal to K2 over the same bytes), K8
    over the 8-doc body, K9 and K10 at tile 2048 and 1024 over the whole
    corpus (ragged last tile; K10 bit-equal to K9's maxima). Returns
    {name: (kernel ms, plain ms)}."""
    Q = q.shape[0]
    g7 = cm.fused_block_gmax(q, cb)
    compare(f"K7 block gmax Q={Q}", g7, cm.block_gmax_reference(q, cb))
    if not torch.equal(g7, cm.fused_plain_gmax(q, body)):
        raise AssertionError("K7 over the block rows != K2 over the body")
    del g7
    compare(f"K8 scores Q={Q}", cm.fused_scores(q, body),
            cm.scores_reference(q, body))
    t = {"K7": (kernel_ms(lambda: cm.fused_block_gmax(q, cb)),
                cuda_time_ms(lambda: cm.block_gmax_reference(q, cb), 1, 3)),
         "K8": (kernel_ms(lambda: cm.fused_scores(q, body)),
                cuda_time_ms(lambda: cm.scores_reference(q, body), 1, 3))}
    for tile in (2048, 1024):
        s9, g9 = cm.fused_score_gmax(q, corpus, tile)
        rs, rg = cm.score_gmax_reference(q, corpus, tile)
        compare(f"K9 scores tile={tile} Q={Q}", s9, rs)
        compare(f"K9 gmax tile={tile} Q={Q}", g9, rg)
        g10 = cm.fused_gmax_only(q, corpus, tile)
        compare(f"K10 gmax tile={tile} Q={Q}", g10, rg)
        if not torch.equal(g10, g9):
            raise AssertionError(f"K10 != K9's maxima at tile {tile}")
        del s9, g9, rs, rg, g10
        t[f"K9 tile={tile}"] = (
            kernel_ms(lambda: cm.fused_score_gmax(q, corpus, tile)),
            cuda_time_ms(lambda: cm.score_gmax_reference(q, corpus, tile),
                         1, 3))
        t[f"K10 tile={tile}"] = (
            kernel_ms(lambda: cm.fused_gmax_only(q, corpus, tile)),
            cuda_time_ms(lambda: cm.gmax_only_reference(q, corpus, tile),
                         1, 3))
    return t


class WhitespaceTokenizer:
    """Hashes whitespace-separated words into the BERT vocab:
    [CLS] word ids [SEP], pad id 0 (the card's machine has no
    ``transformers``)."""

    pad_token_id = 0
    cls_token_id = 101
    sep_token_id = 102

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def encode_plus(self, text, truncation=None, max_length=None,
                    padding=False, return_attention_mask=False,
                    return_token_type_ids=False):
        import zlib

        ids = [1000 + zlib.crc32(w.encode()) % (self.vocab_size - 1000)
               for w in text.split()]
        if max_length is not None:
            ids = ids[:max_length - 2]
        return {"input_ids": [self.cls_token_id] + ids + [self.sep_token_id]}


class SyntheticDocIds:
    """Doc ids of the index without a list of 8.8M strings: the encoded
    passages keep their ids, the generated rows are named by position."""

    def __init__(self, passage_ids, n_docs: int):
        self.passage_ids = passage_ids
        self.n_docs = n_docs

    def __len__(self):
        return self.n_docs

    def __getitem__(self, i: int) -> str:
        if i < 0 or i >= self.n_docs:
            raise IndexError(i)
        return self.passage_ids[i] if i < len(self.passage_ids) else f"syn{i}"


def bert_base_tree(rng: np.random.Generator, cfg) -> dict:
    """Seeded random weights in the JAX package's Flax tree layout."""
    d, ff, H = cfg.hidden_size, cfg.intermediate_size, cfg.num_attention_heads

    def n(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * 0.02

    def ln():
        return {"scale": np.ones(d, np.float32), "bias": np.zeros(d, np.float32)}

    tree = {
        "word_embeddings": {"embedding": n(cfg.vocab_size, d)},
        "position_embeddings": {"embedding": n(cfg.max_position_embeddings, d)},
        "token_type_embeddings": {"embedding": n(cfg.type_vocab_size, d)},
        "embeddings_ln": ln(),
    }
    for i in range(cfg.num_hidden_layers):
        tree[f"layer_{i}"] = {
            "attention": {
                "qkv": {"kernel": n(d, 3, H, d // H),
                        "bias": n(3, H, d // H)},
                "out": {"kernel": n(H, d // H, d), "bias": n(d)},
            },
            "attention_ln": ln(),
            "intermediate": {"kernel": n(d, ff), "bias": n(ff)},
            "output": {"kernel": n(ff, d), "bias": n(d)},
            "output_ln": ln(),
        }
    return {"encoder_q": tree}


def http_json(url: str, payload=None, timeout: float = 600.0):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            body = json.loads(resp.read())
            status = resp.status
    except urllib.error.HTTPError as e:
        raise AssertionError(f"{url}: HTTP {e.code} {e.read()[:2000]!r}") from e
    return status, body, time.perf_counter() - t0


AUDIT_REL = 1e-4  # audit: score tolerance and tie band, x max|score| of the row


def audit(reps: torch.Tensor, index: torch.Tensor, results, doc_pos) -> float:
    """HTTP results vs a chunked fp32 top-k over the whole device index.
    Every doc scoring above the k-th score's tie band must be returned,
    every returned doc must score within the band of the k-th, and the
    returned scores must match the fp32 ones. Returns the max abs error."""
    from openmatch_tpu_torch.ops.mips import exact_search

    ref_s, ref_i = exact_search(reps, index, k=K)
    worst = 0.0
    for r, res in enumerate(results):
        ids = torch.tensor([doc_pos(x["id"]) for x in res], device=index.device)
        got = torch.tensor([x["score"] for x in res], device=index.device)
        exact = index[ids].float() @ reps[r].float()
        tol = AUDIT_REL * ref_s[r].abs().max().item()
        s_k = ref_s[r, K - 1].item()
        err = max((got - exact).abs().max().item(),
                  (got - ref_s[r]).abs().max().item())
        worst = max(worst, err)
        if err > tol:
            raise AssertionError(f"audit row {r}: scores off by {err} > {tol}")
        if len(set(ids.tolist())) != K:
            raise AssertionError(f"audit row {r}: duplicate docs returned")
        if (exact < s_k - tol).any():
            raise AssertionError(f"audit row {r}: a returned doc scores "
                                 "below the k-th score's tie band")
        must = set(ref_i[r][ref_s[r] > s_k + tol].tolist())
        missing = must - set(ids.tolist())
        if missing:
            raise AssertionError(f"audit row {r}: {len(missing)} of the "
                                 f"{len(must)} docs above the tie band are "
                                 "missing")
    return worst


def same_above_band(name: str, s_a, i_a, s_b, i_b):
    """Two top-k answers [Q, K] agree: scores within AUDIT_REL x max|score|,
    and each answer holds every doc the other scores above the k-th score's
    tie band of ``s_b``. (Two paths that sum a doc's score in another order
    may put it on either side of the band's edge, so the docs above the
    band are looked up in the whole other answer.)"""
    for r in range(s_b.shape[0]):
        tol = AUDIT_REL * s_b[r].abs().max().item()
        err = (s_a[r] - s_b[r]).abs().max().item()
        band = s_b[r, -1].item() + tol
        if err > tol \
                or not set(i_a[r][s_a[r] > band].tolist()) <= set(
                    i_b[r].tolist()) \
                or not set(i_b[r][s_b[r] > band].tolist()) <= set(
                    i_a[r].tolist()):
            raise AssertionError(f"{name}: row {r} differs above the tie "
                                 f"band (score err {err}, tolerance {tol})")
    log(f"serve: {name}: equal above the tie band for {s_b.shape[0]} rows")


def serve_http(service, requests, cm) -> tuple:
    """GET /health and the requests as concurrent POST /search over HTTP,
    with every launch count set to 0 just before and read just after.
    Returns (answers, launches)."""
    from openmatch_tpu_torch.drivers.serve import ServingHTTPServer, make_handler

    service.warmup()
    service.timeline = []
    server = ServingHTTPServer(("127.0.0.1", 0), make_handler(service, K))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        reset_launches(cm)
        status, health, _ = http_json(base + "/health")
        with ThreadPoolExecutor(max_workers=len(requests)) as pool:
            futures = [pool.submit(http_json, base + "/search",
                                   {"queries": qs, "k": K})
                       for qs in requests]
            answers = [f.result() for f in futures]
        launches = read_launches(cm)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    if status != 200 or health.get("num_docs") != service.searcher.n_docs:
        raise AssertionError(f"/health: {status} {health}")
    log(f"serve: /health {health}")
    log(f"serve: launches during the requests {launches}; service "
        f"{service.stats}")
    lat = []
    for (st, body, sec), qs in zip(answers, requests):
        lat.append(sec * 1000)
        if st != 200 or len(body["results"]) != len(qs):
            raise AssertionError(f"/search answered {st}")
        for res in body["results"]:
            s = np.array([x["score"] for x in res])
            if len(res) != K or not np.isfinite(s).all() or (np.diff(s) > 0).any():
                raise AssertionError("a response is not k finite "
                                     "non-increasing scores")
    log(f"serve: per-request latency ms ({len(requests)} concurrent x "
        f"{len(requests[0])} queries, k={K}): "
        + ", ".join(f"{x:.1f}" for x in lat))
    for t in service.timeline:
        log(f"serve: dispatch of {t['reqs']} requests / {t['rows']} queries: "
            f"queued {t['wait_s'] * 1000:.1f} ms, executed "
            f"{t['exec_s'] * 1000:.1f} ms, of which encode+search+readback "
            f"{t['device_s'] * 1000:.1f} ms")
    return [res for _, body, _ in answers for res in body["results"]], launches


def answers_tensor(results, doc_pos, device):
    """HTTP results -> (scores [n, K], doc positions [n, K])."""
    s = torch.tensor([[x["score"] for x in res] for res in results],
                     device=device)
    i = torch.tensor([[doc_pos(x["id"]) for x in res] for res in results],
                     device=device)
    return s, i


def phase_serve(dev, replay: list) -> tuple:
    from openmatch_tpu_torch.drivers.serve import RetrievalService
    from openmatch_tpu_torch.models.bert import BertConfig
    from openmatch_tpu_torch.models.dr_model import DRModel
    from openmatch_tpu_torch.models.jax_convert import params_from_jax
    from openmatch_tpu_torch.ops import cuda_mips as cm
    from openmatch_tpu_torch.ops.mips import Searcher, _select_groups
    from openmatch_tpu_torch.retriever.encoder import (encode_dataset,
                                                       list_shards,
                                                       load_embeddings,
                                                       save_embeddings,
                                                       shard_path)

    rng = np.random.default_rng(0)
    cfg = BertConfig()  # BERT-base: 768 wide, 12 layers, 12 heads
    n_docs, n_pass = N_MSMARCO, 4096
    t0 = time.perf_counter()
    model = DRModel(cfg, dtype=torch.bfloat16)
    model.load_state_dict(params_from_jax(bert_base_tree(rng, cfg)))
    model = model.to(dev).eval()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"serve: BERT-base DRModel ({n_params} fp32 params, bf16 compute) "
        f"built in {time.perf_counter() - t0:.2f} s")

    tok = WhitespaceTokenizer(cfg.vocab_size)
    words = [f"t{i}" for i in range(20000)]
    lengths = rng.integers(40, 121, n_pass)
    passages = [" ".join(rng.choice(words, n)) for n in lengths]
    dataset = [{"id": f"p{i}", "input_ids": tok.encode_plus(
        t, max_length=128)["input_ids"]} for i, t in enumerate(passages)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    emb, ids = encode_dataset(model, dataset, batch_size=256, max_len=128,
                              pad_token_id=0, device=dev)
    enc_s = time.perf_counter() - t0
    log(f"serve: encoded {len(ids)} passages (p_max_len 128) in "
        f"{enc_s:.3f} s = {len(ids) / enc_s:.1f} passages/s")
    if emb.shape != (n_pass, cfg.hidden_size) or not np.isfinite(emb).all():
        raise AssertionError(f"bad passage embeddings {emb.shape}")
    with tempfile.TemporaryDirectory() as tmp:
        save_embeddings(emb, ids, shard_path(tmp, "corpus", 0), num_shards=1)
        (path,) = list_shards(tmp, "corpus")
        emb2, ids2 = load_embeddings(path)
    if not (np.array_equal(emb, emb2) and ids == ids2):
        raise AssertionError("npz shard did not round-trip")

    t0 = time.perf_counter()
    index = torch.empty((n_docs, cfg.hidden_size), dtype=torch.bfloat16, device=dev)
    enc = torch.from_numpy(emb2).to(dev)
    index[:n_pass] = enc.to(torch.bfloat16)
    mu, sigma = enc.float().mean(0), enc.float().std(0)
    g = torch.Generator(device=dev).manual_seed(0)
    step = 1 << 20
    for lo in range(n_pass, n_docs, step):
        hi = min(lo + step, n_docs)
        rows = torch.randn((hi - lo, cfg.hidden_size), generator=g, device=dev)
        index[lo:hi] = (rows * sigma + mu).to(torch.bfloat16)
    del enc, rows
    torch.cuda.synchronize()
    log(f"serve: index {n_docs} x {cfg.hidden_size} bf16 "
        f"({index.numel() * 2 / 2**30:.2f} GiB) filled on the device in "
        f"{time.perf_counter() - t0:.2f} s")

    doc_ids = SyntheticDocIds(ids2, n_docs)
    pos = {d: i for i, d in enumerate(ids2)}

    def doc_pos(d):
        return pos[d] if d in pos else int(d[3:])

    searcher = Searcher(index, k=K)
    if searcher.method != "kernel":
        raise AssertionError(f"Searcher chose {searcher.method} on CUDA")
    service = RetrievalService(model, tok, searcher, doc_ids, q_max_len=32,
                               max_batch=MAX_BATCH)
    requests = [[" ".join(rng.choice(words, rng.integers(3, 9)))
                 for _ in range(8)] for _ in range(8)]
    flat_res, launches = serve_http(service, requests, cm)
    if min(launches["plain_gmax"], launches["gather_rescore"]) < 1 \
            or launches["plain_gmax_segs"] or launches["gather_rescore_seg"]:
        raise AssertionError("the single-buffer path must run the "
                             f"single-buffer kernels only: {launches}")

    # the same 64 query embeddings the service searched (batches are padded
    # to max_batch, so a query encodes the same in any batch)
    flat_q = [q for qs in requests for q in qs]
    with torch.inference_mode():
        reps = service.encode_queries(flat_q).contiguous()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s_k, i_k = searcher.search(reps)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1000
        search_ms = cuda_time_ms(lambda: searcher.search(reps), 2, 10)
        log(f"serve: per-batch search (Q={MAX_BATCH}, k={K}, N={n_docs}): "
            f"median {search_ms:.3f} ms device-timed, one host-timed call "
            f"{host_ms:.3f} ms")
        err = audit(reps, index, flat_res, doc_pos)
        log(f"serve: exactness audit vs fp32 top-k over {n_docs} docs "
            f"passed for {len(flat_res)} queries (max abs err {err:.3e}, "
            f"tolerance {AUDIT_REL} x max|score|)")

        # each kernel vs its plain version at the shapes the requests gave it
        prep = searcher._prep
        g1, l1 = cm.fused_plain_gmax(reps, prep.plain, emit_l1=8)
        r1, rl1 = cm.plain_gmax_reference(reps, prep.plain, emit_l1=8)
        e1 = max(compare("full-scale K1 gmax", g1, r1),
                 compare("full-scale K1 l1", l1, rl1))
        del r1, rl1
        bid = _select_groups(g1, K, l1=l1).to(torch.int32)
        nb = prep.plain.shape[0] // 8
        r3 = rescore_row(cm, "full-scale K3, serving selection", reps,
                         prep.plain, bid, replay)
        r3d = rescore_row(cm, "full-scale K3, all-distinct selection", reps,
                          prep.plain, distinct_selection(nb, reps.device),
                          replay)
        t1 = kernel_ms(lambda: cm.fused_plain_gmax(reps, prep.plain,
                                                   emit_l1=8))
        t1p = cuda_time_ms(lambda: cm.plain_gmax_reference(
            reps, prep.plain, emit_l1=8), 1, 3)
        t_sel = cuda_time_ms(lambda: _select_groups(g1, K, l1=l1))
        b1 = gmax_bound(reps, prep.plain.numel(),
                        MAX_BATCH * (nb + -(-nb // 8)))
        log(f"serve: at Q={MAX_BATCH}, N={n_docs}: K1 {t1:.4f} ms "
            f"(plain {t1p:.4f}, bound {b1[0]:.4f}, {b1[1]}), selection "
            f"{t_sel:.4f} ms, K3 {r3[1]:.4f} ms, whole search "
            f"{search_ms:.4f} ms")

        # the pipelined rescore and the sequential corpus windows, at Q=64
        reset_launches(cm)
        s_p, i_p = cm.plain_topk_prepared(reps, prep, K, pipeline=True)
        launches["gather_rescore_pipelined"] = read_launches(cm)[
            "gather_rescore_pipelined"]
        if launches["gather_rescore_pipelined"] < 1:
            raise AssertionError("pipeline=True never launched the "
                                 "pipelined rescore kernel")
        same_above_band("pipeline=True vs the default", s_p, i_p, s_k, i_k)
        s_c, i_c = cm.plain_topk_prepared(reps, prep, K, c_split=4)
        same_above_band("c_split=4 vs the default", s_c, i_c, s_k, i_k)
        r6 = rescore_row(cm, "full-scale K6, serving selection", reps,
                         prep.plain, bid, replay, pipeline=True)
        r6d = rescore_row(cm, "full-scale K6, all-distinct selection", reps,
                          prep.plain, distinct_selection(nb, reps.device),
                          replay, pipeline=True)
        search_p = cuda_time_ms(lambda: cm.plain_topk_prepared(
            reps, prep, K, pipeline=True), 2, 10)
        search_c = cuda_time_ms(lambda: cm.plain_topk_prepared(
            reps, prep, K, c_split=4), 2, 10)
        log(f"serve: at Q={MAX_BATCH}: K6 {r6[1]:.4f} ms (plain {r6[2]:.4f}); "
            f"search with pipeline=True {search_p:.4f} ms, with c_split=4 "
            f"{search_c:.4f} ms")
    del searcher, service, prep, g1, l1
    torch.cuda.empty_cache()

    layout_table = serve_layouts(index, reps, s_k, i_k, cm)
    seg_table = serve_segmented(dev, model, tok, index, doc_ids, doc_pos,
                                requests, flat_res, reps, cm, replay)
    del index
    torch.cuda.empty_cache()
    rows = {
        "plain_gmax": (e1, t1, t1p, b1, None),
        "gather_rescore": r3, "gather_rescore_distinct": r3d,
        "gather_rescore_pipelined": r6,
        "gather_rescore_pipelined_distinct": r6d,
        **seg_table["timing"], **layout_table["timing"]}
    launches.update(seg_table["launches"])
    launches.update(layout_table["launches"])
    # the all-distinct rows time the main path's kernels at another selection
    launches["gather_rescore_distinct"] = launches["gather_rescore"]
    launches["gather_rescore_seg_distinct"] = launches["gather_rescore_seg"]
    launches["gather_rescore_pipelined_distinct"] = launches[
        "gather_rescore_pipelined"]
    return rows, launches


def serve_layouts(index, reps, s_k, i_k, cm) -> dict:
    """The alternative layout paths at Q=64, k=1000 over the single-buffer
    index, each run once with every launch count set to 0 just before and
    read just after; then each of their kernels against its plain version
    at the shapes the paths gave it, with each kernel's bound, K8's
    library call (one torch.mm) and the two-call gmax (torch.mm, then
    amax) as context. Returns the layout kernels' launches and (err, ms,
    plain ms, (bound ms, bound by), library ms)."""
    from openmatch_tpu_torch.ops.mips import _select_groups
    from openmatch_tpu_torch.perf.micro import mm_f32

    prep = cm.prepare_block_corpus(index, with_plain=True)
    if not (prep.cb.data_ptr() == prep.plain.data_ptr() == index.data_ptr()):
        raise AssertionError("the block layout is not a view of the index")
    paths = {
        "block_topk_prepared(rescore='xla')": (
            lambda: cm.block_topk_prepared(reps, prep, K), {"block_gmax"}),
        "block_topk_prepared(rescore='dma')": (
            lambda: cm.block_topk_prepared(reps, prep, K, rescore="dma"),
            {"block_gmax", "gather_rescore"}),
        "block_score_topk_prepared": (
            lambda: cm.block_score_topk_prepared(reps, prep, K),
            {"block_gmax", "scores"}),
        "hier2_search(tile=2048)": (
            lambda: cm.hier2_search(reps, index, K, tile=2048),
            {"score_gmax"}),
        "hier2_rescore(tile=2048)": (
            lambda: cm.hier2_rescore(reps, index, K, tile=2048),
            {"gmax_only"}),
    }
    layout_kernels = ("block_gmax", "scores", "score_gmax", "gmax_only")
    launches = dict.fromkeys(layout_kernels, 0)
    with torch.inference_mode():
        for name, (fn, kernels) in paths.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            reset_launches(cm)
            s, i = fn()
            torch.cuda.synchronize()
            ran = {n for n, v in read_launches(cm).items() if v}
            extra = torch.cuda.max_memory_allocated() - resident
            if ran != kernels:
                raise AssertionError(f"{name} launched {sorted(ran)}, "
                                     f"expected {sorted(kernels)}")
            for n in layout_kernels:
                launches[n] += read_launches(cm)[n]
            same_above_band(f"{name} vs the default", s, i, s_k, i_k)
            del s, i
            if extra >= CORPUS_COPY:
                raise AssertionError(f"{name} allocated {extra / 1e9:.3f} GB "
                                     "beyond the resident index")
            ms = cuda_time_ms(fn, 1, 5)
            log(f"serve: {name} at Q={MAX_BATCH}, k={K}: {ms:.4f} ms, peak "
                f"{extra / 1e9:.3f} GB beyond the resident "
                f"{resident / 1e9:.3f} GB")
        torch.cuda.empty_cache()

        # each kernel vs its plain version at the shapes the paths gave it
        g7 = cm.fused_block_gmax(reps, prep.cb)
        e7 = compare("full-scale K7 block gmax", g7,
                     cm.block_gmax_reference(reps, prep.cb))
        bid = _select_groups(g7, K).to(torch.int32)
        del g7
        compare("full-scale K3 rescore of the K7 selection",
                cm.gather_rescore(reps, prep.plain, bid),
                cm.gather_rescore_reference(reps, prep.plain, bid))
        e8 = compare("full-scale K8 scores", cm.fused_scores(reps, prep.plain),
                     cm.scores_reference(reps, prep.plain))
        torch.cuda.empty_cache()
        s9, g9 = cm.fused_score_gmax(reps, index, 2048)
        rs, rg = cm.score_gmax_reference(reps, index, 2048)
        e9 = max(compare("full-scale K9 scores", s9, rs),
                 compare("full-scale K9 gmax", g9, rg))
        del s9, rs
        torch.cuda.empty_cache()
        g10 = cm.fused_gmax_only(reps, index, 2048)
        e10 = compare("full-scale K10 gmax", g10, rg)
        if not torch.equal(g10, g9):
            raise AssertionError("K10 != K9's maxima over the index")
        del g9, rg, g10
        torch.cuda.empty_cache()
        Q, nb = reps.shape[0], prep.cb.shape[0]
        Np = -(-index.shape[0] // 2048) * 2048
        mm, mm_note = mm_f32(reps.device)
        lib8 = kernel_ms(lambda: mm(reps, prep.plain))
        two_call = cuda_time_ms(lambda: mm(reps, prep.plain).view(
            Q, nb, 8).amax(-1))
        log(f"serve: library yardsticks at Q={Q}, N={nb * 8}: one torch.mm "
            f"({mm_note}) {lib8:.4f} ms; two calls, torch.mm then amax over "
            f"8 columns, {two_call:.4f} ms")
        torch.cuda.empty_cache()
        t = {
            "block_gmax": (e7, kernel_ms(lambda: cm.fused_block_gmax(
                reps, prep.cb)), cuda_time_ms(lambda: cm.block_gmax_reference(
                    reps, prep.cb), 1, 2),
                gmax_bound(reps, prep.cb.numel(), Q * nb), None),
            "scores": (e8, kernel_ms(lambda: cm.fused_scores(
                reps, prep.plain)), cuda_time_ms(lambda: cm.scores_reference(
                    reps, prep.plain), 1, 2),
                gmax_bound(reps, prep.plain.numel(), Q * nb * 8), lib8),
            "score_gmax": (e9, kernel_ms(lambda: cm.fused_score_gmax(
                reps, index, 2048)), cuda_time_ms(
                    lambda: cm.score_gmax_reference(reps, index, 2048), 1, 2),
                gmax_bound(reps, index.numel(), Q * (Np + Np // 8)), None),
            "gmax_only": (e10, kernel_ms(lambda: cm.fused_gmax_only(
                reps, index, 2048)), cuda_time_ms(
                    lambda: cm.gmax_only_reference(reps, index, 2048), 1, 2),
                gmax_bound(reps, index.numel(), Q * Np // 8), None),
        }
        log(f"serve: layout kernels at Q={MAX_BATCH}, N={index.shape[0]}: "
            + ", ".join(f"{n} {ms:.4f} ms (plain {p:.4f}, bound {b[0]:.4f})"
                        for n, (_, ms, p, b, _) in t.items()))
    del prep
    torch.cuda.empty_cache()
    return {"launches": launches, "timing": t}


def serve_segmented(dev, model, tok, index, doc_ids, doc_pos, requests,
                    flat_res, reps, cm, replay: list) -> dict:
    """The same index as N_SEGS separately allocated segments behind a
    Searcher(n_segs) and its own RetrievalService, driven by the same
    requests; returns the segment kernels' launches and (err, ms, plain
    ms, (bound ms, bound by), library ms). K5's selections join
    ``replay``."""
    from openmatch_tpu_torch.drivers.serve import RetrievalService
    from openmatch_tpu_torch.ops.mips import Searcher, _select_groups

    n_docs = index.shape[0]
    t0 = time.perf_counter()
    searcher = Searcher(index, k=K, n_segs=N_SEGS)
    torch.cuda.synchronize()
    segs = searcher._prep.plain
    sizes = [s.untyped_storage().nbytes() for s in segs]
    storages = {s.untyped_storage().data_ptr() for s in segs}
    if len(segs) != N_SEGS or len(storages) != N_SEGS \
            or index.untyped_storage().data_ptr() in storages:
        raise AssertionError(f"{len(segs)} segments in {len(storages)} "
                             "allocations, expected "
                             f"{N_SEGS} separate ones")
    log(f"serve: index rebuilt as {N_SEGS} segments of "
        f"{[s.shape[0] // 8 for s in segs]} blocks, each its own allocation "
        f"({', '.join(f'{b / 1e9:.3f}' for b in sizes)} GB) in "
        f"{time.perf_counter() - t0:.2f} s")
    service = RetrievalService(model, tok, searcher, doc_ids, q_max_len=32,
                               max_batch=MAX_BATCH)
    seg_res, launches = serve_http(service, requests, cm)
    if min(launches["plain_gmax_segs"], launches["gather_rescore_seg"]) < 1 \
            or launches["plain_gmax"] or launches["gather_rescore"]:
        raise AssertionError("the segmented path must run the segment "
                             f"kernels only: {launches}")
    with torch.inference_mode():
        same_above_band("segmented vs single-buffer HTTP answers",
                        *answers_tensor(seg_res, doc_pos, dev),
                        *answers_tensor(flat_res, doc_pos, dev))
        err = audit(reps, index, seg_res, doc_pos)
        log(f"serve: segmented exactness audit vs fp32 top-k passed for "
            f"{len(seg_res)} queries (max abs err {err:.3e})")
        search_ms = cuda_time_ms(lambda: searcher.search(reps), 2, 10)
        g4, l4 = cm.fused_plain_gmax_segs(reps, segs, emit_l1=8)
        r4, rl4 = cm.plain_gmax_segs_reference(reps, segs, emit_l1=8)
        e4 = max(compare("full-scale K4 gmax", g4, r4),
                 compare("full-scale K4 l1", l4, rl4))
        del r4, rl4
        bid = _select_groups(g4, K, l1=l4).to(torch.int32)
        nb = sum(s.shape[0] for s in segs) // 8
        distinct = distinct_selection(nb, reps.device)
        r5 = rescore_row(cm, "full-scale K5, serving selection", reps, segs,
                         bid, replay)
        r5d = rescore_row(cm, "full-scale K5, all-distinct selection", reps,
                          segs, distinct, replay)
        for sel, b in (("serving", bid), ("all-distinct", distinct)):
            if not torch.equal(cm.gather_rescore(reps, segs, b),
                               cm.gather_rescore(reps, index[:nb * 8], b)):
                raise AssertionError(f"K5 over {N_SEGS} segments != K3 over "
                                     f"one buffer at the {sel} selection")
        log(f"serve: K5 over {N_SEGS} segments equals K3 over one buffer bit "
            "for bit at both selections")
        t4 = kernel_ms(lambda: cm.fused_plain_gmax_segs(reps, segs,
                                                        emit_l1=8))
        t4p = cuda_time_ms(lambda: cm.plain_gmax_segs_reference(
            reps, segs, emit_l1=8), 1, 3)
        b4 = gmax_bound(reps, sum(s.numel() for s in segs),
                        MAX_BATCH * (nb + -(-nb // 8)))
        log(f"serve: segmented, at Q={MAX_BATCH}, N={n_docs}: K4 {t4:.4f} ms "
            f"(plain {t4p:.4f}, bound {b4[0]:.4f}), K5 {r5[1]:.4f} ms, whole "
            f"search {search_ms:.4f} ms")
    del searcher, service, segs, g4, l4
    torch.cuda.empty_cache()
    return {"launches": {k: launches[k] for k in ("plain_gmax_segs",
                                                  "gather_rescore_seg")},
            "timing": {"plain_gmax_segs": (e4, t4, t4p, b4, None),
                       "gather_rescore_seg": r5,
                       "gather_rescore_seg_distinct": r5d}}


# score_path_phases phase / micro mode -> the kernels it must launch (by
# kernel-table name), and no other
SPP_KERNELS = {
    "a1": {"block_gmax"}, "a2": {"scores"}, "a3": {"plain_gmax"},
    "a3l1": {"plain_gmax"}, "a3base": {"gmax_phase"},
    "a3notr": {"gmax_phase"}, "a3mxutr": {"gmax_phase"},
    "a3nomax": {"gmax_phase"}, "a3tile": {"plain_gmax"}, "sel": set(),
    "sell1": set(), "cand": set(), "resc": {"gather_rescore_pipelined"},
    "resc0": {"gather_rescore"}, "plain": {"plain_gmax", "gather_rescore"},
    "rescseg": {"gather_rescore_seg"}, "a3seg": {"plain_gmax_segs"},
}
MICRO_KERNELS = {
    "matmul_f32": set(), "matmul_bf16": set(), "gmax_xla": set(),
    "gmax_pallas": {"gmax_only"}, "score_gmax_pallas": {"score_gmax"},
    "block_gmax": {"block_gmax"}, "scores_kernel": {"scores"},
    "hier2_full": set(), "xla_full_pyramid": set(),
}
PERF_N, PERF_Q = 2_210_456, 512  # score_path_phases.py's defaults


def trace_k11(cm, q, plain, profiling):
    """One K11 launch under utils.profiling.trace: the Chrome trace must be
    written and parse; logs whether it names the kernel with device time."""
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp) as prof:
            cm.fused_gmax_phase(q, plain, "a3base")
            torch.cuda.synchronize()
        with open(os.path.join(tmp, profiling.TRACE_FILE)) as f:
            events = json.load(f)["traceEvents"]
    kernel_us = [e.get("dur", 0) for e in events
                 if "gmax_phase_kernel" in str(e.get("name", ""))
                 and e.get("cat") == "kernel"]
    avg_us = [getattr(e, "device_time_total", None)
              or getattr(e, "cuda_time_total", 0)
              for e in prof.key_averages() if "gmax_phase_kernel" in e.key]
    log(f"perf: utils.profiling.trace wrote a Chrome trace of {len(events)} "
        f"events; K11 kernel events with device time: {kernel_us} us; "
        f"key_averages device time: {avg_us} us")


def drive(name: str, fn, want: set, cm) -> dict:
    """Run one twin phase or mode with every count set to 0 just before
    and read just after; it must launch exactly ``want``."""
    reset_launches(cm)
    fn()
    torch.cuda.synchronize()
    got = read_launches(cm)
    ran = {n for n, v in got.items() if v}
    if ran != want:
        raise AssertionError(f"perf: {name} launched {sorted(ran)}, expected "
                             f"{sorted(want)}")
    torch.cuda.empty_cache()
    return got


def phase_perf(dev) -> tuple:
    """K11 at the script's default size against its plain versions and
    K2/K8, timed; then every score_path_phases phase and the
    MICRO_KERNELS modes through their main(argv); last, one K11 launch
    traced. Returns K11's
    row (err, ms, plain ms, (bound ms, bound by), library ms) and the
    launches of the perf path's run."""
    from openmatch_tpu_torch.ops import cuda_mips as cm
    from openmatch_tpu_torch.perf import micro, normal
    from openmatch_tpu_torch.perf import score_path_phases as spp
    from openmatch_tpu_torch.utils import profiling

    nbp = -(-(PERF_N // 8) // 256) * 256
    with torch.inference_mode():
        plain = normal((nbp * 8, D), 0, dev)
        q = normal((PERF_Q, D), 1, dev)
        err = check_k11(cm, q, plain, f"Q={PERF_Q} NB={nbp}")
        ms = {p: kernel_ms(lambda: cm.fused_gmax_phase(q, plain, p))
              for p in cm.GMAX_PHASES}
        plain_ms = cuda_time_ms(lambda: cm.gmax_phase_reference(
            q, plain, "a3base"), 1, 3)
        b11 = gmax_bound(q, plain.numel(), PERF_Q * nbp)
        log(f"perf: K11 at Q={PERF_Q}, NB={nbp}: "
            + ", ".join(f"{p} {t:.4f} ms" for p, t in ms.items())
            + f"; plain {plain_ms:.4f} ms; bound {b11[0]:.4f} ms ({b11[1]})")
    launches = dict.fromkeys(read_launches(cm), 0)
    for phase, want in SPP_KERNELS.items():
        got = drive(f"score_path_phases {phase}", lambda: spp.main([phase]),
                    want, cm)
        launches = {n: launches[n] + got[n] for n in launches}
    for mode, want in MICRO_KERNELS.items():
        drive(f"micro {mode}", lambda: micro.main([mode]), want, cm)
    with torch.inference_mode():  # a profiler session last: after the times
        trace_k11(cm, q, plain, profiling)
        del plain, q
    torch.cuda.empty_cache()
    return ({"gmax_phase": (err, ms["a3base"], plain_ms, b11, None)},
            {"gmax_phase": launches["gmax_phase"]})


PHASES = ("device", "build", "kernels", "serve", "perf", "stages")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script "
                         "runs the port on an NVIDIA card only")
    sys.path.insert(0, REPO)
    import openmatch_tpu_torch  # noqa: F401  (fails outside a checkout)

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = phase_device()
    if "build" in phases:
        phase_build()
    if "kernels" in phases:
        phase_kernels(dev)
    rows, launches, replay = {}, {}, []
    if "serve" in phases:
        r, n = phase_serve(dev, replay)
        rows.update(r)
        launches.update(n)
    if "perf" in phases:
        r, n = phase_perf(dev)
        rows.update(r)
        launches.update(n)
    if "stages" in phases and replay:
        phase_stages(dev, replay)
    if rows:
        print(json.dumps({"kernels": [
            {"name": name, "route": "cuda", "source": src, "replaces": rep,
             "launches": launches[name], "max_abs_err": rows[name][0],
             "ms": rows[name][1], "plain_ms": rows[name][2],
             "bound_ms": rows[name][3][0], "bound_by": rows[name][3][1],
             "library_ms": rows[name][4]}
            for name, (src, rep) in KERNELS.items() if name in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["name"],
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
