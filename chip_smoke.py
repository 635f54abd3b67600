#!/usr/bin/env python3
"""Drive the PyTorch port's retrieval, training, rerank, ANCE, BEIR, v1
reranking and research-recipe paths and its perf-script twins on one card,
and its multi-rank paths as two ranks on it.

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
            median times; K2's bound at each Q from the run's inputs.
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
            exactly the kernels it names; then the search twins, each
            through its main(argv) with the same check: perf/corpus_scale
            over 8,841,823 docs at Q=128, k=1000 (K1, K3; its fp32 audit
            must pass), perf/qbatch_sweep over them at Q = 64, 128, 256
            (K1, K3), each perf/rescore_compare path over 2,210,456 docs at
            Q=128 (xla: K7; dma: K7, K3; plain: K1, K3; pipelined: K1, K6;
            the four answers equal above the tie band) and
            perf/selection_micro's topk, gather and idfix at W = 1,105,228
            (no kernel); last, one K11 launch under utils.profiling.trace,
            whose Chrome trace must be written and parse.
6. stages   after every timing (a profiler session can slow the host's
            later launches), the rescore's device time by stage
            (torch.profiler) for K3, K5 and K6 at the selections the serve
            phase timed, replayed over seeded rows of the index's shape
            (the stages' work depends on the block ids, not the values);
            K6 must show as exactly one device kernel per call and no
            memset.
7. train    the training chain through the drivers' main functions, on
            inputs written from a seeded generator into a temporary
            directory: a raw HuggingFace-layout BERT-base checkpoint
            (config.json, pytorch_model.bin; dropout 0.1), 32,768
            pre-tokenized passages of 128 tokens, 512 training queries of
            32 tokens (each a sample of its positive's tokens, with 7
            negatives) and 256 dev queries with qrels. train_dr (mean
            pooling, bf16 compute, 8 queries x 8 passages a step, 30
            steps, checkpoints at 15 and 30) must log finite losses; its median step time,
            tokens/s and peak memory are printed. The saved model must
            load (DRModel.load, the port's own msgpack codec) and encode
            bit-equal to the trainer's. At BERT-base width in fp32, a
            GradCache step (4 query x 8 passage chunks) must give the
            plain step's loss and gradients (GC_REL), both timed, and 20
            steps on one batch must lower the loss. Then build_index (4
            shards), retrieve at depth 100 (K1 and K3 must launch),
            successive_retrieve (equal to retrieve above the tie band) and
            evaluate (MRR@10), which must equal an fp32 audit over the
            saved shards, ranks read with the serve audit's tie band.
            Last, three train_steps under torch.profiler: device time by
            kernel and the device-busy share of the host's time.
8. rerank   the rerank stage through the drivers' main functions, on the
            train phase's kind of data (its own seeded temporary
            directory): a raw HF-layout T5-base checkpoint (12 + 12 layers,
            768 wide, relu, tied; weights at HF's initial scales) builds
            the index (build_index, t5_encdec: decoder step 0's hidden
            state) and retrieve at depth 100 must launch K1 and K3;
            train_rr trains a BERT-base cross-encoder (bce, bf16, mean
            pooling, 8 positive + 8 negative pairs a step, 20 steps;
            median step time, pairs/s and peak memory printed) whose
            saved model must
            score bit-equal; rerank re-scores the top 20 of the T5 run with
            it and with monoT5-base (--pos_token true --neg_token false),
            evaluate gives each MRR@10, and each bf16 score must lie within
            2e-2 x max|score| of the same model's fp32 score on the card,
            each query's reciprocal rank being one the fp32 scores allow
            within a tie band; pairs/s of each model at S=128 and S=256;
            last, a rerank-only server answers 8 concurrent POST /rerank
            requests of 50 docs, equal to Reranker's scores within 1e-3 x
            max|score|.
9. ance     the hard-negative refresh, both modes, on a seeded raw HF
            BERT-base (mean pooling, bf16): perf/ance_cycle.py's main at
            its defaults (100,000 docs of 128 tokens, 1,000 queries of 32,
            50 steps of 8 x 8 a generation, two generations, encode batch
            512, top 200, 20 negatives) through run_ance_alternating and
            the port's DRTrainer, with its per-phase table; K1 and K3 must
            launch in the refresh, every loss be finite, every mined
            negative be a non-positive inside the fp32 audit's top 200
            widened by the tie band, the refresh leave its index freed, and
            the published file load through DRTrainDataset and QPCollator.
            Then run_ance_generator (one generation) from the cycle's saved
            checkpoint over 32,768 passages and 256 dev queries with qrels:
            K1 and K3 must launch, it must publish generation 1 in the same
            ann_dir, and its ann_ndcg_1 must hold the checkpoint and an
            ndcg_cut_10 equal to the fp32 audit's (ranks read with the tie
            band).
10. beir    drivers/retrieve_beir.py's main on a seeded BERT-base over a
            BEIR directory at FiQA-2018's test counts (57,638 docs, 6,648
            queries of which the 648 in the 1,706 test qrels are kept; one
            title in about 20 empty): K1 and K3 must launch, the TREC run
            parse, and ndcg_cut_10 and recall_100 equal the fp32 audit's
            (ranks read with the tie band); encode passages/s is printed.
11. v1      the v1 pipeline through the drivers' main functions, on seeded
            data in its own temporary directory: a 400,000-word vocabulary
            (with -embed_dim 300, GloVe 6B-300d's table shape), 100,000
            passages of 20-199 Zipf-drawn words, 1,000 train and 200 dev
            queries of 5-15 words of a positive, 10,000 entities with
            20-word descriptions. bm25_retrieve (native, g++-built into
            build/native; k1 0.9, b 0.4, top 100 for all 1,200 queries)
            with 20 queries audited against a numpy BM25 (1e-4 relative);
            train_v1 on triples from its run (the positive, two
            non-positives of its top 100; triplet_loss, batch 8): KNRM,
            Conv-KNRM, TK and EDRM for 200 steps at lr 1e-3 (query 10,
            doc 256 words), BertRanker (32 + 221 tokens, fp32, 20 steps)
            and BertMaxP (4 passages of 32 + 61 tokens, 10 steps) on a
            seeded HF BERT-base, every logged loss finite; inference_v1
            reranks the dev run from each saved train_state.msgpack (top
            100; BertRanker top 20; BertMaxP top 10 of 100 queries), whose
            first batch must score bit-equal to the trainer's live module,
            and each model is scored on the card and on the CPU by the same
            weights (word models 256 pairs within 1e-4 x max|score|, KNRM's
            21 kernel features too, also with TF32 allowed; BERT models 32
            and 16 pairs within 1e-3); gen_feature for KNRM and BertRanker
            (top 20), each file parsed by load_feature_file; coor_ascent
            (k=2) on KNRM's features, ranksvm on KNRM's and BertRanker's;
            evaluate gives MRR@10 and ndcg_cut_10 of every run. Step ms,
            pairs/s, peaks, BM25's index and query times are printed. It
            launches no hand-written kernel.
12. research the research recipes through their entry points, fp32 at
            full width (seeded T5-base and BERT-base): a sentence-
            transformers GTR directory (T5-base encoder, 2_Dense 768 ->
            768) converted by scripts/gtr/convert_gtr_ckpt.py's twin,
            1,024 passages encoded (norms 1 within 1e-5; 8 within 1e-4 x
            max|rep| of the CPU), then scale_t5_weights' twin (every
            scaled tensor the original / 100 or / 10 bit for bit); a seed
            QG (from an HF T5-base dir) and a ContrastQG model (seeded)
            each trained 20 steps on one repeated batch of 16 x 256 -> 32
            (the loss finite and falling); qg_synthesis.run_pipeline over
            4,096 passages (max_docs 256, BM25 top 100, negatives from
            ranks 50-100, batch 16, 24 new tokens, greedy): every jsonl
            row has a query, a positive and a negative, and 16 rows' greedy
            tokens, teacher-forced through a CPU copy, lie within 1e-4 x
            max|logit| of their row's maximum; seed-QG docs/s and
            ContrastQG pairs/s; train_dr takes 5 BERT-base steps on the
            synthetic file; train_mlm 20 steps of 32 x 256 (finite losses;
            the exported DRModel reloads and encodes 8 passages bit-equal
            to the trained encoder); meta_train -model knrm (-embed_dim
            300) and -model bert, 10 steps of 8 + 8 pairs (weights >= 0,
            summing to 1, 0, or under 1 below the normaliser's 1e-8
            floor; KNRM's step-2 weights, the first at a virtual lr > 0,
            within 1e-4 of the CPU's from the same state); train_v1
            -reinfoselect -model knrm (Conv-KNRM policy) and -model bert,
            20 steps, eval every 5: keep rates in [0, 1], the policy moves
            at every refresh from the first nonzero reward on, the best
            checkpoint reloads and scores. Step times and peaks are
            printed. It launches no hand-written kernel.
13. twins   the training, rerank and pipeline perf twins through their
            main(argv), each launching no hand-written kernel in this
            process: perf/train_bench at 8 x 8 in bf16 for BERT-base DR,
            GradCache, T5-base t5_encdec, the BERT-base (bce) and
            monoT5-base (ce) cross-encoders (finite losses); perf/
            rerank_bench for BERT-base and monoT5-base at 128 pairs of 192
            (finite scores); each with its step or batch time, rates and
            peak; perf/pipeline_e2e at its defaults (100,000 docs, 512
            queries, depth 100, a BERT-base HF checkpoint it writes, each of
            build_index, retrieve and evaluate its own process): MRR@10
            above 0.99 (functional_pass) and the retrieve stage's K1 and K3
            launches, which the kernel table adds.
14. mesh    the multi-rank paths over torch.distributed: first, in this
            process, the one-process references (BERT-base fp32 with TF32
            off, seeded weights, mean pooling: 3 DRTrainer steps over a
            global batch of 8 queries x 4 passages, and the mean of its
            two halves' losses; a single-buffer Searcher over the seeded
            8,841,823 x 768 bf16 index at Q=64, k=1000; one-process
            Reranker scores of 2,048 pairs at S=128; perf/ance_cycle over
            16,384 docs with each step the mean of the two half batches'
            losses, as dp=2 computes it), the kernels built, every buffer
            freed; then 2 ranks (parallel/mesh.spawn_ranks:
            gloo when they share the card, the collectives through host
            memory; NCCL with a card each). Each rank trains in 4 modes,
            local negatives (dp=2), global negatives (dp=2), GradCache with
            global negatives (dp=2) and tp=2 with global negatives: the
            losses and every parameter within 1e-5 x max|value| of one
            process, and the parameters bit-identical across ranks. Then
            train_dr's main on both ranks (2 steps, each rank its data
            shard; rank 0's saved model, loaded again, encodes bit-equal to
            the trained one); the docs partition from each rank's own rows
            (4.42M of them, 6.32 GiB a rank) and the queries partition with
            2 segments (the whole 12.65 GiB a rank), each search's K1/K3
            (docs) or K4/K5 (queries) launches counted with the counts set
            to 0 just before and read just after, its ids equal to one
            process above the tie band; each rank's K1, K3, K4 and K5 held
            to their plain versions on the search's own operands. Each
            partition's Searcher is then served over the ranks as
            serve.main serves it: rank 0 a RetrievalService (the
            BERT-base query encoder, max_batch 64, the ControlChannel)
            behind the HTTP front answers 8 concurrent /search requests
            of 8 queries at k=1000 while rank 1 follows; the launches of
            both ranks are counted, the answers equal one process's above
            the tie band. serve.main itself runs on both ranks through its
            flags over a 16,384-row encoded index (queries partition, 2
            segments), answers one /search and stops on SIGTERM. Then
            Reranker(mesh=) over the 2,048 pairs within 1e-5 x max|score|
            of one process, and the v1 family at dp=2 against one process:
            V1Trainer with KNRM (400,001 x 300 embeddings, 16 pairs of 10
            and 256 words) and with BertRanker (BERT-base fp32, 8 pairs of
            128), MetaLTRTrainer and ReInfoSelectTrainer (a Conv-KNRM
            policy, one refresh) on KNRM, 3 steps each: losses within
            1e-5, parameters within rtol = atol = 1e-5, meta weights
            within 1e-4, keep decisions equal, parameters bit-identical on
            both ranks. Then ANCE's alternating cycle over the ranks
            (perf/ance_cycle's main on each: BERT-base fp32, mean pooling,
            16,384 docs of 128 tokens, 256 queries of 32, 2 generations of
            3 steps of a global 8 x 8 batch, top 200, 20 negatives; each
            rank its rows through DRTrainer(mesh=), the refresh through
            the docs-partitioned Retriever(mesh=), write_ann_data(mesh=)):
            the parameters bit-identical across ranks after each
            generation, generation 0's losses within 1e-5 of one process,
            ann_training_data_0 published once with no .tmp left and the
            same SHA-256 on both ranks, every mined negative inside the
            fp32 audit's top 200 plus the tie band, and the refresh's
            search launching the gmax kernel (K1, or K2 where a shard is
            too small for a pyramid level; which is printed) and K3 on each
            rank. With four cards a dp=2 x tp=2 world trains as
            well. Last, in this process, the mesh paths' perf twins:
            perf/mesh_parity at its defaults, perf/sharded_merge over 2
            ranks and perf/serve_load for 5 s over 1,000,000 docs. Step
            ms, search ms (CUDA events), request ms, pairs/s, peaks and
            the phase's wall time are printed beside the card and the
            backend.

15. graphs  the inference encode as a CUDA graph (models/graphs) against
            the same encode run eagerly, at the serving shapes with seeded
            weights (seeded_state) and ragged masks, in inference mode:
            the BERT-base query tower at [64, 32] and the T5-base
            t5_encdec passage tower at [128, 128], three batches each.
            Each batch's largest gap over the largest |rep| is printed
            beside its limit (0: the same kernels on the same operands),
            with the capture, replay and eager counts, the ms a call of
            each path (host clock to a synchronise, median of 20) and the
            host's ms to the call's return, the graph's also
            under torch.profiler, whose CUDA tracing slows a replay's
            launch;
            T5's tied head scaled by its host scalar must give the bits
            it gave scaled by the old on-card bf16 scalar.
16. moe     the grouped expert GEMM (ops/csrc/grouped_gemm.cu): ptxas's
            registers and stack frame for each of its kernels (the phase
            fails on a stack frame or a spill); then the kernel against
            its plain version at the Moonlight encode cell's shapes (64 x
            512 x 6 slot rows, 13,400 x 6 of them routed over 64 experts,
            with a router's skew and uniformly; the gate-and-up product
            [64, 2816, 2048] and the down product [64, 2048, 1408]), each
            with its time beside its bound and torch._grouped_mm's
            (library_ms) where the card's torch has it (the kernel
            table's K12 row is the gate-and-up product under the skew);
            then a DeepSeek-V3 tower at published widths with one dense
            and one MoE layer (bf16, seeded weights) encoding [64, 512]
            ragged batches as a CUDA graph against eager, bit for bit,
            its expert counter zeroed in place and exact after one
            replay.

Each phase logs what was allocated on the card at its start, its peak,
what it left allocated, which must be under 1 GiB, and its wall time. The
kernel table's launches of K1 and K3 include the train, rerank, ance and
beir phases' searches and the twins phase's retrieve stage, those of K1,
K3, K6 and K7 the perf phase's search twins, and those of K1, K3, K4 and
K5 the mesh phase's ranks' searches (the ANCE refresh's K3, and its K1
where a shard takes a pyramid level).

The second-to-last line is the kernel table as one JSON object (``ms``
and ``library_ms`` are device time, each timed call queued behind an
untimed one; ``plain_ms`` brackets the plain version's call with one CUDA
event pair), the last line {"ok": true, "device": {...}}. It needs CUDA: without a card it
raises before printing any result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
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
    # K12 replaces no TPU kernel
    "grouped_gemm": (CSRC + "grouped_gemm.cu", None),
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
        b2 = gmax_bound(q, prep.plain.numel(), Q * NB)
        log(f"  K2 Q={Q} N={N}: bound {b2[0]:.4f} ms ({b2[1]}), the kernel "
            f"at {b2[0] / t['K2'][0]:.0%} of it")
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
    """Hashes whitespace-separated words into the vocab: [CLS] word ids
    [SEP] (pairs: [CLS] a [SEP] b [SEP], segments 0 then 1, truncated
    longest-first), pad id 0 (the card's machine has no ``transformers``).
    Every word is one id, so monoT5's ``true`` and ``false`` are single
    tokens."""

    pad_token_id = 0
    cls_token_id = 101
    sep_token_id = 102

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def _words(self, text: str) -> list:
        import zlib

        return [1000 + zlib.crc32(w.encode()) % (self.vocab_size - 1000)
                for w in text.split()]

    def encode(self, text, add_special_tokens: bool = True) -> list:
        ids = self._words(text)
        return self.build_inputs_with_special_tokens(ids) \
            if add_special_tokens else ids

    def encode_plus(self, text, truncation=None, max_length=None,
                    padding=False, return_attention_mask=False,
                    return_token_type_ids=False):
        if isinstance(text, tuple):
            a, b = (self._words(t) for t in text)
            while max_length is not None and len(a) + len(b) > max_length - 3:
                (a if len(a) >= len(b) else b).pop()
            out = {"input_ids": self.build_inputs_with_special_tokens(a, b)}
            if return_token_type_ids:
                out["token_type_ids"] = \
                    self.create_token_type_ids_from_sequences(a, b)
            return out
        ids = self._words(text)
        if max_length is not None:
            ids = ids[:max_length - 2]
        return {"input_ids": self.build_inputs_with_special_tokens(ids)}

    def num_special_tokens_to_add(self, pair: bool = False) -> int:
        return 3 if pair else 2

    def build_inputs_with_special_tokens(self, a, b=None):
        out = [self.cls_token_id] + list(a) + [self.sep_token_id]
        return out if b is None else out + list(b) + [self.sep_token_id]

    def create_token_type_ids_from_sequences(self, a, b):
        return [0] * (len(a) + 2) + [1] * (len(b) + 1)


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


def same_above_band(name: str, s_a, i_a, s_b, i_b, phase: str = "serve"):
    """Two top-k answers [Q, K] agree: scores within AUDIT_REL x max|score|,
    and each answer holds every doc the other scores above the k-th score's
    tie band of ``s_b`` (``perf.agree_above_band``)."""
    from openmatch_tpu_torch.perf import agree_above_band

    agree_above_band(name, s_a, i_a, s_b, i_b, AUDIT_REL)
    log(f"{phase}: {name}: equal above the tie band for {s_b.shape[0]} rows")


def serve_http(service, requests) -> tuple:
    """GET /health and the requests as concurrent POST /search over HTTP,
    with every launch count set to 0 just before and read just after.
    Returns (answers, launches)."""
    from openmatch_tpu_torch.drivers.serve import ServingHTTPServer, make_handler
    from openmatch_tpu_torch.ops import _build

    service.warmup()
    service.timeline = []
    server = ServingHTTPServer(("127.0.0.1", 0), make_handler(service, K))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        _build.launches.clear()
        status, health, _ = http_json(base + "/health")
        with ThreadPoolExecutor(max_workers=len(requests)) as pool:
            futures = [pool.submit(http_json, base + "/search",
                                   {"queries": qs, "k": K})
                       for qs in requests]
            answers = [f.result() for f in futures]
        launches = dict(_build.launches)
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
    from openmatch_tpu_torch.ops import _build
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
    flat_res, launches = serve_http(service, requests)
    if min(launches.get("plain_gmax", 0),
           launches.get("gather_rescore", 0)) < 1 \
            or launches.get("plain_gmax_segs") \
            or launches.get("gather_rescore_seg"):
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
        _build.launches.clear()
        s_p, i_p = cm.plain_topk_prepared(reps, prep, K, pipeline=True)
        launches["gather_rescore_pipelined"] = _build.launches[
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
    service.close()  # its worker thread held the searcher and the index
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
    from openmatch_tpu_torch.ops import _build
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
            _build.launches.clear()
            s, i = fn()
            torch.cuda.synchronize()
            ran = set(_build.launches)
            extra = torch.cuda.max_memory_allocated() - resident
            if ran != kernels:
                raise AssertionError(f"{name} launched {sorted(ran)}, "
                                     f"expected {sorted(kernels)}")
            for n in layout_kernels:
                launches[n] += _build.launches[n]
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
    seg_res, launches = serve_http(service, requests)
    if min(launches.get("plain_gmax_segs", 0),
           launches.get("gather_rescore_seg", 0)) < 1 \
            or launches.get("plain_gmax") or launches.get("gather_rescore"):
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
    service.close()
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
# the search twins (perf/corpus_scale, qbatch_sweep, rescore_compare,
# selection_micro) at the TPU scripts' sizes: the kernels each path must
# launch, and no other
SEARCH_KERNELS = {"plain_gmax", "gather_rescore"}
SWEEP_QS = (64, 128, 256)
RESCORE_PATHS = {
    "xla": {"block_gmax"}, "dma": {"block_gmax", "gather_rescore"},
    "plain": {"plain_gmax", "gather_rescore"},
    "pipelined": {"plain_gmax", "gather_rescore_pipelined"},
}
SELECTION_W = N_MSMARCO // 8 + 1  # 1,105,228: the serving index's blocks


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


def drive(name: str, fn, want: set) -> dict:
    """Run one twin phase or mode with every count set to 0 just before
    and read just after; it must launch exactly ``want``."""
    from openmatch_tpu_torch.ops import _build

    _build.launches.clear()
    fn()
    torch.cuda.synchronize()
    got = _build.launches.copy()
    ran = set(got)
    if ran != want:
        raise AssertionError(f"perf: {name} launched {sorted(ran)}, expected "
                             f"{sorted(want)}")
    torch.cuda.empty_cache()
    return got


def search_twins() -> dict:
    """The search twins through their main(argv), each under ``drive``:
    corpus_scale over the 8,841,823-doc corpus at Q=128, k=1000 (its fp32
    audit must pass), qbatch_sweep over the same at SWEEP_QS, each
    rescore_compare path at the script's defaults (2,210,456 docs, Q=128;
    the four answers equal above the tie band) and selection_micro's topk,
    gather and idfix at W = SELECTION_W, Q=128, k=1000. Returns the
    launches, summed."""
    from openmatch_tpu_torch.perf import (corpus_scale, qbatch_sweep,
                                          rescore_compare, selection_micro)

    total = {}

    def run(name, fn, want):
        box = {}
        got = drive(name, lambda: box.update(out=fn()), want)
        for kernel, n in got.items():
            total[kernel] = total.get(kernel, 0) + n
        return box.pop("out")

    out = run("corpus_scale", lambda: corpus_scale.main(
        [str(N_MSMARCO), "128", str(K)]), SEARCH_KERNELS)
    log(f"perf: corpus_scale at N={N_MSMARCO}, Q=128, k={K}: "
        f"{out['ms']:.4f} ms a batch, {out['qps']:.1f} QPS (corpus built in "
        f"{out['build_s']:.2f} s); fp32 audit recall {out['recalls']}, max "
        f"score diff {out['max_score_err']:.3e}")
    out = run("qbatch_sweep", lambda: qbatch_sweep.main(
        [str(N_MSMARCO)] + [str(q) for q in SWEEP_QS]), SEARCH_KERNELS)
    log(f"perf: qbatch_sweep at N={N_MSMARCO}, k={K}: " + "; ".join(
        f"Q={r['Q']} {r['ms']:.4f} ms, {r['qps']:.1f} QPS"
        for r in out["rows"]))
    answers = {}
    for path, want in RESCORE_PATHS.items():
        answers[path] = run(f"rescore_compare {path}",
                            lambda: rescore_compare.main(["--paths", path]),
                            want)["paths"][path]
    first = answers["xla"]
    for path, a in answers.items():
        if path != "xla":
            same_above_band(f"rescore_compare {path} vs xla", a["scores"],
                            a["ids"], first["scores"], first["ids"], "perf")
    log(f"perf: rescore_compare at N={PERF_N}, Q=128, k={K}: " + "; ".join(
        f"{p} {a['ms']:.4f} ms" for p, a in answers.items()))
    for prim in ("topk", "gather", "idfix"):
        out = run(f"selection_micro {prim}", lambda: selection_micro.main(
            [prim, str(SELECTION_W), "128", str(K)]), set())
        log(f"perf: selection_micro {prim} W={out['W']} Q=128 k={K}: "
            f"{out['ms']:.4f} ms")
        del out
    return total


def phase_perf(dev) -> tuple:
    """K11 at the script's default size against its plain versions and
    K2/K8, timed; then every score_path_phases phase and the
    MICRO_KERNELS modes through their main(argv), then the search twins
    (``search_twins``); last, one K11 launch traced. Returns K11's row
    (err, ms, plain ms, (bound ms, bound by), library ms) and the launches
    of the perf path's run: K11's, and every kernel's in the search
    twins."""
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
    k11 = 0
    for phase, want in SPP_KERNELS.items():
        k11 += drive(f"score_path_phases {phase}", lambda: spp.main([phase]),
                     want)["gmax_phase"]
    for mode, want in MICRO_KERNELS.items():
        drive(f"micro {mode}", lambda: micro.main([mode]), want)
    twins = search_twins()
    twins["gmax_phase"] = twins.get("gmax_phase", 0) + k11
    with torch.inference_mode():  # a profiler session last: after the times
        trace_k11(cm, q, plain, profiling)
        del plain, q
    torch.cuda.empty_cache()
    return ({"gmax_phase": (err, ms["a3base"], plain_ms, b11, None)},
            {k: n for k, n in twins.items() if n})



# ---- twins: the training, rerank and pipeline perf twins -------------------

TRAIN_BENCH_RUNS = ([], ["--grad-cache"], ["--t5"], ["--rr"], ["--rr", "--t5"])


def phase_twins(dev) -> dict:
    """perf/train_bench (BERT-base DR, GradCache, T5-base t5_encdec, the
    BERT-base and monoT5-base cross-encoders; 8 x 8, bf16), perf/rerank_bench
    (BERT-base and monoT5-base, 128 pairs of 192) and perf/pipeline_e2e at
    its defaults (100,000 docs, 512 queries, depth 100, each driver stage
    its own process) through their main(argv), each under ``drive`` (this
    process launches no hand-written kernel): finite losses and scores,
    each run's line and peak; pipeline_e2e's MRR@10 above 0.99
    (functional_pass) and its retrieve stage's K1 and K3 launches, which
    are returned."""
    from openmatch_tpu_torch.perf import (pipeline_e2e, rerank_bench,
                                          train_bench)

    def run(name, fn):
        box = {}
        torch.cuda.reset_peak_memory_stats()
        drive(name, lambda: box.update(out=fn()), set())
        return box.pop("out"), torch.cuda.max_memory_allocated() / 2**30

    for flags in TRAIN_BENCH_RUNS:
        out, peak = run(f"train_bench {' '.join(flags)}",
                        lambda: train_bench.main(["8", "8"] + flags))
        if not np.isfinite([out["first_loss"], out["last_loss"]]).all():
            raise AssertionError(f"twins: train_bench {flags}: {out}")
        log(f"twins: train_bench {out['tag']} (8 x 8, bf16): "
            f"{out['ms']:.2f} ms a step, {out['queries_s']:.1f} queries/s, "
            f"{out['units_s']:.1f} {out['unit']}/s; loss "
            f"{out['first_loss']:.4f} -> {out['last_loss']:.4f}; peak "
            f"{peak:.2f} GiB")
        gc.collect()
    for kind in ("bert", "monot5"):
        out, peak = run(f"rerank_bench {kind}",
                        lambda: rerank_bench.main([kind, "128", "192"]))
        if not torch.isfinite(out["scores"]).all():
            raise AssertionError(f"twins: rerank_bench {kind} scores")
        log(f"twins: rerank_bench {kind} (128 pairs at S=192, bf16): "
            f"{out['ms']:.3f} ms a batch, {out['pairs_s']:.1f} pairs/s "
            f"(depth 100: {out['queries_s_100']:.2f} queries/s, depth "
            f"1000: {out['queries_s_1000']:.3f}); peak {peak:.2f} GiB")
        gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        out, _ = run("pipeline_e2e", lambda: pipeline_e2e.main(
            ["--workdir", root]))
    got = out["retrieve_launches"] or {}
    if not out["functional_pass"] or got.get("plain_gmax", 0) < 1 \
            or got.get("gather_rescore", 0) < 1:
        raise AssertionError(f"twins: pipeline_e2e {out}")
    log(f"twins: pipeline_e2e (100,000 docs, 512 queries, depth 100, "
        f"BERT-base bf16): seconds by stage "
        + ", ".join(f"{k} {v:.2f}" for k, v in out["stage_s"].items())
        + f", total {out['total_s']:.2f}; MRR@10 {out['mrr_cut_10']} "
        f"(functional_pass); the retrieve stage launched {got}")
    return {k: got[k] for k in ("plain_gmax", "gather_rescore")}


# ---- train: the training chain through the drivers ------------------------

TRAIN_PASSAGES, TRAIN_QUERIES, DEV_QUERIES = 32_768, 512, 256
Q_LEN, P_LEN, N_PSG, TRAIN_BATCH = 32, 128, 8, 8
TRAIN_LR = 1e-5
GC_REL = 1e-2  # GradCache vs plain in fp32: |gc - plain| <= GC_REL x max|plain|
# per gradient tensor: the same sums in another order, which cancel where
# random-init reps are alike; a chunk replayed wrongly is off by O(1)
GC_LOSS_REL = 1e-4  # the loss: a logsumexp over scores of ~|700| at this
# init, each summed over 768 products in another order


def hf_bert_base(rng: np.random.Generator, cfg, path: str):
    """A raw HuggingFace-layout BERT-base checkpoint from seeded weights:
    config.json and pytorch_model.bin under HF's key names (dropout 0.1;
    perf/pipeline_e2e's ``write_hf_bert``)."""
    from openmatch_tpu_torch.perf.pipeline_e2e import write_hf_bert

    write_hf_bert(rng, cfg, path)


def write_train_data(rng: np.random.Generator, vocab: int, root: str):
    """Pre-tokenized corpus, train.jsonl, dev queries and qrels: each query
    is a sample of its positive passage's tokens."""
    body = P_LEN - 2
    corpus = rng.integers(1000, vocab, (TRAIN_PASSAGES, body))
    picks = rng.permutation(TRAIN_PASSAGES)[:TRAIN_QUERIES + DEV_QUERIES]

    def query(pos):
        cols = rng.choice(body, Q_LEN - 2, replace=False)
        return corpus[pos, np.sort(cols)].tolist()

    with open(os.path.join(root, "corpus.jsonl"), "w") as f:
        for i, row in enumerate(corpus):
            f.write(json.dumps({"id": f"d{i}", "text": row.tolist()}) + "\n")
    with open(os.path.join(root, "train.jsonl"), "w") as f:
        for pos in picks[:TRAIN_QUERIES]:
            negs = rng.integers(0, TRAIN_PASSAGES, N_PSG - 1)
            f.write(json.dumps({
                "query": query(pos), "positives": [corpus[pos].tolist()],
                "negatives": [corpus[j].tolist() for j in negs]}) + "\n")
    with open(os.path.join(root, "dev.jsonl"), "w") as f, \
            open(os.path.join(root, "dev.qrels"), "w") as g:
        for i, pos in enumerate(picks[TRAIN_QUERIES:]):
            f.write(json.dumps({"id": f"q{i}", "text": query(pos)}) + "\n")
            g.write(f"q{i} 0 d{pos} 1\n")


def fixed_batch(root: str, tok, rows: int = TRAIN_BATCH) -> dict:
    """The first ``rows`` training examples, collated as the driver does."""
    from openmatch_tpu_torch.config import DataArguments
    from openmatch_tpu_torch.data.collators import QPCollator
    from openmatch_tpu_torch.data.train_dataset import DRTrainDataset

    ds = DRTrainDataset(tok, DataArguments(
        train_path=os.path.join(root, "train.jsonl"), q_max_len=Q_LEN,
        p_max_len=P_LEN, train_n_passages=N_PSG))
    it = ds.epoch_iterator(0, None)
    return QPCollator(0, Q_LEN, P_LEN)([next(it) for _ in range(rows)])


def step_ms(trainer, batch, reps: int = 3) -> float:
    """Median host time of ``trainer.train_step`` ending in a sync, ms."""
    times = []
    for _ in range(reps + 1):
        sync(trainer.device)
        t0 = time.perf_counter()
        trainer.train_step(batch)
        sync(trainer.device)
        times.append((time.perf_counter() - t0) * 1000)
    return float(np.median(times[1:]))


def check_grad_cache(dev, model_fp32, batch) -> None:
    """At BERT-base width in fp32 (dropout off): a GradCache step with 4
    query chunks and 8 passage chunks gives the plain step's loss and
    gradients; both steps are timed."""
    from openmatch_tpu_torch.config import TrainingArguments
    from openmatch_tpu_torch.train.dr_trainer import DRTrainer

    args = dict(learning_rate=1e-5, warmup_steps=0, warmup_ratio=0.0,
                per_device_train_batch_size=TRAIN_BATCH)
    plain = DRTrainer(model_fp32, TrainingArguments(**args), 100, dev)
    gc = DRTrainer(model_fp32, TrainingArguments(
        grad_cache=True, gc_q_chunk_size=TRAIN_BATCH // 4,
        gc_p_chunk_size=TRAIN_BATCH * N_PSG // 8, **args), 100, dev)
    loss_p = plain.loss_and_grads(batch).item()
    grads = {n: p.grad.clone() for n, p in model_fp32.named_parameters()
             if p.grad is not None}
    loss_g = gc.loss_and_grads(batch).item()
    worst = 0.0
    for n, p in model_fp32.named_parameters():
        if n not in grads:
            continue
        scale = grads[n].abs().max().item()
        err = (p.grad - grads[n]).abs().max().item()
        worst = max(worst, err / max(scale, 1e-30))
        if not err <= GC_REL * scale:
            raise AssertionError(f"train: GradCache gradient of {n} off by "
                                 f"{err} > {GC_REL} x {scale}")
    if not abs(loss_g - loss_p) <= GC_LOSS_REL * abs(loss_p):
        raise AssertionError(f"train: GradCache loss {loss_g} != plain "
                             f"{loss_p}")
    model_fp32.zero_grad(set_to_none=True)
    log(f"train: GradCache (4 query x 8 passage chunks) vs plain at "
        f"BERT-base fp32: loss {loss_g!r} vs {loss_p!r} (tolerance "
        f"{GC_LOSS_REL} relative); worst gradient tensor max|diff| / "
        f"max|plain| {worst:.3e} (tolerance {GC_REL})")
    log(f"train: fp32 step time, {TRAIN_BATCH} queries x {N_PSG} passages: "
        f"plain {step_ms(plain, batch):.2f} ms, GradCache "
        f"{step_ms(gc, batch):.2f} ms")


def check_learns(dev, model_fp32, batch) -> None:
    """20 train_steps on one fixed batch (warmup 0): the loss must fall."""
    from openmatch_tpu_torch.config import TrainingArguments
    from openmatch_tpu_torch.train.dr_trainer import DRTrainer

    trainer = DRTrainer(model_fp32, TrainingArguments(
        learning_rate=1e-4, warmup_steps=0, warmup_ratio=0.0), 20, dev)
    losses = [trainer.train_step(batch).item() for _ in range(20)]
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"train: overfitting one batch did not lower "
                             f"the loss: {losses}")
    log(f"train: 20 steps on one batch: loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}")


def run_ranks(path: str, doc_pos, dev) -> tuple:
    """A TREC run -> (qids, scores [Q, K], doc positions [Q, K]) on
    ``dev``, rows in the run's score order."""
    from openmatch_tpu_torch.utils.trec import load_from_trec

    run = load_from_trec(path)
    qids = sorted(run, key=lambda q: int(q[1:]))
    rows = [sorted(run[q].items(), key=lambda x: -x[1]) for q in qids]
    s = torch.tensor([[v for _, v in r] for r in rows], device=dev)
    i = torch.tensor([[doc_pos[d] for d, _ in r] for r in rows], device=dev)
    return qids, s, i


def audit_mrr(dev, root, ckpt, emb_dir, tok, mrr, per_query) -> None:
    """MRR@10 from fp32 scores of the re-encoded dev queries against every
    saved passage (as the index holds them, in bf16): each query's
    reciprocal rank must be the one evaluate gave it, where the relevant
    doc's rank is read off with the audit's tie band (AUDIT_REL x
    max|score|): docs within the band of its score may rank either side.
    The mean, summed in evaluate's order, must equal evaluate's figure."""
    from openmatch_tpu_torch.config import DataArguments
    from openmatch_tpu_torch.data.inference_dataset import InferenceDataset
    from openmatch_tpu_torch.models.dr_model import DRModel
    from openmatch_tpu_torch.retriever.encoder import (encode_dataset,
                                                       list_shards,
                                                       load_embeddings)

    embs, ids = [], []
    for path in list_shards(emb_dir, "corpus"):
        e, i = load_embeddings(path)
        embs.append(e)
        ids.extend(i)
    pos_of = {d: i for i, d in enumerate(ids)}
    index = torch.from_numpy(np.concatenate(embs)).to(torch.bfloat16).to(dev)
    model = DRModel.load(ckpt, dtype="bfloat16", device=dev)
    queries = InferenceDataset.load(tok, DataArguments(
        query_path=os.path.join(root, "dev.jsonl"), q_max_len=Q_LEN),
        is_query=True)
    q_emb, q_ids = encode_dataset(model, queries, 256, Q_LEN, 0,
                                  is_query=True, device=dev)
    q = torch.from_numpy(q_emb).to(torch.bfloat16).to(dev)
    qrels = {}
    with open(os.path.join(root, "dev.qrels")) as f:
        for line in f:
            qid, _, doc, _ = line.split()
            qrels[qid] = doc
    if q_ids != [x for x in per_query if x != "all"]:
        raise AssertionError("train: the run's queries are not the dev set")
    pos = torch.tensor([pos_of[qrels[x]] for x in q_ids], device=dev)
    scores = q.float() @ index.float().T
    exact = scores.gather(1, pos[:, None])[:, 0]
    tol = AUDIT_REL * scores.abs().amax(1)
    best = (scores > (exact + tol)[:, None]).sum(1) + 1
    worst = (scores >= (exact - tol)[:, None]).sum(1)
    banded, total = 0, 0.0
    for r, qid in enumerate(q_ids):
        lo, hi = int(best[r]), int(worst[r])
        allowed = {1.0 / k if k <= 10 else 0.0 for k in range(lo, hi + 1)}
        banded += lo != hi
        if per_query[qid] not in allowed:
            raise AssertionError(f"train: audit of {qid}: evaluate gave RR "
                                 f"{per_query[qid]}, the fp32 ranks "
                                 f"{lo}-{hi} allow {sorted(allowed)}")
        total += per_query[qid]
    audit = total / len(q_ids)
    if audit != mrr:
        raise AssertionError(f"train: audited MRR@10 {audit} != evaluate's "
                             f"{mrr}")
    log(f"train: fp32 audit over {len(ids)} docs: MRR@10 {audit:.6f} equals "
        f"evaluate's; {banded} of {len(q_ids)} queries had another doc "
        "within the tie band of their relevant doc")


def profile_steps(trainer, batch, step_ms: float, steps: int = 3):
    """The card's work in a few ``train_step``s (torch.profiler, after every
    timing): device time by kernel, the matmuls' share and launches a
    step, and the device-busy share of ``step_ms``, the step's median
    time without the profiler (whose own host cost slows the steps it
    records). The GPU ranges of torch's ``Optimizer.step#...`` annotations
    span kernels already counted and are left out."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        return getattr(e, "device_time_total", 0) or getattr(
            e, "cuda_time_total", 0)

    trainer.train_step(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            trainer.train_step(batch)
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    ops = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and dev_us(e)
           and not e.key.startswith("Optimizer.")]
    busy = sum(dev_us(e) for e in ops)
    if not busy:
        log("train: profile of train_step: no device time in the trace")
        return
    mm = sum(dev_us(e) for e in ops
             if re.search(r"gemm|nvjet|xmma|cutlass", e.key, re.I))
    top = sorted(ops, key=dev_us, reverse=True)[:6]
    log(f"train: profile of {steps} train_steps (torch.profiler): device "
        f"{busy / steps / 1000:.2f} ms a step in "
        f"{sum(e.count for e in ops) / steps:.0f} launches, of which "
        f"matmul kernels {mm / steps / 1000:.2f} ms; device busy "
        f"{busy / steps / 1000 / step_ms:.1%} of the {step_ms:.2f} ms median "
        f"step (host {wall_us / steps / 1000:.2f} ms a step under the "
        "profiler); top kernels (ms a step, launches a step): "
        + "; ".join(
            f"{re.sub(r'void |at::native::|<.*', '', e.key)[:60]} "
            f"{dev_us(e) / steps / 1000:.2f} "
            f"({e.count / steps:g})" for e in top))


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def phase_train(dev, cfg=None) -> dict:
    """train_dr -> build_index -> retrieve -> successive_retrieve ->
    evaluate through the drivers' main functions on ``dev`` at BERT-base
    width (``cfg``), with the checks of the training step between. Returns
    the retrieve step's kernel launches."""
    from openmatch_tpu_torch.config import ModelArguments
    from openmatch_tpu_torch.drivers import (build_index, evaluate, retrieve,
                                             successive_retrieve, train_dr)
    from openmatch_tpu_torch.models.bert import BertConfig
    from openmatch_tpu_torch.models.dr_model import DRModel
    from openmatch_tpu_torch.ops import _build
    from openmatch_tpu_torch.train import dr_trainer
    from openmatch_tpu_torch.utils.metrics import (eval_mrr, load_qrels,
                                                   load_run)

    cfg = cfg or BertConfig()
    tok = WhitespaceTokenizer(cfg.vocab_size)
    rng = np.random.default_rng(9)
    cuda = dev.type == "cuda"
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        hf_dir, out = os.path.join(root, "hf"), os.path.join(root, "model")
        hf_bert_base(rng, cfg, hf_dir)
        write_train_data(rng, cfg.vocab_size, root)
        log(f"train: HF BERT-base checkpoint, {TRAIN_PASSAGES} passages, "
            f"{TRAIN_QUERIES} train and {DEV_QUERIES} dev queries written in "
            f"{time.perf_counter() - t0:.2f} s")

        # 1. train through the driver, each step timed behind a sync
        real_step, seen, times = dr_trainer.DRTrainer.train_step, [], []

        def timed_step(self, batch):
            seen[:] = [self]
            sync(dev)
            t = time.perf_counter()
            loss = real_step(self, batch)
            sync(dev)
            times.append(time.perf_counter() - t)
            return loss

        dr_trainer.DRTrainer.train_step = timed_step
        resident = torch.cuda.memory_allocated() if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        try:
            result = train_dr.main([
                "--model_name_or_path", hf_dir, "--output_dir", out,
                "--train_path", os.path.join(root, "train.jsonl"),
                "--pooling", "mean", "--dtype", "bfloat16",
                "--per_device_train_batch_size",
                str(TRAIN_BATCH), "--train_n_passages", str(N_PSG),
                "--q_max_len", str(Q_LEN), "--p_max_len", str(P_LEN),
                "--max_steps", "30", "--save_steps", "15",
                "--logging_steps", "5", "--learning_rate", str(TRAIN_LR),
                "--device", str(dev)], tokenizer=tok)
        finally:
            dr_trainer.DRTrainer.train_step = real_step
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        losses = result["losses"]
        if result["final_step"] != 30 or len(losses) != 6 \
                or not np.isfinite(losses).all():
            raise AssertionError(f"train: driver run {result}")
        tokens = TRAIN_BATCH * Q_LEN + TRAIN_BATCH * N_PSG * P_LEN
        med = float(np.median(times[1:]))
        log(f"train: train_dr ran {len(times)} steps (mean pooling, bf16 "
            f"compute, dropout 0.1, lr {TRAIN_LR}, {TRAIN_BATCH} queries x "
            f"{N_PSG} passages, "
            f"{tokens} tokens a step); logged losses {losses}; median step "
            f"{med * 1000:.2f} ms (first {times[0] * 1000:.1f} ms) = "
            f"{tokens / med:.0f} query+passage tokens/s; peak "
            f"max_memory_allocated {peak / 2**30:.2f} GiB, of which "
            f"{resident / 2**30:.2f} GiB were allocated before train_dr")
        for d in ("checkpoint-15", "checkpoint-30"):
            if not os.path.exists(os.path.join(out, d,
                                               "train_state.msgpack")):
                raise AssertionError(f"train: {d} was not written")

        # 7 (first, while the trainer's model is at hand): the saved
        # checkpoint loads to the same encodings
        trainer = seen[0]
        trained = trainer.model.eval()
        batch = fixed_batch(root, tok)
        ids = torch.from_numpy(batch["passage"]["input_ids"]).to(dev)
        mask = torch.from_numpy(batch["passage"]["attention_mask"]).to(dev)
        loaded = DRModel.load(out, dtype="bfloat16", device=dev)
        with torch.inference_mode():
            same = torch.equal(loaded.encode(ids, mask),
                               trained.encode(ids, mask))
        if not same:
            raise AssertionError("train: the saved checkpoint does not "
                                 "encode as the trained model")
        log(f"train: DRModel.load of {os.path.basename(out)} encodes "
            f"{ids.shape[0]} passages bit-equal to the trained model")
        del trained, loaded, seen[:]

        # 3-4. GradCache against plain, and learning, at full width in fp32
        model = DRModel.build(ModelArguments(
            model_name_or_path=hf_dir, dtype="float32"), device=dev)
        no_drop = DRModel(dataclasses.replace(
            model.encoder_config, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)).to(dev)
        no_drop.load_state_dict(model.state_dict())
        del model
        init = {k: v.clone() for k, v in no_drop.state_dict().items()}
        check_grad_cache(dev, no_drop, batch)
        no_drop.load_state_dict(init)  # the timed steps above trained it
        check_learns(dev, no_drop, batch)
        del no_drop, init

        # 5. the rest of the main path on the trained checkpoint
        emb = os.path.join(root, "emb")
        common = ["--model_name_or_path", out, "--device", str(dev),
                  "--q_max_len", str(Q_LEN), "--p_max_len", str(P_LEN),
                  "--encoded_save_path", emb,
                  "--per_device_eval_batch_size", "256"]
        sync(dev)
        t0 = time.perf_counter()
        for i in range(4):
            build_index.main(common + [
                "--corpus_path", os.path.join(root, "corpus.jsonl"),
                "--encode_num_shard", "4", "--encode_shard_index", str(i)],
                tokenizer=tok)
        log(f"train: build_index wrote 4 shards of {TRAIN_PASSAGES} "
            f"passages in {time.perf_counter() - t0:.2f} s (4 driver calls, "
            "model loads included)")
        runs = {n: os.path.join(root, f"{n}.trec")
                for n in ("retrieve", "successive")}
        search = ["--query_path", os.path.join(root, "dev.jsonl"),
                  "--retrieve_depth", "100"]
        _build.launches.clear()
        retrieve.main(common + search + ["--trec_save_path",
                                         runs["retrieve"]], tokenizer=tok)
        sync(dev)
        launches = _build.launches.copy()
        log(f"train: launches during retrieve {launches}")
        if cuda and (launches["plain_gmax"] < 1
                     or launches["gather_rescore"] < 1):
            raise AssertionError("train: retrieve did not launch K1 and K3")
        successive_retrieve.main(common + search + [
            "--trec_save_path", runs["successive"]], tokenizer=tok)
        doc_pos = {f"d{i}": i for i in range(TRAIN_PASSAGES)}
        qa, s_a, i_a = run_ranks(runs["successive"], doc_pos, dev)
        qb, s_b, i_b = run_ranks(runs["retrieve"], doc_pos, dev)
        if qa != qb or s_b.shape != (DEV_QUERIES, 100):
            raise AssertionError(f"train: runs hold {s_a.shape} and "
                                 f"{s_b.shape} answers")
        same_above_band("successive_retrieve vs retrieve", s_a, i_a, s_b,
                        i_b, phase="train")
        qrels = os.path.join(root, "dev.qrels")
        mrr = evaluate.main(["-m", "mrr_cut.10", qrels, runs["retrieve"]])
        per_query = eval_mrr(load_qrels(qrels), load_run(runs["retrieve"]),
                             10)
        if per_query["all"] != mrr:
            raise AssertionError("train: evaluate's MRR is not eval_mrr's")
        log(f"train: evaluate MRR@10 {mrr:.6f} over {DEV_QUERIES} queries")

        # 6. the audit
        audit_mrr(dev, root, out, emb, tok, mrr, per_query)
        if cuda:  # a profiler session last, after every timing
            profile_steps(trainer, batch, med * 1000)
        del trainer
    if cuda:
        torch.cuda.empty_cache()
    return {"plain_gmax": launches["plain_gmax"],
            "gather_rescore": launches["gather_rescore"]}


# ---- rerank: T5 dense retrieval, train_rr, rerank, /rerank ------------------

RR_DEPTH, RR_STEPS, RR_BATCH, RR_EVAL_BATCH = 20, 20, 8, 128
RR_LR = 2e-5
RR_REL = 2e-2  # a bf16 score vs the same model's fp32 score, x max|fp32|
SERVE_RR_REL = 1e-3  # /rerank vs Reranker on the same pairs, x max|score|
SERVE_RR_REQUESTS, SERVE_RR_DOCS, SERVE_RR_BATCH = 8, 50, 64


def t5_base():
    """t5-base's shape (castorini/monot5-base-msmarco has the same)."""
    from openmatch_tpu_torch.models.t5 import T5Config

    return T5Config(vocab_size=32128, d_model=768, d_kv=64, d_ff=3072,
                    num_layers=12, num_decoder_layers=12, num_heads=12,
                    feed_forward_proj="relu", tie_word_embeddings=True)


def hf_t5(rng: np.random.Generator, cfg, path: str, decoder: bool = True):
    """A raw HuggingFace-layout T5 checkpoint from seeded weights drawn at
    HF's initial scales (factor 1): config.json and pytorch_model.bin (the
    encoder alone, as ``T5EncoderModel`` saves it, without ``decoder``)."""
    d, H, kv, ff = cfg.d_model, cfg.num_heads, cfg.d_kv, cfg.d_ff

    def n(std, *shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                * np.float32(std))

    sd = {"shared.weight": n(1.0, cfg.vocab_size, d)}
    stacks = (("encoder", cfg.num_layers),
              ("decoder", cfg.num_decoder_layers))[: 2 if decoder else 1]
    for stack, layers in stacks:
        for i in range(layers):
            p = f"{stack}.block.{i}.layer"
            blocks = ["SelfAttention"] + (["EncDecAttention"]
                                          if stack == "decoder" else [])
            for j, attn in enumerate(blocks):
                sd[f"{p}.{j}.{attn}.q.weight"] = n((d * kv) ** -0.5, H * kv, d)
                sd[f"{p}.{j}.{attn}.k.weight"] = n(d ** -0.5, H * kv, d)
                sd[f"{p}.{j}.{attn}.v.weight"] = n(d ** -0.5, H * kv, d)
                sd[f"{p}.{j}.{attn}.o.weight"] = n((H * kv) ** -0.5, d, H * kv)
                sd[f"{p}.{j}.layer_norm.weight"] = torch.ones(d)
            if i == 0:
                sd[f"{p}.0.SelfAttention.relative_attention_bias.weight"] = \
                    n(d ** -0.5, cfg.relative_attention_num_buckets, H)
            f = len(blocks)
            sd[f"{p}.{f}.DenseReluDense.wi.weight"] = n(d ** -0.5, ff, d)
            sd[f"{p}.{f}.DenseReluDense.wo.weight"] = n(ff ** -0.5, d, ff)
            sd[f"{p}.{f}.layer_norm.weight"] = torch.ones(d)
        sd[f"{stack}.final_layer_norm.weight"] = torch.ones(d)
    os.makedirs(path, exist_ok=True)
    torch.save(sd, os.path.join(path, "pytorch_model.bin"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"model_type": "t5", "vocab_size": cfg.vocab_size,
                   "d_model": d, "d_kv": kv, "d_ff": ff,
                   "num_layers": cfg.num_layers,
                   "num_decoder_layers": cfg.num_decoder_layers,
                   "num_heads": H, "relative_attention_num_buckets":
                   cfg.relative_attention_num_buckets,
                   "relative_attention_max_distance":
                   cfg.relative_attention_max_distance,
                   "feed_forward_proj": "relu", "tie_word_embeddings": True,
                   "decoder_start_token_id": 0, "pad_token_id": 0,
                   "dropout_rate": 0.1, "layer_norm_epsilon": 1e-6}, f)


def pairs_per_s(model, dev, rng: np.random.Generator, S: int) -> float:
    """Pairs/s of ``score`` + ``relevance_logprob`` on a full [RR_EVAL_BATCH,
    S] batch on the card (median device time of 5 calls)."""
    vocab = min(getattr(model.encoder_config, "vocab_size", 30522), 30522)
    ids = torch.from_numpy(rng.integers(1000, vocab, (RR_EVAL_BATCH, S))).to(dev)
    ones, zeros = torch.ones_like(ids), torch.zeros_like(ids)
    with torch.inference_mode():
        ms = cuda_time_ms(lambda: model.relevance_logprob(
            model.score(ids, ones, zeros)), 2, 5)
    return RR_EVAL_BATCH * 1000 / ms


def audit_rerank(name: str, got: dict, fp32: dict, qrels: dict,
                 mrr: float, per_query: dict) -> None:
    """The bf16 reranked run against the same model's fp32 scores of the
    same pairs: the same keys; each score within RR_REL x max|fp32 score|;
    each query's reciprocal rank one the fp32 scores allow when docs within
    the tie band (twice the largest score error measured: two docs move by
    at most that toward each other) of the relevant doc's fp32 score may
    rank either side; the mean, in evaluate's order, equals evaluate's."""
    if {q: set(d) for q, d in got.items()} != {q: set(d)
                                               for q, d in fp32.items()}:
        raise AssertionError(f"rerank: {name}: bf16 and fp32 runs hold "
                             "other pairs")
    errs = [abs(got[q][d] - fp32[q][d]) for q in fp32 for d in fp32[q]]
    err = max(errs)
    values = [s for docs in fp32.values() for s in docs.values()]
    scale = max(abs(s) for s in values)
    if not err <= RR_REL * scale:
        raise AssertionError(
            f"rerank: {name}: bf16 score off by {err} > {RR_REL} x {scale} "
            f"(median error {np.median(errs):.3e}; fp32 scores from "
            f"{min(values):.4f} to {max(values):.4f})")
    band, banded, total = 2 * err, 0, 0.0
    for qid in (q for q in per_query if q != "all"):
        rel = qrels[qid]
        allowed = {0.0}
        if rel in fp32[qid]:
            s = fp32[qid][rel]
            lo = 1 + sum(v > s + band for v in fp32[qid].values())
            hi = sum(v >= s - band for v in fp32[qid].values())
            allowed = {1.0 / k if k <= 10 else 0.0 for k in range(lo, hi + 1)}
            banded += lo != hi
        if per_query[qid] not in allowed:
            raise AssertionError(f"rerank: {name}: {qid} has RR "
                                 f"{per_query[qid]}, fp32 allows "
                                 f"{sorted(allowed)}")
        total += per_query[qid]
    audit = total / (len(per_query) - 1)
    if audit != mrr:
        raise AssertionError(f"rerank: {name}: audited MRR@10 {audit} != "
                             f"evaluate's {mrr}")
    log(f"rerank: {name}: bf16 vs fp32 on the card: max abs score err "
        f"{err:.3e} (tolerance {RR_REL} x {scale:.3e}); MRR@10 {mrr:.6f} "
        f"agrees with the fp32 scores read with a tie band of {band:.3e} "
        f"({banded} of {len(per_query) - 1} queries had another doc in it)")


def rerank_run(model, tok, root, run_path, q_len, p_len) -> dict:
    """``Reranker`` over the top RR_DEPTH of ``run_path`` (the audit's
    second scoring of the driver's pairs)."""
    from openmatch_tpu_torch.config import DataArguments, InferenceArguments
    from openmatch_tpu_torch.data.inference_dataset import InferenceDataset
    from openmatch_tpu_torch.retriever.reranker import Reranker
    from openmatch_tpu_torch.utils.trec import load_from_trec

    data = DataArguments(query_path=os.path.join(root, "dev.jsonl"),
                         corpus_path=os.path.join(root, "corpus.jsonl"),
                         q_max_len=q_len, p_max_len=p_len,
                         query_template="", doc_template="")
    queries = InferenceDataset.load(tok, data, is_query=True).to_dict()
    corpus = InferenceDataset.load(tok, data, is_query=False).to_dict()
    run = load_from_trec(run_path, max_len_per_q=RR_DEPTH)
    return Reranker(model, tok, data, InferenceArguments(
        per_device_eval_batch_size=RR_EVAL_BATCH)).rerank(
        queries, corpus, run, depth=RR_DEPTH)


def serve_rerank(dev, rr_dir, tok, rng) -> None:
    """A rerank-only server answers SERVE_RR_REQUESTS concurrent POST
    /rerank requests of SERVE_RR_DOCS docs; each answer is its docs by
    descending score, and the scores equal ``Reranker``'s for the same
    pairs within SERVE_RR_REL x max|score| (the texts keep every pair under
    128 tokens, so both score [64, 128] batches)."""
    from openmatch_tpu_torch.config import DataArguments, InferenceArguments
    from openmatch_tpu_torch.drivers.serve import (ServingHTTPServer,
                                                   build_rerank_service,
                                                   make_handler)
    from openmatch_tpu_torch.models.rr_model import RRModel
    from openmatch_tpu_torch.retriever.reranker import Reranker

    data = DataArguments(q_max_len=Q_LEN, p_max_len=P_LEN)
    service = build_rerank_service(rr_dir, data, SERVE_RR_BATCH, dev,
                                   tokenizer=tok)
    t0 = time.perf_counter()
    service.warmup()
    log(f"rerank: /rerank warmup (every pad length) "
        f"{time.perf_counter() - t0:.2f} s")
    words = [f"t{i}" for i in range(5000)]
    requests = [{"query": " ".join(rng.choice(words, 6)), "docs": [
        {"id": f"r{r}d{j}", "text": " ".join(rng.choice(
            words, rng.integers(30, 100)))} for j in range(SERVE_RR_DOCS)]}
        for r in range(SERVE_RR_REQUESTS)]
    service.timeline = []
    server = ServingHTTPServer(("127.0.0.1", 0),
                               make_handler(None, K, service))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        _, health, _ = http_json(base + "/health")
        with ThreadPoolExecutor(max_workers=len(requests)) as pool:
            answers = [f.result() for f in [
                pool.submit(http_json, base + "/rerank", r)
                for r in requests]]
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        service.close()
    if health["endpoints"] != ["/rerank"]:
        raise AssertionError(f"/health of a rerank-only server: {health}")
    queries = {f"s{r}": {"text": q["query"]} for r, q in enumerate(requests)}
    corpus = {d["id"]: {"text": d["text"]} for q in requests
              for d in q["docs"]}
    run = {f"s{r}": {d["id"]: 0.0 for d in q["docs"]}
           for r, q in enumerate(requests)}
    model = RRModel.load(rr_dir, dtype="bfloat16", device=dev)
    # /rerank scores the texts as given: the Reranker without templates
    plain = dataclasses.replace(data, query_template="", doc_template="")
    want = Reranker(model, tok, plain, InferenceArguments(
        per_device_eval_batch_size=SERVE_RR_BATCH)).rerank(queries, corpus,
                                                           run)
    scale = max(abs(s) for docs in want.values() for s in docs.values())
    err = 0.0
    for r, (status, body, _) in enumerate(answers):
        res = body["results"]
        scores = [x["score"] for x in res]
        if status != 200 or len(res) != SERVE_RR_DOCS \
                or scores != sorted(scores, reverse=True):
            raise AssertionError(f"/rerank answered {status} with "
                                 f"{len(res)} results")
        err = max(err, max(abs(x["score"] - want[f"s{r}"][x["id"]])
                           for x in res))
    if not err <= SERVE_RR_REL * scale:
        raise AssertionError(f"/rerank scores off Reranker's by {err} > "
                             f"{SERVE_RR_REL} x {scale}")
    log(f"rerank: /rerank (rerank-only server, max_batch "
        f"{SERVE_RR_BATCH}): {len(requests)} concurrent requests of "
        f"{SERVE_RR_DOCS} docs answered in "
        + ", ".join(f"{sec * 1000:.1f}" for _, _, sec in answers)
        + f" ms; scores equal Reranker's within {err:.3e} (tolerance "
        f"{SERVE_RR_REL} x {scale:.3e}); service {service.stats}")
    for t in service.timeline:
        log(f"rerank: dispatch of {t['reqs']} requests / {t['rows']} pairs: "
            f"queued {t['wait_s'] * 1000:.1f} ms, executed "
            f"{t['exec_s'] * 1000:.1f} ms, of which score+readback "
            f"{t['device_s'] * 1000:.1f} ms")


def phase_rerank(dev, bert_cfg=None, t5_cfg=None) -> dict:
    """T5 dense retrieval (build_index, retrieve: K1 and K3 must launch),
    train_rr on a BERT-base cross-encoder, rerank with it and with
    monoT5-base, evaluate, the fp32 audits, and /rerank, through the
    drivers' main functions on ``dev`` at full width (``bert_cfg``,
    ``t5_cfg``). Returns the retrieve step's kernel launches."""
    from openmatch_tpu_torch.config import ModelArguments
    from openmatch_tpu_torch.drivers import (build_index, evaluate, rerank,
                                             retrieve, train_rr)
    from openmatch_tpu_torch.models.bert import BertConfig
    from openmatch_tpu_torch.models.rr_model import RRModel
    from openmatch_tpu_torch.ops import _build
    from openmatch_tpu_torch.retriever.reranker import collate_pairs
    from openmatch_tpu_torch.train import rr_trainer
    from openmatch_tpu_torch.utils.metrics import (eval_mrr, load_qrels,
                                                   load_run)

    bert_cfg, t5_cfg = bert_cfg or BertConfig(), t5_cfg or t5_base()
    tok = WhitespaceTokenizer(bert_cfg.vocab_size)
    tok_t5 = WhitespaceTokenizer(t5_cfg.vocab_size)
    rng = np.random.default_rng(10)
    cuda = dev.type == "cuda"
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        t5_dir, bert_dir = os.path.join(root, "t5"), os.path.join(root, "hf")
        hf_t5(rng, t5_cfg, t5_dir)
        hf_bert_base(rng, bert_cfg, bert_dir)
        write_train_data(rng, bert_cfg.vocab_size, root)
        log(f"rerank: HF T5 ({t5_cfg.d_model} wide, {t5_cfg.num_layers} + "
            f"{t5_cfg.num_decoder_layers} layers) and BERT checkpoints, "
            f"{TRAIN_PASSAGES} passages, {TRAIN_QUERIES} train and "
            f"{DEV_QUERIES} dev queries written in "
            f"{time.perf_counter() - t0:.2f} s")

        # 1. T5 dense retrieval (t5_encdec: decoder step 0's hidden state)
        emb, run_path = os.path.join(root, "emb"), os.path.join(root,
                                                                "t5.trec")
        common = ["--model_name_or_path", t5_dir, "--device", str(dev),
                  "--q_max_len", str(Q_LEN), "--p_max_len", str(P_LEN),
                  "--encoded_save_path", emb,
                  "--per_device_eval_batch_size", "256"]
        sync(dev)
        t0 = time.perf_counter()
        build_index.main(common + ["--corpus_path",
                                   os.path.join(root, "corpus.jsonl")],
                         tokenizer=tok_t5)
        sync(dev)
        log(f"rerank: build_index with T5 (t5_encdec, bf16) encoded "
            f"{TRAIN_PASSAGES} passages in {time.perf_counter() - t0:.2f} s "
            "(model load included)")
        _build.launches.clear()
        retrieve.main(common + ["--query_path", os.path.join(root,
                                                             "dev.jsonl"),
                                "--retrieve_depth", "100",
                                "--trec_save_path", run_path],
                      tokenizer=tok_t5)
        sync(dev)
        launches = _build.launches.copy()
        log(f"rerank: launches during the T5 retrieve {launches}")
        if cuda and (launches["plain_gmax"] < 1
                     or launches["gather_rescore"] < 1):
            raise AssertionError("rerank: the T5 retrieve did not launch "
                                 "K1 and K3")
        qrels_path = os.path.join(root, "dev.qrels")
        qrels = {q: next(iter(d)) for q, d in load_qrels(qrels_path).items()}
        mrr_dr = evaluate.main(["-m", "mrr_cut.10", qrels_path, run_path])
        log(f"rerank: T5 dense retrieval MRR@10 {mrr_dr:.6f}")

        # 2. train_rr, each step timed behind a sync
        rr_dir = os.path.join(root, "rr")
        real_step, seen, times = rr_trainer.RRTrainer.train_step, [], []

        def timed_step(self, batch):
            seen[:] = [self]
            sync(dev)
            t = time.perf_counter()
            loss = real_step(self, batch)
            sync(dev)
            times.append(time.perf_counter() - t)
            return loss

        rr_trainer.RRTrainer.train_step = timed_step
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated() if cuda else 0
        try:
            result = train_rr.main([
                "--model_name_or_path", bert_dir, "--output_dir", rr_dir,
                "--train_path", os.path.join(root, "train.jsonl"),
                "--loss_fn", "bce", "--dtype", "bfloat16",
                # mean pooling, as the train phase's bi-encoder: with these
                # seeded weights attention is near uniform and the [CLS]
                # state is its own embedding's, nearly one value for every
                # pair, so first-token scores differ only in bf16 noise
                "--pooling", "mean",
                "--projection_in_dim", str(bert_cfg.hidden_size),
                "--per_device_train_batch_size", str(RR_BATCH),
                "--q_max_len", str(Q_LEN), "--p_max_len", str(P_LEN),
                "--max_steps", str(RR_STEPS), "--logging_steps", "5",
                "--learning_rate", str(RR_LR), "--device", str(dev)],
                tokenizer=tok)
        finally:
            rr_trainer.RRTrainer.train_step = real_step
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        if result["final_step"] != RR_STEPS \
                or not np.isfinite(result["losses"]).all():
            raise AssertionError(f"rerank: train_rr run {result}")
        med = float(np.median(times[1:]))
        log(f"rerank: train_rr ran {len(times)} steps (BERT-base cross-"
            f"encoder, bce, bf16 compute, dropout 0.1, lr {RR_LR}, "
            f"{RR_BATCH} positive + {RR_BATCH} negative pairs of "
            f"{Q_LEN + P_LEN + 2} tokens a step); logged losses "
            f"{result['losses']}; median step {med * 1000:.2f} ms (first "
            f"{times[0] * 1000:.1f} ms) = {2 * RR_BATCH / med:.1f} pairs/s; "
            f"peak max_memory_allocated {peak / 2**30:.2f} GiB "
            f"({resident / 2**30:.2f} GiB allocated before train_rr)")
        trained = seen[0].model.eval()
        pairs = [(ids, [0] * len(ids)) for ids in (
            [101] + list(rng.integers(1000, bert_cfg.vocab_size, 100)) + [102]
            for _ in range(16))]
        batch = {k: torch.from_numpy(v).to(dev) for k, v in collate_pairs(
            pairs, 128, Q_LEN + P_LEN + 2, 0).items()}
        loaded = RRModel.load(rr_dir, dtype="bfloat16", device=dev)
        with torch.inference_mode():
            same = torch.equal(loaded.score(**batch), trained.score(**batch))
        if not same:
            raise AssertionError("rerank: the saved cross-encoder does not "
                                 "score as the trained model")
        log("rerank: RRModel.load of the train_rr output scores 16 pairs "
            "bit-equal to the trained model")
        del trained, seen[:], loaded

        # 3-4. rerank with monoBERT and monoT5, evaluate, the fp32 audits
        def rr_model(name, dtype):
            if name == "monoBERT":
                return RRModel.load(rr_dir, dtype=dtype, device=dev)
            return RRModel.build(ModelArguments(
                model_name_or_path=t5_dir, dtype=dtype, pos_token="true",
                neg_token="false"), tokenizer=tok_t5, device=dev)

        models = (("monoBERT", tok, ["--model_name_or_path", rr_dir]),
                  ("monoT5", tok_t5, ["--model_name_or_path", t5_dir,
                                      "--pos_token", "true",
                                      "--neg_token", "false"]))
        failures = []
        for name, tk, flags in models:
            out = os.path.join(root, f"{name}.trec")
            sync(dev)
            t0 = time.perf_counter()
            got = rerank.main(flags + [
                "--query_path", os.path.join(root, "dev.jsonl"),
                "--corpus_path", os.path.join(root, "corpus.jsonl"),
                "--trec_run_path", run_path, "--trec_save_path", out,
                # the texts are token id lists: a template would turn
                # them into strings
                "--query_template", "", "--doc_template", "",
                "--reranking_depth", str(RR_DEPTH), "--q_max_len",
                str(Q_LEN), "--p_max_len", str(P_LEN), "--dtype", "bfloat16",
                "--per_device_eval_batch_size", str(RR_EVAL_BATCH),
                "--device", str(dev)], tokenizer=tk)
            sync(dev)
            sec = time.perf_counter() - t0
            n_pairs = sum(len(d) for d in got.values())
            mrr = evaluate.main(["-m", "mrr_cut.10", qrels_path, out])
            per_query = eval_mrr(load_qrels(qrels_path), load_run(out), 10)
            log(f"rerank: rerank with {name} (bf16) scored {n_pairs} pairs "
                f"in {sec:.2f} s ({n_pairs / sec:.1f} pairs/s, model load "
                f"included); MRR@10 {mrr:.6f} (the T5 run's {mrr_dr:.6f})")
            model = rr_model(name, "float32")
            fp32 = rerank_run(model, tk, root, run_path, Q_LEN, P_LEN)
            try:  # both models are audited before the phase fails
                audit_rerank(name, got, fp32, qrels, mrr, per_query)
            except AssertionError as e:
                log(str(e))
                failures.append(str(e))
            del model
            if cuda:
                torch.cuda.empty_cache()

        # pairs/s at S=128 and S=256, bf16
        if cuda:
            for name, _, _ in models:
                model = rr_model(name, "bfloat16")
                rate = {S: pairs_per_s(model, dev, rng, S) for S in (128, 256)}
                log(f"rerank: {name} (bf16) scores a batch of "
                    f"{RR_EVAL_BATCH} pairs at {rate[128]:.1f} pairs/s at "
                    f"S=128 and {rate[256]:.1f} pairs/s at S=256 (median "
                    "device time of 5 calls)")
                del model

        # 5. /rerank
        serve_rerank(dev, rr_dir, tok, rng)
        if failures:
            raise AssertionError("; ".join(failures))
    if cuda:
        torch.cuda.empty_cache()
    return {"plain_gmax": launches["plain_gmax"],
            "gather_rescore": launches["gather_rescore"]}


# ---- ance: the hard-negative refresh, alternating and generator ------------

ANCE_DOCS, ANCE_QUERIES, ANCE_STEPS = 100_000, 1_000, 50
REFRESH_LEFT = 2**26  # bytes a refresh may leave allocated: the index it
# searched (100,000 x 768 bf16, 154 MB) must be gone before gen1 trains


def on_card(emb: np.ndarray, dev) -> torch.Tensor:
    """fp16 embeddings as the index and the searched queries hold them
    (bf16), in fp32 on ``dev`` for an audit's products."""
    return torch.from_numpy(np.ascontiguousarray(emb)).to(
        torch.bfloat16).to(dev).float()


def check_search_kernels(phase: str, emb: dict, k: int, dev) -> None:
    """K1 and K3 against their plain versions at the shapes a phase's
    search gave them: its queries and corpus embeddings as the Searcher
    holds them (bf16, one buffer), K1 with the pyramid's level 1, K3 at the
    selection K1's maxima give; each kernel's device time beside its plain
    version's and its bound. Called after the phase read its launch counts, so these
    launches are not counted. On the CPU, where the search runs the plain
    path, there is nothing to hold."""
    if dev.type != "cuda":
        return
    from openmatch_tpu_torch.ops import cuda_mips as cm
    from openmatch_tpu_torch.ops.mips import (FANOUT, _select_groups,
                                              pyramid_fanouts)

    def bf16(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            torch.bfloat16).to(dev)

    q, body = bf16(emb["q_emb"]), cm.prepare_plain_corpus(
        bf16(emb["doc_emb"])).plain
    nb = body.shape[0] // 8
    if not pyramid_fanouts(nb, k) or nb // 2 <= k:
        raise AssertionError(f"{phase}: {nb} blocks at k={k} do not take "
                             "the K1 path")
    g1, l1 = cm.fused_plain_gmax(q, body, emit_l1=FANOUT)
    r1, rl1 = cm.plain_gmax_reference(q, body, emit_l1=FANOUT)
    compare(f"{phase}: K1 gmax Q={q.shape[0]} NB={nb}", g1, r1)
    compare(f"{phase}: K1 l1", l1, rl1)
    del r1, rl1
    bid = _select_groups(g1, k, l1=l1).to(torch.int32)
    compare(f"{phase}: K3 rescore k={k}", cm.gather_rescore(q, body, bid),
            cm.gather_rescore_reference(q, body, bid))
    t1 = kernel_ms(lambda: cm.fused_plain_gmax(q, body, emit_l1=FANOUT))
    t1p = cuda_time_ms(lambda: cm.plain_gmax_reference(
        q, body, emit_l1=FANOUT), 1, 3)
    t3 = kernel_ms(lambda: cm.gather_rescore(q, body, bid))
    t3p = cuda_time_ms(lambda: cm.gather_rescore_reference(q, body, bid),
                       1, 3)
    b1 = gmax_bound(q, body.numel(), q.shape[0] * (nb + -(-nb // FANOUT)))
    b3 = rescore_bound(q, bid)
    log(f"{phase}: at Q={q.shape[0]}, N={emb['doc_emb'].shape[0]}, k={k}: "
        f"K1 {t1:.4f} ms (plain {t1p:.4f}, bound {b1[0]:.4f}, {b1[1]}), K3 "
        f"{t3:.4f} ms (plain {t3p:.4f}, bound {b3[0]:.4f}, {b3[1]})")


def audit_mined(dev, refresh: dict, qrels: dict, topk: int) -> int:
    """Every mined negative is a non-positive whose fp32 score over the
    refresh's fp16 embeddings (as the index holds them, in bf16) lies at or
    above the tie band (AUDIT_REL x max|score|) of the query's topk-th fp32
    score. Returns the number of negatives checked."""
    index, q = on_card(refresh["doc_emb"], dev), on_card(refresh["q_emb"], dev)
    col = {d: i for i, d in enumerate(refresh["doc_ids"])}
    checked = 0
    for lo in range(0, q.shape[0], 256):
        scores = q[lo:lo + 256] @ index.T
        floor = scores.topk(topk, dim=1).values[:, -1] \
            - AUDIT_REL * scores.abs().amax(1)
        for r, qid in enumerate(refresh["qids"][lo:lo + 256]):
            negs = refresh["negatives"][qid]
            if set(negs) & set(qrels[qid]):
                raise AssertionError(f"ance: {qid} mined a positive")
            got = scores[r, [col[d] for d in negs]]
            if (got < floor[r]).any():
                raise AssertionError(
                    f"ance: {qid} mined a negative scoring "
                    f"{got.min().item()} in fp32, below the top {topk}'s "
                    f"tie band (from {floor[r].item()})")
            checked += len(negs)
    return checked


def audit_metrics(phase: str, run: dict, qrels: dict, emb: dict,
                  depth: int, metrics: dict, dev) -> None:
    """A run's metrics against fp32 scores over the same fp16 embeddings
    (``emb``: q_emb, qids, doc_emb, doc_ids; each cast to bf16 as the index
    and the searched queries were). Each relevant doc's rank in the run (in
    evaluate's order) must be one the fp32 scores allow, read with the tie
    band (docs within AUDIT_REL x max|score| of its score may rank either
    side); a doc absent from the run must be allowed a rank past ``depth``.
    The per-query values the run gives, summed in evaluate's order, must
    equal ``metrics``; where no relevant doc has another within its band,
    they must also equal evaluate_run on the fp32 top ``depth``."""
    from openmatch_tpu_torch.utils.metrics import evaluate_run

    index, q = on_card(emb["doc_emb"], dev), on_card(emb["q_emb"], dev)
    col = {d: i for i, d in enumerate(emb["doc_ids"])}
    measures = sorted(metrics)
    fp32_run, banded, checked = {}, 0, 0
    for lo in range(0, q.shape[0], 256):
        scores = q[lo:lo + 256] @ index.T
        tol = AUDIT_REL * scores.abs().amax(1)
        top_s, top_i = scores.topk(min(depth, index.shape[0]), dim=1)
        for r, qid in enumerate(emb["qids"][lo:lo + 256]):
            fp32_run[qid] = {emb["doc_ids"][i]: s for s, i in zip(
                top_s[r].tolist(), top_i[r].tolist())}
            rel = [d for d, g in qrels.get(qid, {}).items() if g > 0]
            if not rel:
                continue
            s = scores[r, [col[d] for d in rel]]
            best = ((scores[r][None] > (s + tol[r])[:, None]).sum(1)
                    + 1).tolist()
            worst = (scores[r][None] >= (s - tol[r])[:, None]).sum(1).tolist()
            ranked = sorted(run.get(qid, {}).items(),
                            key=lambda kv: (kv[1], kv[0]), reverse=True)
            rank = {d: i + 1 for i, (d, _) in enumerate(ranked)}
            for d, b, w in zip(rel, best, worst):
                banded += b != w
                checked += 1
                got = rank.get(d)
                ok = b <= got <= w if got is not None else w > len(ranked)
                if not ok:
                    raise AssertionError(
                        f"{phase}: {qid}'s relevant {d} ranks {got} in the "
                        f"run; the fp32 scores allow {b}-{w}")
    totals = dict.fromkeys(measures, 0.0)
    for qid in qrels:
        one = evaluate_run({qid: qrels[qid]}, {qid: run.get(qid, {})},
                           measures)
        for m in measures:
            totals[m] += one[m]
    audit = {m: totals[m] / len(qrels) for m in measures}
    exact = evaluate_run(qrels, fp32_run, measures)
    if audit != {m: metrics[m] for m in measures} \
            or (not banded and exact != audit):
        raise AssertionError(f"{phase}: metrics {metrics}, audited {audit}, "
                             f"fp32 top {depth} {exact} ({banded} relevant "
                             "docs within a tie band)")
    log(f"{phase}: fp32 audit over {index.shape[0]} docs: {audit} equal the "
        f"run's; fp32 top {depth} gives {exact}; {checked} relevant docs "
        f"checked, {banded} with another doc within their tie band")


def phase_ance(dev, cfg=None) -> dict:
    """The ANCE refresh through the port's entry points at BERT-base width
    (``cfg``): one alternating cycle (``perf.ance_cycle.main``: train,
    refresh with K1 and K3, mine, publish, train on the mined file) and one
    generator refresh (``run_ance_generator``) from the cycle's checkpoint,
    with their fp32 audits. Returns the refreshes' kernel launches."""
    from openmatch_tpu_torch.ance.loop import (AnceConfig, latest_ann_data,
                                               run_ance_generator)
    from openmatch_tpu_torch.config import DataArguments, InferenceArguments
    from openmatch_tpu_torch.data.collators import QPCollator
    from openmatch_tpu_torch.data.inference_dataset import InferenceDataset
    from openmatch_tpu_torch.data.train_dataset import DRTrainDataset
    from openmatch_tpu_torch.models.bert import BertConfig
    from openmatch_tpu_torch.models.dr_model import DRModel
    from openmatch_tpu_torch.ops import _build
    from openmatch_tpu_torch.perf import ance_cycle
    from openmatch_tpu_torch.retriever.retriever import Retriever
    from openmatch_tpu_torch.utils.metrics import load_qrels

    cfg = cfg or BertConfig()
    tok = WhitespaceTokenizer(cfg.vocab_size)
    rng = np.random.default_rng(11)
    cuda = dev.type == "cuda"
    with tempfile.TemporaryDirectory() as root:
        hf_dir = os.path.join(root, "hf")
        hf_bert_base(rng, cfg, hf_dir)

        # 1. one alternating cycle at the reference's ANCE scale
        _build.launches.clear()
        t0 = time.perf_counter()
        cycle = ance_cycle.main([
            str(ANCE_DOCS), str(ANCE_QUERIES), str(ANCE_STEPS),
            "--model_name_or_path", hf_dir, "--pooling", "mean",
            "--device", str(dev), "--workdir", root])
        sync(dev)
        cycle_s = time.perf_counter() - t0
        launches = _build.launches.copy()
        log(f"ance: launches during the cycle {launches} (the refresh's "
            "search is the cycle's only one)")
        if cuda and (launches["plain_gmax"] < 1
                     or launches["gather_rescore"] < 1):
            raise AssertionError("ance: the refresh did not launch K1 and K3")
        losses, refresh = cycle["losses"], cycle["refresh"]
        if len(losses) != 2 * ANCE_STEPS or not np.isfinite(losses).all():
            raise AssertionError(f"ance: losses {losses}")
        g0, g1 = losses[:ANCE_STEPS], losses[ANCE_STEPS:]
        log(f"ance: cycle of {cycle_s:.2f} s (BERT-base, mean pooling, bf16; "
            "seconds by phase "
            + ", ".join(f"{k} {v:.3f}" for k, v in cycle["phases"].items())
            + f"; encode {ANCE_DOCS / cycle['phases']['encode_corpus_s']:.0f} "
            f"docs/s); loss gen0 first 10 {np.mean(g0[:10]):.4f}, last 10 "
            f"{np.mean(g0[-10:]):.4f}; gen1 (mined negatives) first 10 "
            f"{np.mean(g1[:10]):.4f}")
        if refresh["left_bytes"] > REFRESH_LEFT:
            raise AssertionError(f"ance: the refresh left "
                                 f"{refresh['left_bytes']} bytes allocated")
        n = audit_mined(dev, refresh, cycle["qrels"], ance_cycle.TOPK_TRAINING)
        check_search_kernels("ance", refresh, ance_cycle.TOPK_TRAINING, dev)
        ds = DRTrainDataset(tok, DataArguments(
            train_path=refresh["path"], q_max_len=Q_LEN, p_max_len=P_LEN,
            train_n_passages=N_PSG))
        it = ds.epoch_iterator(0, None)
        batch = QPCollator(0, Q_LEN, P_LEN)([next(it)
                                             for _ in range(TRAIN_BATCH)])
        if batch["passage"]["input_ids"].shape != (TRAIN_BATCH * N_PSG, P_LEN):
            raise AssertionError("ance: the published file does not collate")
        log(f"ance: {n} mined negatives of {len(refresh['negatives'])} "
            f"queries pass the fp32 audit (inside the top "
            f"{ance_cycle.TOPK_TRAINING} plus the tie band, no positive); "
            f"the published {os.path.basename(refresh['path'])} "
            f"({len(ds)} lines) loads through DRTrainDataset and QPCollator; "
            f"the refresh left {refresh['left_bytes'] / 2**20:.1f} MiB "
            "allocated")

        # 2. the generator from the cycle's checkpoint, into the same ann_dir
        trainer = cycle.pop("trainer")
        ckpt = trainer.save_checkpoint(os.path.join(
            root, "ckpt", f"checkpoint-{trainer.step}"))
        del trainer, cycle, refresh
        if cuda:
            torch.cuda.empty_cache()
        write_train_data(rng, cfg.vocab_size, root)
        with open(os.path.join(root, "corpus.jsonl")) as f:
            corpus = {r["id"]: r["text"] for r in map(json.loads, f)}
        with open(os.path.join(root, "dev.jsonl")) as f:
            queries = {r["id"]: r["text"] for r in map(json.loads, f)}
        dev_qrels = load_qrels(os.path.join(root, "dev.qrels"))
        data_args = DataArguments(
            corpus_path=os.path.join(root, "corpus.jsonl"),
            query_path=os.path.join(root, "dev.jsonl"), q_max_len=Q_LEN,
            p_max_len=P_LEN)
        inf_args = InferenceArguments(
            per_device_eval_batch_size=ance_cycle.ENCODE_BS)
        seen = {}

        class Recording(Retriever):
            """Keeps the generator's run and embeddings for the audit."""

            def search(self, q_embeddings, qids, topk=100,
                       search_dtype=torch.bfloat16):
                run = super().search(q_embeddings, qids, topk, search_dtype)
                seen.update(run=run, depth=topk, emb={
                    "q_emb": q_embeddings, "qids": qids,
                    "doc_emb": self.doc_embeddings, "doc_ids": self.doc_ids})
                return run

        def build_retriever(path):
            return Recording(DRModel.load(path, dtype="bfloat16", device=dev),
                             data_args, inf_args, 0, dev)

        ann_dir = os.path.join(root, "ann")
        _build.launches.clear()
        sync(dev)
        t0 = time.perf_counter()
        run_ance_generator(
            build_retriever,
            lambda: InferenceDataset.load(tok, data_args, is_query=False),
            lambda: InferenceDataset.load(tok, data_args, is_query=True),
            queries, corpus, {q: list(d) for q, d in dev_qrels.items()},
            dev_qrels, os.path.join(root, "ckpt"),
            AnceConfig(ann_dir=ann_dir), max_generations=1)
        sync(dev)
        gen_s = time.perf_counter() - t0
        more = _build.launches.copy()
        log(f"ance: launches during the generator {more}")
        if cuda and (more["plain_gmax"] < 1 or more["gather_rescore"] < 1):
            raise AssertionError("ance: the generator did not launch K1 and "
                                 "K3")
        path, gen, metrics = latest_ann_data(ann_dir)
        if gen != 1 or metrics.get("checkpoint") != ckpt:
            raise AssertionError(f"ance: the generator published generation "
                                 f"{gen} with {metrics}")
        with open(path) as f:
            lines = sum(1 for _ in f)
        log(f"ance: run_ance_generator refreshed from "
            f"{os.path.basename(ckpt)} over {len(corpus)} passages and "
            f"{len(queries)} dev queries in {gen_s:.2f} s (model load "
            f"included): published generation {gen} ({lines} lines) after "
            f"the cycle's 0; ann_ndcg_{gen} {metrics}")
        audit_metrics("ance", seen["run"], dev_qrels, seen["emb"],
                      seen["depth"], {"ndcg_cut_10": metrics["ndcg_cut_10"]},
                      dev)
        check_search_kernels("ance generator", seen["emb"], seen["depth"],
                             dev)
    if cuda:
        torch.cuda.empty_cache()
    return {k: launches[k] + more[k] for k in ("plain_gmax",
                                               "gather_rescore")}


# ---- beir: zero-shot retrieval at BEIR FiQA-2018's test counts -------------

BEIR_DOCS, BEIR_QUERIES = 57_638, 6_648
BEIR_TEST_QUERIES, BEIR_QRELS = 648, 1_706  # in qrels/test.tsv
BEIR_WORDS = 30_000  # word types of the seeded text
BEIR_DEPTH = 100  # retrieve_depth's default


def write_beir(rng: np.random.Generator, root: str) -> str:
    """A BEIR-layout directory at FiQA-2018's test counts: corpus.jsonl
    (seeded whitespace words, 20-199 a text, about one title in 20
    empty), queries.jsonl (each a sample of words of its first positive;
    the queries outside the test qrels sample a random doc) and
    qrels/test.tsv with its header. Returns the directory."""
    d = os.path.join(root, "fiqa")
    os.makedirs(os.path.join(d, "qrels"))
    names = [f"w{j}" for j in range(BEIR_WORDS)]
    lengths = rng.integers(20, 200, BEIR_DOCS)
    words = np.split(rng.integers(0, BEIR_WORDS, lengths.sum()),
                     np.cumsum(lengths)[:-1])
    titles = rng.integers(2, 12, BEIR_DOCS) * (rng.random(BEIR_DOCS) >= 0.05)
    with open(os.path.join(d, "corpus.jsonl"), "w") as f:
        for i in range(BEIR_DOCS):
            title = " ".join(names[j] for j in rng.integers(0, BEIR_WORDS,
                                                            titles[i]))
            f.write(json.dumps({"_id": f"d{i}", "title": title, "text":
                                " ".join(names[j] for j in words[i])}) + "\n")
    test = rng.choice(BEIR_QUERIES, BEIR_TEST_QUERIES, replace=False)
    rels = {int(j): [int(x)] for j, x in zip(
        test, rng.integers(0, BEIR_DOCS, BEIR_TEST_QUERIES))}
    while sum(map(len, rels.values())) < BEIR_QRELS:
        ps = rels[int(test[rng.integers(BEIR_TEST_QUERIES)])]
        doc = int(rng.integers(BEIR_DOCS))
        if doc not in ps:
            ps.append(doc)
    with open(os.path.join(d, "queries.jsonl"), "w") as f:
        for j in range(BEIR_QUERIES):
            src = words[rels[j][0] if j in rels else rng.integers(BEIR_DOCS)]
            pick = rng.choice(len(src), min(len(src), rng.integers(5, 16)),
                              replace=False)
            f.write(json.dumps({"_id": f"q{j}", "text": " ".join(
                names[src[k]] for k in np.sort(pick))}) + "\n")
    with open(os.path.join(d, "qrels", "test.tsv"), "w") as f:
        f.write("query-id\tcorpus-id\tscore\n")
        for j in test:
            for doc in rels[int(j)]:
                f.write(f"q{j}\td{doc}\t1\n")
    return d


def phase_beir(dev, cfg=None) -> dict:
    """``retrieve_beir`` through its ``main`` at BERT-base width (``cfg``)
    on a BEIR directory at FiQA-2018's test counts: K1 and K3 must launch,
    the TREC run must parse, and ndcg_cut_10 and recall_100 must equal the
    fp32 audit. Returns the run's kernel launches."""
    from openmatch_tpu_torch.data.beir import BEIRDataset
    from openmatch_tpu_torch.drivers import retrieve_beir
    from openmatch_tpu_torch.models.bert import BertConfig
    from openmatch_tpu_torch.ops import _build
    from openmatch_tpu_torch.retriever.retriever import Retriever
    from openmatch_tpu_torch.utils.trec import load_from_trec

    cfg = cfg or BertConfig()
    tok = WhitespaceTokenizer(cfg.vocab_size)
    rng = np.random.default_rng(12)
    cuda = dev.type == "cuda"
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        hf_dir = os.path.join(root, "hf")
        hf_bert_base(rng, cfg, hf_dir)
        data_dir = write_beir(rng, root)
        beir = BEIRDataset(data_dir)
        n_rel = sum(map(len, beir.qrels.values()))
        empty = sum(d["title"] == "-" for d in beir.iter_corpus())
        log(f"beir: HF BERT-base checkpoint and a BEIR directory of "
            f"{BEIR_DOCS} docs ({empty} with an empty title), {BEIR_QUERIES} "
            f"queries, {len(beir.qrels)} of them in the {n_rel} test qrels, "
            f"written in {time.perf_counter() - t0:.2f} s")

        # encode_corpus timed and both encodings kept for the audit
        real = Retriever.encode_corpus, Retriever.encode_queries
        emb, times = {}, []

        def encode_corpus(self, *a, **kw):
            sync(dev)
            t = time.perf_counter()
            out = real[0](self, *a, **kw)
            sync(dev)
            times.append(time.perf_counter() - t)
            emb["doc_emb"], emb["doc_ids"] = out
            return out

        def encode_queries(self, *a, **kw):
            out = real[1](self, *a, **kw)
            emb["q_emb"], emb["qids"] = out
            return out

        Retriever.encode_corpus, Retriever.encode_queries = (encode_corpus,
                                                             encode_queries)
        run_path = os.path.join(root, "run.trec")
        _build.launches.clear()
        t0 = time.perf_counter()
        try:
            metrics = retrieve_beir.main([
                "--model_name_or_path", hf_dir, "--data_dir", data_dir,
                "--pooling", "mean", "--dtype", "bfloat16",
                "--q_max_len", "64", "--p_max_len", "128",
                "--per_device_eval_batch_size", "512",
                "--trec_save_path", run_path, "--device", str(dev)],
                tokenizer=tok)
        finally:
            Retriever.encode_corpus, Retriever.encode_queries = real
        sync(dev)
        total = time.perf_counter() - t0
        launches = _build.launches.copy()
        log(f"beir: launches during retrieve_beir {launches}")
        if cuda and (launches["plain_gmax"] < 1
                     or launches["gather_rescore"] < 1):
            raise AssertionError("beir: retrieve_beir did not launch K1 and "
                                 "K3")
        run = load_from_trec(run_path)
        if len(run) != len(beir.qrels) \
                or {len(v) for v in run.values()} != {BEIR_DEPTH}:
            raise AssertionError(f"beir: the TREC run holds {len(run)} "
                                 "queries of "
                                 f"{sorted({len(v) for v in run.values()})} "
                                 "docs")
        log(f"beir: retrieve_beir in {total:.2f} s (model build and "
            f"tokenization included): encode_corpus {times[0]:.2f} s = "
            f"{BEIR_DOCS / times[0]:.0f} passages/s (tokenized in its "
            f"stream, p_max_len 128); metrics {metrics}")
        audit_metrics("beir", run, beir.qrels, emb, BEIR_DEPTH, metrics, dev)
        check_search_kernels("beir", emb, BEIR_DEPTH, dev)
    if cuda:
        torch.cuda.empty_cache()
    return {"plain_gmax": launches["plain_gmax"],
            "gather_rescore": launches["gather_rescore"]}


# ---- v1: BM25 -> the v1 rerankers -> features -> LeToR ensembles -----------

V1_VOCAB = 400_000  # GloVe 6B's word count: with -embed_dim 300 its table
V1_EMBED = 300
V1_DOCS = 100_000
V1_TRAIN_QUERIES, V1_DEV_QUERIES = 1_000, 200
V1_DEPTH = 100  # bm25_retrieve's top k, and the word models' rerank depth
V1_ENTS = 10_000  # entity vocabulary (EDRM)
V1_STEPS = 200  # word models: batch 8, lr 1e-3, triplet_loss
V1_BERT_STEPS, V1_MAXP_STEPS = 20, 10
V1_BERT_DEPTH = 20  # BertRanker reranks the top 20
V1_MAXP_QUERIES, V1_MAXP_DEPTH = 100, 10  # BertMaxP: top 10 of 100 queries
V1_MAXP_DOC_LEN = 61  # 4 passages of 32 + 61 + 3 = 96 tokens cover a doc
V1_INFER_BATCH = 256  # inference_v1's -batch_size; its first batch is
# also scored by the trainer's live module, which must match it bit for bit
V1_AUDIT = 256  # dev pairs scored on the card and on the CPU
# BERT-base in fp32 on the host's CPU takes seconds per batch of 32 pairs
# of 256 tokens (the audit's time is logged): its audits take fewer pairs
V1_BERT_AUDIT, V1_MAXP_AUDIT = 32, 16
V1_WORD_REL, V1_BERT_REL = 1e-4, 1e-3  # card vs CPU, x max|score|
V1_BM25_REL = 1e-4  # native BM25 vs numpy, relative
V1_BM25_AUDIT = 20  # queries


class PairTokenizer(WhitespaceTokenizer):
    """``WhitespaceTokenizer`` plus the HF call the v1 BERT collator makes:
    a batch of (query, doc) pairs -> numpy input_ids, attention_mask and
    token_type_ids padded to ``max_length``, truncated longest-first."""

    def __call__(self, queries, docs, truncation=None, max_length=None,
                 padding=None, return_tensors=None):
        rows = [self.encode_plus((q, d), max_length=max_length,
                                 return_token_type_ids=True)
                for q, d in zip(queries, docs)]
        out = {k: np.zeros((len(rows), max_length), np.int64) for k in
               ("input_ids", "attention_mask", "token_type_ids")}
        for i, row in enumerate(rows):
            n = len(row["input_ids"])
            out["input_ids"][i, :n] = row["input_ids"]
            out["attention_mask"][i, :n] = 1
            out["token_type_ids"][i, :n] = row["token_type_ids"]
        return out


def zipf_words(rng: np.random.Generator, n: int) -> np.ndarray:
    """``n`` word ids of the V1_VOCAB vocabulary, P(rank r) ~ 1 / r."""
    cdf = np.cumsum(1.0 / np.arange(1, V1_VOCAB + 1))
    return np.minimum(np.searchsorted(cdf / cdf[-1], rng.random(n)),
                      V1_VOCAB - 1)


def write_v1_data(rng: np.random.Generator, root: str) -> dict:
    """The v1 phase's inputs in ``root``: vocab.txt (V1_VOCAB words),
    ents.txt, corpus.tsv (V1_DOCS passages of 20-199 Zipf words; also the
    V1Dataset docs file), queries.tsv (train then dev queries of 5-15
    words of a positive), dev.qrels, and each passage's entities (0-3) with
    each entity's 20-word description. Returns the arrays the BM25 audit
    and the EDRM files are built from."""
    names = np.array([f"w{j}" for j in range(V1_VOCAB)])
    with open(os.path.join(root, "vocab.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    with open(os.path.join(root, "ents.txt"), "w") as f:
        f.write("\n".join(f"e{k}" for k in range(V1_ENTS)) + "\n")
    lengths = rng.integers(20, 200, V1_DOCS)
    flat = zipf_words(rng, int(lengths.sum()))
    cuts = np.cumsum(lengths)[:-1]
    words = np.split(flat, cuts)
    texts = [" ".join(w) for w in np.split(names[flat], cuts)]
    with open(os.path.join(root, "corpus.tsv"), "w") as f:
        f.writelines(f"d{i}\t{t}\n" for i, t in enumerate(texts))
    n_q = V1_TRAIN_QUERIES + V1_DEV_QUERIES
    pos = rng.permutation(V1_DOCS)[:n_q]
    queries = []
    for p in pos:
        src = words[p]
        pick = rng.choice(len(src), rng.integers(5, 16), replace=False)
        queries.append(src[np.sort(pick)])
    with open(os.path.join(root, "queries.tsv"), "w") as f:
        f.writelines(f"q{j}\t{' '.join(names[q])}\n"
                     for j, q in enumerate(queries))
    with open(os.path.join(root, "dev.qrels"), "w") as f:
        f.writelines(f"q{j} 0 d{pos[j]} 1\n"
                     for j in range(V1_TRAIN_QUERIES, n_q))
    ents = [rng.integers(0, V1_ENTS, rng.integers(0, 4))
            for _ in range(V1_DOCS)]
    des = [" ".join(names[w]) for w in
           zipf_words(rng, V1_ENTS * 20).reshape(V1_ENTS, 20)]
    return {"names": names, "words": words, "flat": flat,
            "lengths": lengths, "texts": texts, "pos": pos,
            "queries": queries, "ents": ents, "des": des}


def audit_bm25(data: dict, run: dict, qids: list) -> float:
    """Each audited query's returned scores against a numpy BM25 (k1 0.9,
    b 0.4) over the same postings, and its k-th score against numpy's
    k-th; returns the largest relative error."""
    n = len(data["lengths"])
    doc_of = np.repeat(np.arange(n), data["lengths"])
    order = np.argsort(data["flat"], kind="stable")
    sorted_words, sorted_docs = data["flat"][order], doc_of[order]
    avg = data["lengths"].mean()
    norm = 0.9 * (1 - 0.4 + 0.4 * data["lengths"] / avg)
    worst = 0.0
    for qid in qids:
        scores = np.zeros(n)
        for t in data["queries"][int(qid[1:])]:
            lo, hi = np.searchsorted(sorted_words, [t, t + 1])
            tf = np.bincount(sorted_docs[lo:hi], minlength=n)
            df = np.count_nonzero(tf)
            idf = np.log(1 + (n - df + 0.5) / (df + 0.5))
            scores += idf * tf * 1.9 / (tf + norm)
        got = run[qid]
        want = np.array([scores[int(d[1:])] for d in got])
        err = np.abs(np.array(list(got.values())) - want) / want
        kth = np.sort(scores)[::-1][len(got) - 1]
        err = max(err.max(), abs(min(got.values()) - kth) / kth)
        if err > V1_BM25_REL:
            raise AssertionError(f"v1: BM25 of {qid} differs from numpy by "
                                 f"{err:.3g} (relative)")
        worst = max(worst, err)
    return worst


def write_v1_runs(root: str, run: dict, data: dict, rng) -> dict:
    """From the BM25 run: triples.trec (each train query's positive with
    two non-positives of its top V1_DEPTH), the dev runs at depths
    V1_DEPTH and V1_BERT_DEPTH and BertMaxP's (top V1_MAXP_DEPTH of
    V1_MAXP_QUERIES), and the EDRM jsonl files. Returns their paths."""
    pos = data["pos"]
    paths = {k: os.path.join(root, f"{k}.trec") for k in
             ("triples", "dev", "dev_bert", "dev_maxp")}
    triples = []
    for j in range(V1_TRAIN_QUERIES):
        negs = [d for d in run[f"q{j}"] if d != f"d{pos[j]}"]
        triples += [(f"q{j}", f"d{pos[j]}", negs[i])
                    for i in rng.choice(len(negs), 2, replace=False)]
    triples = [triples[i] for i in rng.permutation(len(triples))]
    with open(paths["triples"], "w") as f:
        f.writelines(f"{q} {p} {n}\n" for q, p, n in triples)
    dev_q = [f"q{j}" for j in range(V1_TRAIN_QUERIES,
                                    V1_TRAIN_QUERIES + V1_DEV_QUERIES)]
    for key, qs, depth in (("dev", dev_q, V1_DEPTH),
                           ("dev_bert", dev_q, V1_BERT_DEPTH),
                           ("dev_maxp", dev_q[:V1_MAXP_QUERIES],
                            V1_MAXP_DEPTH)):
        with open(paths[key], "w") as f:
            for q in qs:
                for r, (d, s) in enumerate(list(run[q].items())[:depth]):
                    f.write(f"{q} Q0 {d} {r + 1} {s} BM25\n")

    def ent_fields(doc: int, prefix: str) -> dict:
        ents = data["ents"][doc]
        return {f"{prefix}_ent": [f"e{k}" for k in ents],
                f"{prefix}_des": [data["des"][k] for k in ents]}

    def query_fields(j: int) -> dict:
        return {"query": " ".join(data["names"][data["queries"][j]]),
                **ent_fields(pos[j], "query")}

    texts = data["texts"]
    paths["edrm_train"] = os.path.join(root, "edrm_train.jsonl")
    with open(paths["edrm_train"], "w") as f:
        for q, p, n in triples:
            j, p, n = int(q[1:]), int(p[1:]), int(n[1:])
            f.write(json.dumps({**query_fields(j), "doc_pos": texts[p],
                                "doc_neg": texts[n],
                                **ent_fields(p, "doc_pos"),
                                **ent_fields(n, "doc_neg")}) + "\n")
    paths["edrm_dev"] = os.path.join(root, "edrm_dev.jsonl")
    with open(paths["edrm_dev"], "w") as f:
        for q in dev_q:
            j = int(q[1:])
            for d, s in list(run[q].items())[:V1_DEPTH]:
                f.write(json.dumps({
                    "query_id": q, "doc_id": d, "retrieval_score": s,
                    **query_fields(j), "doc": texts[int(d[1:])],
                    **ent_fields(int(d[1:]), "doc")}) + "\n")
    return paths


@contextlib.contextmanager
def timing(times: dict, *targets):
    """Each (owner, attribute name, key) in ``targets`` wrapped, for the
    block, to add its calls' seconds to ``times[key]``."""
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in targets]

    def wrap(fn, key):
        def timed(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                times[key] = times.get(key, 0.0) + time.perf_counter() - t
        return timed

    for (owner, attr, fn), (_, _, key) in zip(saved, targets):
        setattr(owner, attr, wrap(fn, key))
    try:
        yield times
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def v1_spec(root: str, trec: str) -> str:
    return (f"queries={os.path.join(root, 'queries.tsv')},"
            f"docs={os.path.join(root, 'corpus.tsv')},trec={trec}")


def audit_v1_model(name: str, model, batch: dict, dev, rel: float,
                   feats_under_tf32: bool = False) -> float:
    """``model``'s (score, feats) on the card against the same weights on
    the CPU, on ``batch``: scores within ``rel`` x max|score| (and KNRM's
    feats, which are also scored with TF32 allowed: the match matrix must
    stay fp32). Returns the largest score error relative to max|score|."""
    import copy

    from openmatch_tpu_torch.train.v1_trainer import to_device

    batch = {k: v for k, v in batch.items() if not isinstance(v, list)
             and k != "retrieval_score"}
    cpu_model = copy.deepcopy(model).cpu().eval()
    model.eval()
    with torch.no_grad():
        s_card, f_card = model.score_batch(to_device(batch, dev))
        s_cpu, f_cpu = cpu_model.score_batch(to_device(batch, "cpu"))
        pairs = [("score", s_card.cpu(), s_cpu)]
        if feats_under_tf32:
            pairs.append(("feats", f_card.cpu(), f_cpu))
            old = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                tf32 = model.score_batch(to_device(batch, dev))[1].cpu()
            finally:
                torch.backends.cuda.matmul.allow_tf32 = old
            pairs.append(("feats with TF32 allowed", tf32, f_cpu))
    del cpu_model
    worst = 0.0
    for what, got, want in pairs:
        scale = want.abs().max().item()
        err = (got - want).abs().max().item() / max(scale, 1e-30)
        if not torch.isfinite(got).all() or err > rel:
            raise AssertionError(f"v1: {name} {what} on the card differs from "
                                 f"the CPU by {err:.3g} x max|value| "
                                 f"(tolerance {rel})")
        worst = max(worst, err)
    return worst


def phase_v1(dev, bert_cfg=None) -> dict:
    """BM25 -> train_v1 (KNRM, Conv-KNRM, TK, EDRM, BertRanker, BertMaxP)
    -> inference_v1 -> gen_feature -> coor_ascent / ranksvm -> evaluate,
    through the drivers' main functions on ``dev``, with the BM25, reload
    and card-vs-CPU audits. Launches no hand-written kernel: returns {}."""
    from openmatch_tpu_torch.bm25 import engine
    from openmatch_tpu_torch.drivers import (bm25_retrieve, coor_ascent,
                                             evaluate, gen_feature,
                                             inference_v1, train_v1)
    from openmatch_tpu_torch.letor.features import load_feature_file
    from openmatch_tpu_torch.models.bert import BertConfig
    from openmatch_tpu_torch.train import v1_trainer
    from openmatch_tpu_torch.utils.trec import load_from_trec
    from openmatch_tpu_torch.v1.dataset import V1Dataset
    from openmatch_tpu_torch.v1.tokenizer import WordTokenizer

    bert_cfg = bert_cfg or BertConfig()
    rng = np.random.default_rng(13)
    cuda = dev.type == "cuda"
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        data = write_v1_data(rng, root)
        hf_dir = os.path.join(root, "hf")
        hf_bert_base(rng, bert_cfg, hf_dir)
        log(f"v1: {V1_VOCAB} words, {V1_DOCS} passages "
            f"({int(data['lengths'].sum())} words), {V1_TRAIN_QUERIES} train "
            f"and {V1_DEV_QUERIES} dev queries, {V1_ENTS} entities and an HF "
            f"BERT-base checkpoint written in {time.perf_counter() - t0:.2f} s")

        # 1. BM25: the index build and the queries timed apart
        bm25_path = os.path.join(root, "bm25.trec")
        with timing({}, (engine.BM25Retriever, "index_corpus", "index"),
                    (engine.BM25Retriever, "retrieve", "search")) as times:
            bm25_retrieve.main([
                "--corpus_path", os.path.join(root, "corpus.tsv"),
                "--query_path", os.path.join(root, "queries.tsv"),
                "--trec_save_path", bm25_path, "--k1", "0.9", "--b", "0.4",
                "--topk", str(V1_DEPTH)])
        run = load_from_trec(bm25_path)
        n_q = V1_TRAIN_QUERIES + V1_DEV_QUERIES
        if len(run) != n_q or {len(v) for v in run.values()} != {V1_DEPTH}:
            raise AssertionError(f"v1: the BM25 run holds {len(run)} queries "
                                 f"of {sorted({len(v) for v in run.values()})}"
                                 " docs")
        audited = [f"q{j}" for j in rng.choice(n_q, V1_BM25_AUDIT,
                                               replace=False)]
        bm25_err = audit_bm25(data, run, audited)
        log(f"v1: BM25 (native, g++-built into build/native) indexed "
            f"{V1_DOCS} passages in {times['index']:.2f} s, answered {n_q} "
            f"queries at top {V1_DEPTH} in {times['search']:.3f} s = "
            f"{n_q / times['search']:.0f} queries/s; {V1_BM25_AUDIT} "
            f"queries within {bm25_err:.2e} (relative) of a numpy BM25")
        paths = write_v1_runs(root, run, data, rng)
        qrels_path = os.path.join(root, "dev.qrels")
        wtok = WordTokenizer(vocab=os.path.join(root, "vocab.txt"))
        btok = PairTokenizer(bert_cfg.vocab_size)
        runs = {"bm25": bm25_path}

        word = ["-vocab", os.path.join(root, "vocab.txt"), "-embed_dim",
                str(V1_EMBED), "-max_query_len", "10", "-max_doc_len", "256"]
        bert = ["-model", "bert", "-pretrain", hf_dir, "-max_query_len",
                "32"]
        models = [
            # name, model flags, tokenizer, train spec, dev spec, steps,
            # lr, audit pairs, tolerance
            ("knrm", ["-model", "knrm"] + word, wtok, "triples", "dev",
             V1_STEPS, "1e-3", V1_AUDIT, V1_WORD_REL),
            ("cknrm", ["-model", "cknrm", "-kernel_dim", "128"] + word, wtok,
             "triples", "dev", V1_STEPS, "1e-3", V1_AUDIT, V1_WORD_REL),
            ("tk", ["-model", "tk"] + word, wtok, "triples", "dev", V1_STEPS,
             "1e-3", V1_AUDIT, V1_WORD_REL),
            ("edrm", ["-model", "edrm", "-kernel_dim", "128", "-ent_vocab",
                      os.path.join(root, "ents.txt"), "-max_ent_num", "3",
                      "-max_des_len", "20"] + word, wtok, "edrm_train",
             "edrm_dev", V1_STEPS, "1e-3", V1_AUDIT, V1_WORD_REL),
            ("bert", bert + ["-max_doc_len", "221"], btok, "triples",
             "dev_bert", V1_BERT_STEPS, "2e-5", V1_BERT_AUDIT, V1_BERT_REL),
            ("maxp", bert + ["-maxp", "-max_doc_len", str(V1_MAXP_DOC_LEN)],
             btok, "triples", "dev_maxp", V1_MAXP_STEPS, "2e-5",
             V1_MAXP_AUDIT, V1_BERT_REL),
        ]
        real_step = v1_trainer.V1Trainer.train_step
        for (name, flags, tok, train_key, dev_key, steps, lr, n_audit,
             rel) in models:
            ckpt = os.path.join(root, f"ckpt_{name}")
            spec = {k: (paths[k] if k.startswith("edrm") else
                        v1_spec(root, paths[k]))
                    for k in (train_key, dev_key)}
            seen, step_times = [], []

            def timed_step(self, batch):
                seen[:] = [self]
                sync(dev)
                t = time.perf_counter()
                loss = real_step(self, batch)
                sync(dev)
                step_times.append(time.perf_counter() - t)
                return loss

            # 2. train_v1, each step timed behind a sync; the model's build
            # and the checkpoint's save timed apart
            v1_trainer.V1Trainer.train_step = timed_step
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            try:
                with timing({}, (train_v1, "build_v1_model", "build"),
                            (v1_trainer.V1Trainer, "save_checkpoint",
                             "save")) as parts:
                    result = train_v1.main(flags + [
                        "-task", "ranking", "-ranking_loss", "triplet_loss",
                        "-train", spec[train_key], "-save", ckpt, "-epoch",
                        "1", "-batch_size", "8", "-lr", lr, "-eval_every",
                        str(max(steps // 10, 1)), "-max_input",
                        str(steps * 8), "-seed", "7", "--device", str(dev)],
                        tokenizer=tok)
            finally:
                v1_trainer.V1Trainer.train_step = real_step
            train_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() if cuda else 0
            losses = result["losses"]
            if result["final_step"] != steps or len(losses) != 10 \
                    or not np.isfinite(losses).all():
                raise AssertionError(f"v1: train_v1 {name} ran {result}")
            trainer = seen[0]
            model = trainer.model
            n_params = sum(p.numel() for p in model.parameters())
            log(f"v1: train_v1 {name} ({n_params} parameters) ran {steps} "
                f"steps of 8 triples (triplet_loss, lr {lr}) in "
                f"{train_s:.2f} s: model build {parts['build']:.2f} s, steps "
                f"{sum(step_times):.2f} s (median "
                f"{np.median(step_times[1:]) * 1000:.2f} ms, first "
                f"{step_times[0] * 1000:.1f} ms), train_state.msgpack save "
                f"{parts['save']:.2f} s; losses "
                f"{[round(x, 4) for x in losses]}; peak "
                f"max_memory_allocated {peak / 2**30:.2f} GiB")

            # 3. inference_v1 reranks the dev run from the saved checkpoint
            out_run = os.path.join(root, f"{name}.trec")
            sync(dev)
            t0 = time.perf_counter()
            with timing({}, (inference_v1, "build_v1_model", "build"),
                        (inference_v1, "load_v1_params", "load")) as parts:
                scored = inference_v1.main(flags + [
                    "-task", "ranking", "-test", spec[dev_key],
                    "-checkpoint", ckpt, "-res", out_run, "-batch_size",
                    str(V1_INFER_BATCH), "--device", str(dev)],
                    tokenizer=tok)
            sync(dev)
            infer_s = time.perf_counter() - t0
            n_pairs = sum(map(len, scored.values()))
            runs[name] = out_run

            # the reloaded checkpoint scores inference_v1's first batch
            # bit-equal to the trainer's live module
            dev_spec = spec[dev_key]
            dev_set = V1Dataset(dict(kv.split("=", 1) for kv in
                                     dev_spec.split(",")) if
                                dev_spec.startswith("queries=") else dev_spec,
                                mode="test")
            collator = v1_collator(flags, tok)
            n_live = min(V1_INFER_BATCH, len(dev_set))
            first = [dev_set[i] for i in range(n_live)]
            live = v1_trainer.predict_scores(model, [collator(first)])
            for q, docs in live.items():
                for d, s in docs.items():
                    if scored[q][d] != s:
                        raise AssertionError(
                            f"v1: {name}'s reloaded checkpoint scores "
                            f"{q} {d} {scored[q][d]!r}, the live module "
                            f"{s!r}")
            with torch.no_grad():
                on_card = v1_trainer.to_device(collator(first), dev)
                ms = cuda_time_ms(lambda: model.score_batch(on_card), 1, 3) \
                    if cuda else float("nan")

            # 4. the card against the CPU on the same weights
            t0 = time.perf_counter()
            err = audit_v1_model(name, model, collator(first[:n_audit]), dev,
                                 rel, feats_under_tf32=name == "knrm")
            audit_s = time.perf_counter() - t0
            log(f"v1: inference_v1 {name} reranked {n_pairs} pairs in "
                f"{infer_s:.2f} s (model build {parts['build']:.2f} s, "
                f"checkpoint load {parts['load']:.2f} s) = "
                f"{n_pairs / (infer_s - parts['build'] - parts['load']):.0f} "
                f"pairs/s after the load (tokenization included); the model "
                f"alone {n_live * 1000 / ms:.0f} pairs/s on the first batch "
                f"({n_live} pairs), which the reloaded checkpoint scores "
                f"bit-equal to the live module; card vs CPU on {n_audit} "
                f"pairs within {err:.2e} x max|score| (tolerance {rel}; "
                f"{audit_s:.2f} s)")

            # 5. features for the ensembles
            if name in ("knrm", "bert"):
                feat_path = os.path.join(root, f"{name}.features")
                n_lines = gen_feature.main(flags + [
                    "-task", "ranking", "-dev",
                    v1_spec(root, paths["dev_bert"]) + f",qrels={qrels_path}",
                    "-checkpoint", ckpt, "-out", feat_path, "--device",
                    str(dev)], tokenizer=tok)
                fs = load_feature_file(feat_path)
                want = V1_DEV_QUERIES * V1_BERT_DEPTH
                if n_lines != want or len(fs) != want:
                    raise AssertionError(f"v1: gen_feature {name} wrote "
                                         f"{n_lines} lines, parsed {len(fs)}")
                log(f"v1: gen_feature {name}: {len(fs)} lines of "
                    f"{fs.num_features} features, "
                    f"{int(fs.labels.sum())} labelled relevant")
                runs[f"{name}_features"] = feat_path
            del trainer, model, seen[:]
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()

        # 6. LeToR ensembles over the features, then every run evaluated
        for name, feats, ranker in (
                ("coor_ascent(knrm)", "knrm_features", "coor_ascent"),
                ("ranksvm(knrm)", "knrm_features", "ranksvm"),
                ("ranksvm(bert)", "bert_features", "ranksvm")):
            out_run = os.path.join(root, f"{name}.trec")
            t0 = time.perf_counter()
            folds = coor_ascent.main([
                "--features", runs[feats], "--k", "2", "--ranker", ranker,
                "--metric", "ndcg", "--metric_k", "10", "--restarts", "1",
                "--output_trec", out_run])
            log(f"v1: coor_ascent --ranker {ranker} on {feats}: ndcg@10 per "
                f"fold {[round(m, 4) for m in folds]} in "
                f"{time.perf_counter() - t0:.2f} s")
            runs[name] = out_run
        for name, path in runs.items():
            if name.endswith("_features"):
                continue
            mrr = evaluate.main(["-m", "mrr_cut.10", qrels_path, path])
            ndcg = evaluate.main(["-m", "ndcg_cut_10", qrels_path, path])
            log(f"v1: evaluate {name}: MRR@10 {mrr:.4f}, ndcg_cut_10 "
                f"{ndcg['ndcg_cut_10']:.4f}")
    return {}


def v1_collator(flags: list, tok):
    """The collator inference_v1 builds for these model flags."""
    from openmatch_tpu_torch.drivers import train_v1

    parser = argparse.ArgumentParser()
    train_v1.add_model_args(parser)
    return train_v1.build_v1_collator(parser.parse_args(flags), tok, "test")


# ---- the research recipes ---------------------------------------------------

RS_WORDS = 30_000  # the research corpus's word types
RS_DOCS = 4096  # qg_synthesis's corpus
RS_MAX_DOCS, RS_TOPK, RS_BAND = 256, 100, (50, 100)
RS_GEN_BATCH, RS_NEW_TOKENS = 16, 24
RS_SRC_LEN, RS_TGT_LEN = 256, 32
QG_STEPS, QG_LR = 20, 1e-4
TF_ROWS = 16  # rows of the teacher-forcing check
TF_REL = 1e-4  # a generated token's CPU logit >= row max - TF_REL x max|row|
GTR_PASSAGES, GTR_LEN, GTR_AUDIT = 1024, 128, 8
GTR_NORM_TOL = 1e-5
GTR_REL = 1e-4  # card vs CPU reps, x max|rep|
DR_STEPS = 5
MLM_STEPS, MLM_BATCH, MLM_LEN = 20, 32, 256
META_STEPS, META_BATCH = 10, 8
META_W_ATOL = 1e-4  # card vs CPU meta weights, absolute (they sum to 1)
RIS_STEPS, RIS_EVAL = 20, 5
# the rankers' learning rates: high enough that 5 steps reorder some dev
# run, so every dev evaluation gives the policy a reward to move on
RIS_LR = {"knrm": "1e-2", "bert": "1e-4"}
RIS_DEV_QUERIES, RIS_DEV_DOCS = 40, 10


class T5WordTokenizer:
    """A T5-style tokenizer over ``words`` (the card's machine has no
    ``sentencepiece``): word j is id 3 + j; pad 0, eos 1 (appended, and
    kept by truncation), unk 2. ``decode`` maps every id above 2 back to a
    word (ids past the list wrap around it), so any generated token is a
    corpus word."""

    pad_token_id, eos_token_id, unk_token_id = 0, 1, 2

    def __init__(self, words):
        self.words = list(words)
        self.ids = {w: 3 + j for j, w in enumerate(self.words)}

    def __call__(self, text, truncation=True, max_length=None):
        ids = [self.ids.get(w, 2) for w in text.split()]
        if truncation and max_length is not None:
            ids = ids[: max_length - 1]
        return {"input_ids": ids + [1]}

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(self.words[(int(i) - 3) % len(self.words)]
                        for i in ids if int(i) > 2)


class MLMTokenizer(WhitespaceTokenizer):
    """``WhitespaceTokenizer`` plus what train_mlm reads: ``mask_token_id``,
    ``all_special_ids`` and the padded numpy call."""

    unk_token_id, mask_token_id = 100, 103

    @property
    def all_special_ids(self):
        return [self.pad_token_id, self.unk_token_id, self.cls_token_id,
                self.sep_token_id, self.mask_token_id]

    def __call__(self, text, truncation=True, max_length=None,
                 padding="max_length", return_tensors="np"):
        ids = self.encode_plus(text, max_length=max_length)["input_ids"]
        out = np.zeros((1, max_length), np.int64)
        out[0, : len(ids)] = ids
        return {"input_ids": out, "attention_mask": (out > 0).astype(
            np.int64)}


def write_research_data(rng: np.random.Generator, root: str) -> dict:
    """The phase's text in ``root``: RS_DOCS passages of 40-199 Zipf-drawn
    words of RS_WORDS (corpus.jsonl, texts.txt), a word vocabulary
    (vocab.txt), source and target pairs for Meta-LTR and ReInfoSelect
    (each query 3-8 words of its positive, the negative another passage)
    and a dev run of RIS_DEV_QUERIES queries x RIS_DEV_DOCS passages with
    qrels (2-word queries; the other candidates share a query word).""" 
    names = np.array([f"w{j}" for j in range(RS_WORDS)])
    cdf = np.cumsum(1.0 / np.arange(1, RS_WORDS + 1))
    lengths = rng.integers(40, 200, RS_DOCS)
    flat = np.minimum(np.searchsorted(cdf / cdf[-1],
                                      rng.random(int(lengths.sum()))),
                      RS_WORDS - 1)
    texts = [" ".join(w) for w in np.split(names[flat],
                                           np.cumsum(lengths)[:-1])]
    with open(os.path.join(root, "corpus.jsonl"), "w") as f:
        f.writelines(json.dumps({"id": f"d{i}", "title": "", "text": t})
                     + "\n" for i, t in enumerate(texts))
    with open(os.path.join(root, "texts.txt"), "w") as f:
        f.writelines(t + "\n" for t in texts)
    with open(os.path.join(root, "vocab.txt"), "w") as f:
        f.write("\n".join(names) + "\n")

    def query(i):
        words = texts[i].split()
        pick = rng.choice(len(words), rng.integers(3, 9), replace=False)
        return " ".join(words[j] for j in np.sort(pick))

    for name, n in (("source", max(META_STEPS, RIS_STEPS) * META_BATCH),
                    ("target", META_STEPS * META_BATCH)):
        with open(os.path.join(root, f"{name}.jsonl"), "w") as f:
            for i in rng.integers(0, RS_DOCS, n):
                f.write(json.dumps({"query": query(i), "doc_pos": texts[i],
                                    "doc_neg": texts[(i + 1 + rng.integers(
                                        RS_DOCS - 1)) % RS_DOCS]}) + "\n")
    # dev queries of 2 words of the positive, whose other candidates share
    # a query word: the ranking is not settled by word overlap alone, so
    # training moves the dev metric
    word_sets = [set(t.split()) for t in texts]
    with open(os.path.join(root, "dev.jsonl"), "w") as f, \
            open(os.path.join(root, "dev.qrels"), "w") as g:
        for j, i in enumerate(rng.choice(RS_DOCS, RIS_DEV_QUERIES,
                                         replace=False)):
            words = texts[i].split()
            q_words = {words[k] for k in rng.choice(len(words), 2,
                                                    replace=False)}
            q = " ".join(sorted(q_words))
            share = [d for d in range(RS_DOCS)
                     if d != i and word_sets[d] & q_words]
            if len(share) < RIS_DEV_DOCS - 1:
                share += list(rng.choice(RS_DOCS, RIS_DEV_DOCS - 1))
            docs = [i] + list(rng.choice(share, RIS_DEV_DOCS - 1,
                                         replace=False))
            for k, d in enumerate(docs):
                f.write(json.dumps({
                    "query_id": f"q{j}", "doc_id": f"d{d}",
                    "retrieval_score": float(RIS_DEV_DOCS - k), "query": q,
                    "doc": texts[d]}) + "\n")
            g.write(f"q{j} 0 d{i} 1\n")
    return {"names": names, "texts": texts}


def gtr_step(dev, rng, t5_cfg, root) -> None:
    """A sentence-transformers GTR directory (T5-base encoder, 2_Dense
    768 -> 768) converted by the twin, encoded on the card (unit norms; 8
    passages against the CPU port), then scaled by the twin (each scaled
    key the original / 100 or / 10 bit for bit)."""
    import copy

    from openmatch_tpu_torch.models.dr_model import DRModel
    from openmatch_tpu_torch.models.flax_msgpack import read_flax_msgpack
    from openmatch_tpu_torch.scripts import scale_t5_weights
    from openmatch_tpu_torch.scripts.gtr import convert_gtr_ckpt

    src, out, scaled = (os.path.join(root, n) for n in
                        ("gtr", "om_gtr", "om_gtr_scaled"))
    t0 = time.perf_counter()
    hf_t5(rng, t5_cfg, src, decoder=False)
    d = t5_cfg.d_model
    os.makedirs(os.path.join(src, "2_Dense"))
    with open(os.path.join(src, "2_Dense", "config.json"), "w") as f:
        json.dump({"in_features": d, "out_features": d, "bias": False,
                   "activation_function":
                       "torch.nn.modules.linear.Identity"}, f)
    torch.save({"linear.weight": torch.from_numpy(
        rng.standard_normal((d, d), dtype=np.float32) * d ** -0.5)},
        os.path.join(src, "2_Dense", "pytorch_model.bin"))
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    convert_gtr_ckpt.main(["--input", src, "--output", out])
    convert_s = time.perf_counter() - t0
    model = DRModel.load(out, device=dev)
    ids = torch.from_numpy(rng.integers(3, t5_cfg.vocab_size,
                                        (GTR_PASSAGES, GTR_LEN))).to(dev)
    lengths = torch.from_numpy(rng.integers(16, GTR_LEN + 1, GTR_PASSAGES))
    mask = (torch.arange(GTR_LEN)[None] < lengths[:, None]).long().to(dev)
    reps = []
    with torch.inference_mode():
        sync(dev)
        t0 = time.perf_counter()
        for i in range(0, GTR_PASSAGES, 128):
            reps.append(model.encode_passage(ids[i:i + 128],
                                             mask[i:i + 128]))
        sync(dev)
        enc_s = time.perf_counter() - t0
    reps = torch.cat(reps)
    norm_err = (reps.norm(dim=-1) - 1).abs().max().item()
    if reps.shape != (GTR_PASSAGES, d) or not torch.isfinite(reps).all() \
            or norm_err > GTR_NORM_TOL:
        raise AssertionError(f"research: GTR reps {tuple(reps.shape)}, norms "
                             f"off 1 by {norm_err:.3g}")
    cpu = copy.deepcopy(model).cpu()
    with torch.inference_mode():
        want = cpu.encode_passage(ids[:GTR_AUDIT].cpu(),
                                  mask[:GTR_AUDIT].cpu())
    err = ((reps[:GTR_AUDIT].cpu() - want).abs().max()
           / want.abs().max()).item()
    if err > GTR_REL:
        raise AssertionError(f"research: GTR reps on the card differ from "
                             f"the CPU by {err:.3g} x max|rep|")
    del model, cpu
    t0 = time.perf_counter()
    scale_t5_weights.main(["--input_model_path", out, "--output_model_path",
                           scaled, "--num_layers", str(t5_cfg.num_layers)])
    scale_s = time.perf_counter() - t0
    before = read_flax_msgpack(os.path.join(out, "params.msgpack"))
    after = read_flax_msgpack(os.path.join(scaled, "params.msgpack"))
    n_scaled = 0

    def walk(a, b, path):
        nonlocal n_scaled
        if isinstance(b, dict):
            if set(a) != set(b):
                raise AssertionError(f"research: scaled tree {path} keys")
            for k in b:
                walk(a[k], b[k], f"{path}/{k}")
            return
        div = 100 if ("/o/" in path or "/shared/" in path) else \
            10 if "/ff/" in path else 1
        want = b / div if div > 1 and path.startswith("/encoder_q") else b
        if not np.array_equal(a, want):
            raise AssertionError(f"research: scale_t5_weights {path} is not "
                                 f"the original / {div} bit for bit")
        n_scaled += want is not b

    walk(after, before, "")
    log(f"research: GTR: sentence-transformers T5-base dir written in "
        f"{write_s:.2f} s, converted by the twin in {convert_s:.2f} s; "
        f"encode {GTR_PASSAGES} passages of <= {GTR_LEN} tokens (fp32) "
        f"{GTR_PASSAGES / enc_s:.0f} passages/s, norms within {norm_err:.2e} "
        f"of 1, {GTR_AUDIT} passages within {err:.2e} x max|rep| of the CPU "
        f"(tolerance {GTR_REL}); scale_t5_weights twin {scale_s:.2f} s, "
        f"{n_scaled} tensors scaled bit-exactly")


def qg_batch(tok, texts, idx, contrast: bool) -> dict:
    """A QG training batch: passages (or 'positive: ... negative: ...'
    pairs) -> the passage's first RS_TGT_LEN - 1 words and eos."""
    from openmatch_tpu_torch.data.collators import pad_ids

    if contrast:
        src = [tok(f"positive: {texts[i]} negative: "
                   f"{texts[(i + 7) % len(texts)]}", True, RS_SRC_LEN)
               ["input_ids"] for i in idx]
    else:
        src = [tok(texts[i], True, RS_SRC_LEN)["input_ids"] for i in idx]
    tgt = [tok(texts[i], True, RS_TGT_LEN)["input_ids"] for i in idx]
    batch = pad_ids(src, RS_SRC_LEN, 0)
    labels = pad_ids(tgt, RS_TGT_LEN, 0)
    return {**batch, "labels": labels["input_ids"],
            "label_mask": labels["attention_mask"]}


def train_qg(name: str, qg, batch, dev) -> list:
    """QG_STEPS steps of ``qg`` on one repeated batch; the loss must be
    finite and fall. Returns the losses."""
    from openmatch_tpu_torch.train.state import OptaxAdam

    step = qg.make_train_step(OptaxAdam(list(qg.model.parameters()),
                                        lr=QG_LR))
    losses, times = [], []
    for _ in range(QG_STEPS):
        sync(dev)
        t0 = time.perf_counter()
        losses.append(float(step(batch)))
        times.append(time.perf_counter() - t0)
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"research: {name} losses {losses}")
    B = batch["input_ids"].shape[0]
    log(f"research: {name} trained {QG_STEPS} steps of {B} x "
        f"{RS_SRC_LEN} -> {RS_TGT_LEN} tokens (fp32, Adam lr {QG_LR}): "
        f"median step {np.median(times[1:]) * 1000:.1f} ms; loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    return losses


def teacher_forcing_check(qg, tok, texts, dev) -> float:
    """The card's greedy ids for TF_ROWS passages, teacher-forced through a
    CPU copy: each token up to the row's eos must have a logit within
    TF_REL x max|logit| of the row's maximum. Returns the largest gap."""
    import copy

    from openmatch_tpu_torch.data.collators import pad_ids

    src = [tok(t, True, RS_SRC_LEN)["input_ids"] for t in texts[:TF_ROWS]]
    batch = pad_ids(src, RS_SRC_LEN, 0)
    gen = qg.generate(batch["input_ids"], batch["attention_mask"],
                      RS_NEW_TOKENS, 1).cpu()
    cpu = copy.deepcopy(qg.model).cpu()
    dec = torch.cat([torch.zeros(TF_ROWS, 1, dtype=torch.long),
                     gen[:, :-1]], 1)
    with torch.inference_mode():
        logits = cpu(torch.from_numpy(batch["input_ids"]),
                     torch.from_numpy(batch["attention_mask"]),
                     dec)["logits"]
    del cpu
    chosen = logits.gather(-1, gen[..., None])[..., 0]
    gap = (logits.max(-1).values - chosen) / logits.abs().amax(-1)
    live = (torch.cumsum((gen == 1).long(), 1) - (gen == 1).long()) == 0
    worst = gap[live].max().item()
    if worst > TF_REL:
        raise AssertionError(f"research: a greedy token's CPU logit is "
                             f"{worst:.3g} x max|logit| below its row's max")
    return worst


def phase_research(dev, bert_cfg=None, t5_cfg=None) -> dict:
    """The research recipes through their entry points on ``dev`` at full
    width (BERT-base ``bert_cfg``, T5-base ``t5_cfg``), in fp32: the GTR and
    T5-scaling tools, QG training, qg_synthesis, train_dr on its output,
    train_mlm, meta_train (KNRM and BERT) and train_v1 -reinfoselect (KNRM
    and BERT), each with its checks. Launches no hand-written kernel:
    returns {}."""
    import copy

    from openmatch_tpu_torch.bm25 import engine
    from openmatch_tpu_torch.drivers import (meta_train, qg_synthesis,
                                             train_dr, train_mlm, train_v1)
    from openmatch_tpu_torch.models.bert import BertConfig
    from openmatch_tpu_torch.models.dr_model import DRModel
    from openmatch_tpu_torch.research import meta_ltr
    from openmatch_tpu_torch.research.qg import QGModel
    from openmatch_tpu_torch.train import meta_trainer, reinfoselect_trainer
    from openmatch_tpu_torch.train.v1_trainer import (load_v1_params,
                                                      to_device)
    from openmatch_tpu_torch.v1.tokenizer import WordTokenizer

    bert_cfg, t5_cfg = bert_cfg or BertConfig(), t5_cfg or t5_base()
    rng = np.random.default_rng(14)
    cuda = dev.type == "cuda"

    def peak_gib():
        return torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0

    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        data = write_research_data(rng, root)
        texts = data["texts"]
        bert_dir, t5_dir = os.path.join(root, "hf"), os.path.join(root, "t5")
        hf_bert_base(rng, bert_cfg, bert_dir)
        hf_t5(rng, t5_cfg, t5_dir)
        log(f"research: {RS_DOCS} passages of {RS_WORDS} word types, pairs, "
            f"a dev run and HF BERT-base / T5-base checkpoints written in "
            f"{time.perf_counter() - t0:.2f} s")

        # 1. GTR: the converter and the scaler twins
        gtr_step(dev, rng, t5_cfg, root)

        # 2. QG and ContrastQG, each trained on one repeated batch
        t5_tok = T5WordTokenizer(data["names"])
        idx = rng.choice(RS_DOCS, RS_GEN_BATCH, replace=False)
        qg = QGModel.from_pretrained(t5_dir, device=dev)
        train_qg("seed QG", qg, qg_batch(t5_tok, texts, idx, False),
                 dev)
        cqg = QGModel(t5_cfg, device=dev)
        cqg.init_params(15)
        train_qg("ContrastQG", cqg, qg_batch(t5_tok, texts, idx, True),
                 dev)

        # 3. qg_synthesis.run_pipeline over the corpus
        corpus = qg_synthesis.load_corpus(os.path.join(root, "corpus.jsonl"))
        out_path = os.path.join(root, "synthetic.train.jsonl")
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        with timing({}, (qg_synthesis, "generate_seed_queries", "seed"),
                    (qg_synthesis, "synthesize_training_data", "cqg"),
                    (engine.BM25Retriever, "index_corpus", "index"),
                    (engine.BM25Retriever, "retrieve", "bm25")) as times:
            n = qg_synthesis.run_pipeline(
                qg, cqg, t5_tok, corpus, out_path, max_src_len=RS_SRC_LEN,
                max_new_tokens=RS_NEW_TOKENS, batch_size=RS_GEN_BATCH,
                bm25_topk=RS_TOPK, neg_rank_range=RS_BAND,
                max_docs=RS_MAX_DOCS)
        rows = [json.loads(line) for line in open(out_path)]
        if len(rows) != n or n < RS_GEN_BATCH or any(
                not (r["query"] and r["positives"] and r["negatives"])
                for r in rows):
            raise AssertionError(f"research: qg_synthesis wrote {n} rows, "
                                 f"{len(rows)} parsed")
        gap = teacher_forcing_check(qg, t5_tok, texts, dev)
        log(f"research: qg_synthesis over {RS_DOCS} passages (max_docs "
            f"{RS_MAX_DOCS}, BM25 top {RS_TOPK}, negatives from ranks "
            f"{RS_BAND[0]}-{RS_BAND[1]}, batch {RS_GEN_BATCH}, "
            f"{RS_NEW_TOKENS} new tokens, greedy, fp32, no KV cache): seed "
            f"QG {RS_MAX_DOCS / times['seed']:.1f} docs/s "
            f"({times['seed']:.2f} s), BM25 index {times['index']:.2f} s + "
            f"queries {times['bm25']:.3f} s, ContrastQG {n} pairs in "
            f"{times['cqg']:.2f} s = {n / times['cqg']:.1f} pairs/s; "
            f"{n} rows written; teacher forcing on the CPU: {TF_ROWS} rows' "
            f"tokens within {gap:.2e} x max|logit| of their row maxima "
            f"(tolerance {TF_REL}); peak max_memory_allocated "
            f"{peak_gib():.2f} GiB")
        del qg, cqg
        gc.collect()

        # 4. the synthetic file trains the port's train_dr
        btok = MLMTokenizer(bert_cfg.vocab_size)
        result = train_dr.main([
            "--model_name_or_path", bert_dir, "--train_path", out_path,
            "--output_dir", os.path.join(root, "dr"), "--max_steps",
            str(DR_STEPS), "--per_device_train_batch_size", "8",
            "--train_n_passages", "2", "--q_max_len", "32", "--p_max_len",
            "128", "--learning_rate", "1e-5", "--logging_steps", "1",
            "--save_steps", "0", "--device", str(dev)], tokenizer=btok)
        if result["final_step"] != DR_STEPS or not np.isfinite(
                result["losses"]).all():
            raise AssertionError(f"research: train_dr on the synthetic "
                                 f"file ran {result}")
        log(f"research: train_dr (BERT-base) took {DR_STEPS} steps of 8 "
            f"synthetic queries x 2 passages: losses "
            f"{[round(x, 4) for x in result['losses']]}")

        # 5. train_mlm; the exported encoder reloads and encodes as trained
        mlm_dir = os.path.join(root, "mlm")
        step_times = []
        real_mask = train_mlm.mask_tokens

        def timed_mask(*a, **kw):  # each step starts with its masking
            sync(dev)
            step_times.append(time.perf_counter())
            return real_mask(*a, **kw)

        if cuda:
            torch.cuda.reset_peak_memory_stats()
        train_mlm.mask_tokens = timed_mask
        try:
            result = train_mlm.main([
                "--model_name_or_path", bert_dir, "--train_path",
                os.path.join(root, "texts.txt"), "--output_dir", mlm_dir,
                "--max_steps", str(MLM_STEPS), "--per_device_train_batch_size",
                str(MLM_BATCH), "--p_max_len", str(MLM_LEN),
                "--learning_rate", "5e-5", "--logging_steps", "5",
                "--device", str(dev)], tokenizer=btok)
        finally:
            train_mlm.mask_tokens = real_mask
        peak = peak_gib()
        losses = result["losses"]
        if result["final_step"] != MLM_STEPS or not np.isfinite(
                losses).all():
            raise AssertionError(f"research: train_mlm ran {result}")
        model = result["model"]
        ids = torch.from_numpy(np.concatenate([
            btok(t, max_length=MLM_LEN)["input_ids"] for t in texts[:8]])
        ).to(dev)
        with torch.inference_mode():
            want = model.bert(ids, (ids > 0).long())["last_hidden_state"][:, 0]
            got = DRModel.load(mlm_dir, device=dev).encode_passage(
                ids, (ids > 0).long())
        if not torch.equal(got, want):
            raise AssertionError("research: train_mlm's exported DRModel "
                                 "encodes unlike the trained encoder")
        del model, result
        log(f"research: train_mlm (BERT-base, fp32) {MLM_STEPS} steps of "
            f"{MLM_BATCH} x {MLM_LEN} tokens: median step "
            f"{np.median(np.diff(step_times)[1:]) * 1000:.1f} ms "
            f"({MLM_BATCH * MLM_LEN / np.median(np.diff(step_times)[1:]):.0f}"
            f" tokens/s); losses {[round(x, 4) for x in losses]}; peak "
            f"max_memory_allocated {peak:.2f} GiB; the exported DRModel "
            f"reloads and encodes 8 passages bit-equal to the trained "
            f"encoder")

        # 6. meta_train, KNRM and BERT
        wtok = WordTokenizer(vocab=os.path.join(root, "vocab.txt"))
        ptok = PairTokenizer(bert_cfg.vocab_size)
        word = ["-vocab", os.path.join(root, "vocab.txt"), "-embed_dim",
                "300"]
        bert = ["-pretrain", bert_dir]
        for name, flags, tok in (("knrm", ["-model", "knrm"] + word, wtok),
                                 ("bert", ["-model", "bert"] + bert, ptok)):
            seen, times, snap = [], [], {}
            real_step = meta_trainer.MetaLTRTrainer.train_step

            def timed_step(self, batch, target):
                seen[:] = [self]
                if self.step == 1:  # the first step with a virtual lr > 0
                    snap.update(state=copy.deepcopy(self.model.state_dict()),
                                batch=batch, target=target)
                sync(dev)
                t = time.perf_counter()
                out = real_step(self, batch, target)
                sync(dev)
                times.append(time.perf_counter() - t)
                if self.step == 2:
                    snap["weights"] = out[1].cpu()
                return out

            if cuda:
                torch.cuda.reset_peak_memory_stats()
            meta_trainer.MetaLTRTrainer.train_step = timed_step
            try:
                result = meta_train.main(flags + [
                    "-task", "ranking", "-train",
                    os.path.join(root, "source.jsonl"), "-target",
                    os.path.join(root, "target.jsonl"), "-save_folder",
                    os.path.join(root, f"meta_{name}"), "-epoch", "1",
                    "-train_batch_size", str(META_BATCH),
                    "-target_batch_size", str(META_BATCH), "-lr",
                    "1e-3" if name == "knrm" else "2e-5",
                    "-n_warmup_steps", "2", "-max_input",
                    str(META_STEPS * META_BATCH), "--device", str(dev)],
                    tokenizer=tok)
            finally:
                meta_trainer.MetaLTRTrainer.train_step = real_step
            peak = peak_gib()
            # each step's weights are >= 0 and sum to 1, or to 0 when no
            # pair helps, or below 1 when their raw sum is under the
            # normaliser's floor of 1e-8 (JAX's clip, kept)
            ws = result["weights"]
            sums = [float(w.sum()) for w in ws]
            if result["final_step"] != META_STEPS or any(
                    (w < 0).any() for w in ws) \
                    or max(sums) > 1 + 1e-5 \
                    or (name == "knrm" and abs(sums[1] - 1) > 1e-5):
                raise AssertionError(f"research: meta_train {name}: weights "
                                     f"{[w.tolist() for w in ws]}")
            trainer = seen[0]
            audit = ""
            if name == "knrm":
                # the same step on the CPU from the same state and batches
                cpu_model = copy.deepcopy(trainer.model).cpu()
                cpu_model.load_state_dict(snap["state"])
                cpu_t = meta_trainer.MetaLTRTrainer(
                    cpu_model, trainer.args, trainer.total_steps,
                    device="cpu")
                w_cpu, _ = meta_ltr.meta_reweight_step(
                    dict(cpu_model.named_parameters()),
                    cpu_t.per_example_loss, cpu_t.target_loss,
                    to_device(snap["batch"], "cpu"),
                    to_device(snap["target"], "cpu"), trainer.schedule(1))
                err = (snap["weights"] - w_cpu).abs().max().item()
                if err > META_W_ATOL:
                    raise AssertionError(f"research: meta_train knrm's "
                                         f"weights differ from the CPU's by "
                                         f"{err:.3g}")
                audit = (f"; step 2's weights (the first at a virtual lr "
                         f"> 0) within {err:.2e} of the CPU's (tolerance "
                         f"{META_W_ATOL})")
                del cpu_model, cpu_t
            log(f"research: meta_train {name} {META_STEPS} steps of "
                f"{META_BATCH} source + {META_BATCH} target pairs (fp32): "
                f"median step {np.median(times[1:]) * 1000:.1f} ms, first "
                f"{times[0] * 1000:.1f} ms; peak max_memory_allocated "
                f"{peak:.2f} GiB; zero-weight share "
                f"{np.mean(np.concatenate(ws) == 0):.2f}; weight sums "
                f"{[round(x, 6) for x in sums]}{audit}")
            del trainer, seen[:], result
            snap.clear()
            gc.collect()

        # 7. train_v1 -reinfoselect, KNRM (Conv-KNRM policy) and BERT
        dev_spec = os.path.join(root, "dev.jsonl")
        for name, flags, tok in (("knrm", ["-model", "knrm"] + word, wtok),
                                 ("bert", ["-model", "bert"] + bert, ptok)):
            seen, moves = [], []
            real_refresh = reinfoselect_trainer.ReInfoSelectTrainer\
                .refresh_policy

            def refresh(self, reward):
                seen[:] = [self]
                before = [p.detach().clone() for p in
                          self.policy.parameters()]
                real_refresh(self, reward)
                moves.append((reward, any(
                    not torch.equal(a, b) for a, b in
                    zip(before, self.policy.parameters()))))

            save = os.path.join(root, f"ris_{name}")
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            reinfoselect_trainer.ReInfoSelectTrainer.refresh_policy = refresh
            try:
                result = train_v1.main(flags + [
                    "-task", "ranking", "-ranking_loss", "triplet_loss",
                    "-reinfoselect", "-train",
                    os.path.join(root, "source.jsonl"), "-dev", dev_spec,
                    "-qrels", os.path.join(root, "dev.qrels"), "-save", save,
                    "-res", os.path.join(root, f"ris_{name}.trec"),
                    "-max_query_len", "10", "-max_doc_len", "128",
                    "-batch_size", str(META_BATCH), "-lr", RIS_LR[name],
                    "-eval_every",
                    str(RIS_EVAL), "-max_input",
                    str(RIS_STEPS * META_BATCH), "--device", str(dev)],
                    tokenizer=tok)
            finally:
                reinfoselect_trainer.ReInfoSelectTrainer.refresh_policy = \
                    real_refresh
            wall = time.perf_counter() - t0
            peak = peak_gib()
            rates = result["keep_rates"]
            moved = [m for _, m in moves]
            first = next((i for i, (r, _) in enumerate(moves) if r != 0),
                         len(moves))
            if result["final_step"] != RIS_STEPS or len(rates) != RIS_STEPS \
                    or not all(0.0 <= r <= 1.0 for r in rates) \
                    or len(moves) != RIS_STEPS // RIS_EVAL \
                    or moved != [i >= first for i in range(len(moves))] \
                    or first == len(moves):
                raise AssertionError(f"research: train_v1 -reinfoselect "
                                     f"{name}: keep rates {rates}, refreshes "
                                     f"(reward, policy moved) {moves}")
            reloaded = load_v1_params(train_v1.build_v1_model(
                v1_args(flags), tok), os.path.join(save, "best"))
            live = seen[0].model
            batch = next(iter(reinfoselect_batches(flags, tok, root)))
            with torch.no_grad():
                want = live.score_batch(to_device(batch, dev))[0]
                got = reloaded.to(dev).eval().score_batch(
                    to_device(batch, dev))[0]
            if not torch.isfinite(got).all() or got.shape != want.shape:
                raise AssertionError(f"research: {name}'s best checkpoint "
                                     "does not score")
            log(f"research: train_v1 -reinfoselect {name} {RIS_STEPS} steps "
                f"of {META_BATCH} triples, eval every {RIS_EVAL} "
                f"({RIS_DEV_QUERIES} x {RIS_DEV_DOCS} dev pairs) in "
                f"{wall:.2f} s: keep rates {[round(r, 3) for r in rates]}; "
                f"refreshes (reward, policy moved) "
                f"{[(round(r, 4), m) for r, m in moves]}; the best "
                f"checkpoint reloads and scores; peak max_memory_allocated "
                f"{peak:.2f} GiB")
            del reloaded, live, seen[:], result
            gc.collect()
    return {}


def v1_args(flags: list):
    parser = argparse.ArgumentParser()
    from openmatch_tpu_torch.drivers import train_v1

    train_v1.add_model_args(parser)
    return parser.parse_args(flags + ["-max_query_len", "10",
                                      "-max_doc_len", "128"])


def reinfoselect_batches(flags: list, tok, root: str):
    from openmatch_tpu_torch.data.loader import batched
    from openmatch_tpu_torch.drivers import train_v1
    from openmatch_tpu_torch.v1.dataset import V1Dataset

    collator = train_v1.build_v1_collator(v1_args(flags), tok, "dev")
    dev_set = V1Dataset(os.path.join(root, "dev.jsonl"), mode="dev")
    for batch in batched(iter(dev_set), META_BATCH, collator):
        yield {k: v for k, v in batch.items() if not isinstance(v, list)
               and k not in ("retrieval_score", "label")}


# ---------------------------------------------------------------------------
# mesh: the port over torch.distributed ranks
# ---------------------------------------------------------------------------

MESH_WORLD = 2
MESH_TIMEOUT = 900.0  # s: the ranks' deadline (a hung rank fails the phase)
MESH_STEPS = 3
MESH_REL = 1e-5  # a rank vs one process, fp32 with TF32 off: the loss, and
# each parameter tensor's max abs difference, x max|value|
MESH_LR = 1e-4
MESH_Q, MESH_PSG = 8, 4  # the global batch of the training audits
MESH_RR_Q, MESH_RR_D, MESH_RR_BATCH = 64, 32, 64  # 2,048 pairs; per rank
MESH_CHUNK = 1 << 20  # rows of one seeded chunk of the index
MESH_MODES = {  # mode -> (dp, tp, TrainingArguments fields)
    "local": (2, 1, {}),
    "x_device": (2, 1, dict(negatives_x_device=True)),
    "gc_x_device": (2, 1, dict(negatives_x_device=True, grad_cache=True,
                               gc_q_chunk_size=2, gc_p_chunk_size=8)),
    "tp": (1, 2, dict(negatives_x_device=True)),
}
MESH_MODES_4 = {"dp2_tp2": (2, 2, dict(negatives_x_device=True))}
# serving over the ranks: the served queries, and serve.main's small index
MESH_SERVE_CLIENTS, MESH_SERVE_QUERIES = 8, 8
MESH_SMALL_INDEX = 16_384
# the v1 family over the ranks: KNRM at docs/v1-rerankers.md's widths (the
# GloVe 6B 300d table and its pad row; train_v1's -max_query_len and
# -max_doc_len), BertRanker at BERT-base; global batches, fp32, TF32 off
MESH_V1_VOCAB = V1_VOCAB + 1
MESH_V1_QLEN, MESH_V1_DLEN, MESH_V1_BATCH = 10, 256, 16
MESH_BERT_PAIRS, MESH_BERT_LEN = 8, 128
MESH_V1_STEPS = 3  # the first has warmup's lr 0 (and Meta-LTR zero weights)
MESH_V1_LR = 1e-4  # Adam moves an entry whose gradient is rounding noise by
# up to the lr (the policy's plain Adam has optax's epsilon 1e-8): 1e-4 keeps
# that below the audit's 1e-5
MESH_RIS_REWARD = 0.1  # the REINFORCE refresh after the second step
MESH_V1_MODES = ("knrm", "bert", "meta", "reinfoselect")
# ANCE's alternating loop over the ranks (perf/ance_cycle.py): BERT-base
# fp32, mean pooling, 2 generations of MESH_ANCE_STEPS steps of a global
# 8 x 8 batch, top 200 and 20 negatives (the cycle's)
MESH_ANCE_DOCS, MESH_ANCE_QUERIES, MESH_ANCE_STEPS = 16_384, 256, 3
# the sizes a rank takes from the parent (it imports this file afresh), so
# a rehearsal that shrinks them shrinks them on every rank
MESH_SIZES = ("D", "K", "MAX_BATCH", "N_MSMARCO", "V1_EMBED", "MESH_V1_VOCAB",
              "MESH_V1_QLEN", "MESH_V1_DLEN", "MESH_V1_BATCH",
              "MESH_BERT_PAIRS", "MESH_BERT_LEN", "MESH_V1_STEPS",
              "MESH_SMALL_INDEX", "MESH_SERVE_CLIENTS", "MESH_SERVE_QUERIES",
              "MESH_RR_Q", "MESH_RR_D", "MESH_RR_BATCH", "MESH_ANCE_DOCS",
              "MESH_ANCE_QUERIES", "MESH_ANCE_STEPS")


def seeded_state(module: torch.nn.Module, seed: int) -> dict:
    """Every parameter of ``module`` drawn from a seed: N(0, 0.02), norm
    weights 1 + N(0, 0.02) (so no tensor is all zeros or all ones), word
    embeddings N(0, 1). With those and mean pooling the passages' reps
    differ as a trained model's do; near-equal reps (small embeddings, or
    the [CLS] rep of random layers) make the contrastive gradient a
    difference of near-equal sums, which a 1e-7 change of the weights moves
    by 1e-3 (measured on the CPU), beyond any 1e-5 audit."""
    g = torch.Generator().manual_seed(seed)
    state = {}
    for name, p in module.state_dict().items():
        x = torch.randn(p.shape, generator=g)
        if name.endswith("word_embeddings.weight"):
            state[name] = x
        else:
            state[name] = x * 0.02 + (1.0 if name.endswith("_ln.weight")
                                      else 0.0)
    return state


def seeded_rows(lo: int, hi: int, n_docs: int, dev,
                out=None) -> torch.Tensor:
    """Rows [lo, hi) of the seeded n_docs x 768 bf16 index, made on ``dev``
    (into ``out`` when given) chunk by chunk (chunk c from seed 1000 + c),
    so every rank makes its own rows alike."""
    if out is None:
        out = torch.empty((hi - lo, D), dtype=torch.bfloat16, device=dev)
    for c in range(lo // MESH_CHUNK, -(-hi // MESH_CHUNK)):
        a, b = c * MESH_CHUNK, min((c + 1) * MESH_CHUNK, n_docs)
        g = torch.Generator(device=dev).manual_seed(1000 + c)
        rows = torch.randn((b - a, D), generator=g, device=dev)
        x, y = max(a, lo), min(b, hi)
        out[x - lo:y - lo] = rows[x - a:y - a].to(torch.bfloat16)
        del rows
    return out


def mesh_queries(dev, n: int) -> torch.Tensor:
    g = torch.Generator(device=dev).manual_seed(99)
    return torch.randn((n, D), generator=g, device=dev).to(torch.bfloat16)


def mesh_ms(fn, dev) -> float:
    """Median time of ``fn`` in ms: CUDA events on the card (a search's
    collectives sync the host, so the events span them), the host's clock
    in a CPU rehearsal."""
    if dev.type == "cuda":
        return cuda_time_ms(fn, 1, 5)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1000)
    return float(np.median(times))


def peak_gib(dev) -> float:
    return (torch.cuda.max_memory_allocated() / 2**30
            if dev.type == "cuda" else float("nan"))


def mesh_batch(step: int, vocab: int) -> dict:
    """Step ``step``'s global batch: MESH_Q queries of 32 tokens, MESH_PSG
    passages of 128 each."""
    rng = np.random.default_rng(500 + step)

    def part(n, s):
        ids = rng.integers(1000, vocab, (n, s)).astype(np.int64)
        ids[:, 0] = 101
        return {"input_ids": ids, "attention_mask": np.ones_like(ids)}

    return {"query": part(MESH_Q, Q_LEN), "passage":
            part(MESH_Q * MESH_PSG, P_LEN)}


def mesh_args(dp: int, fields: dict, **extra):
    from openmatch_tpu_torch.config import TrainingArguments

    # adam_epsilon 1e-4: a gradient that is 0 but for float noise (the key
    # bias's) would otherwise become a full +-lr step of either sign
    return TrainingArguments(**dict(
        dict(learning_rate=MESH_LR, weight_decay=0.01, warmup_steps=0,
             warmup_ratio=0.0, adam_epsilon=1e-4, max_grad_norm=1.0,
             seed=0, per_device_train_batch_size=MESH_Q // dp,
             logging_steps=MESH_STEPS, save_steps=0), **fields, **extra))


def mesh_rerank_inputs(vocab: int):
    """2,048 (query, doc) pairs of id-list texts, every pair cut to 128."""
    rng = np.random.default_rng(31)
    queries = {f"q{i}": {"text": rng.integers(1000, vocab, 30).tolist()}
               for i in range(MESH_RR_Q)}
    corpus = {f"d{i}": {"text": rng.integers(1000, vocab, 120).tolist()}
              for i in range(MESH_RR_Q * MESH_RR_D)}
    run = {f"q{i}": {f"d{i * MESH_RR_D + j}": 1.0 for j in range(MESH_RR_D)}
           for i in range(MESH_RR_Q)}
    return queries, corpus, run


def mesh_reranker(model, cfg, mesh=None):
    from openmatch_tpu_torch.config import DataArguments, InferenceArguments
    from openmatch_tpu_torch.retriever.reranker import Reranker

    return Reranker(model, WhitespaceTokenizer(cfg.vocab_size), DataArguments(
        q_max_len=Q_LEN, p_max_len=P_LEN - Q_LEN - 2, query_template="",
        doc_template=""), InferenceArguments(
            per_device_eval_batch_size=MESH_RR_BATCH), mesh=mesh)


def halves_step(trainer, batch) -> float:
    """One update of dp=2 with local negatives, in one process: the mean of
    the two half batches' losses (each half's loss / 2, backward), then the
    optimizer's step. Returns the loss."""
    from openmatch_tpu_torch.parallel.mesh import Mesh, shard_batch

    trainer.model.train()
    trainer.optimizer.zero_grad(set_to_none=True)
    loss = 0.0
    for r in range(2):
        half = shard_batch(batch, Mesh(dp=2, tp=1, rank=r))
        q, p = (trainer._to_device(half[x]) for x in ("query", "passage"))
        part = trainer.loss_fn(trainer._encode_q(q),
                               trainer._encode_p(p)) / 2
        part.backward()
        loss += float(part.detach())
    trainer.optimizer.step()
    trainer.scheduler.step()
    trainer.step += 1
    return loss


def ance_argv(spec, dev, workdir: str) -> list:
    """perf/ance_cycle's arguments for the mesh phase's ANCE run."""
    return [str(MESH_ANCE_DOCS), str(MESH_ANCE_QUERIES), str(MESH_ANCE_STEPS),
            "--model_name_or_path", spec["ance_model"], "--pooling", "mean",
            "--dtype", "float32", "--device", dev.type, "--workdir", workdir]


def mesh_references(dev, cfg, root: str) -> dict:
    """One process on the card, before any rank starts: the training
    references (fp32, TF32 off; "global" over the whole batch, "local" the
    mean of the two half batches' losses), the single-buffer Searcher's
    answer over the seeded index, one-process Reranker scores and one
    process running ANCE's alternating loop (each step dp=2's, as
    ``halves_step`` takes it); written under ``root`` for the ranks.
    Returns the paths and the one-process times."""
    from openmatch_tpu_torch.models.dr_model import DRModel
    from openmatch_tpu_torch.models.rr_model import RRModel
    from openmatch_tpu_torch.ops.mips import Searcher
    from openmatch_tpu_torch.perf import ance_cycle
    from openmatch_tpu_torch.train import dr_trainer
    from openmatch_tpu_torch.train.dr_trainer import DRTrainer

    # sizes travel in the spec: the ranks import this file afresh
    spec = {"root": root, "cfg": dataclasses.asdict(cfg), "n": N_MSMARCO,
            "k": K, "q": MAX_BATCH,
            "sizes": {name: globals()[name] for name in MESH_SIZES}}
    init = seeded_state(DRModel(cfg, pooling="mean"), 14)
    spec["init"] = os.path.join(root, "init.pt")
    torch.save(init, spec["init"])
    for kind in ("global", "local"):
        model = DRModel(cfg, pooling="mean")
        model.load_state_dict(init)
        trainer = DRTrainer(model, mesh_args(1, {}), MESH_STEPS, device=dev)
        losses = []
        for step in range(MESH_STEPS):
            batch = mesh_batch(step, cfg.vocab_size)
            losses.append(float(trainer.train_step(batch))
                          if kind == "global" else halves_step(trainer, batch))
        spec[f"ref_{kind}"] = os.path.join(root, f"ref_{kind}.pt")
        torch.save({"losses": losses, "state": {
            k: v.cpu() for k, v in trainer.model.state_dict().items()}},
            spec[f"ref_{kind}"])
        del trainer, model
    torch.cuda.empty_cache()

    # ANCE: the seeded model as an OpenMatch checkpoint, and the same loop
    # in one process (every step dp=2's mean of the half batches' losses)
    model = DRModel(cfg, pooling="mean")
    model.load_state_dict(init)
    spec["ance_model"] = os.path.join(root, "ance_model")
    model.save(spec["ance_model"])
    del model
    real_step = dr_trainer.DRTrainer.train_step
    dr_trainer.DRTrainer.train_step = halves_step
    try:
        t0 = time.perf_counter()
        ref = ance_cycle.main(ance_argv(spec, dev, os.path.join(
            root, "ance_ref")))
        spec["ance_ref_s"] = time.perf_counter() - t0
    finally:
        dr_trainer.DRTrainer.train_step = real_step
    spec["ance_ref_losses"] = ref["losses"]
    spec["ance_ref_phases"] = ref["phases"]
    del ref
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    index = seeded_rows(0, N_MSMARCO, N_MSMARCO, dev)
    searcher = Searcher(index, k=K, method="kernel")
    q = mesh_queries(dev, MAX_BATCH)
    s, i = searcher.search(q)
    spec["search_ms"] = mesh_ms(lambda: searcher.search(q), dev)
    spec["ref_search"] = os.path.join(root, "ref_search.pt")
    torch.save((s.cpu(), i.cpu()), spec["ref_search"])
    # the served queries' one-process answer: encoded as a RetrievalService
    # encodes them (padded to max_batch), searched in one buffer
    from openmatch_tpu_torch.drivers.serve import RetrievalService

    service = RetrievalService(mesh_serve_model(dev, spec),
                               WhitespaceTokenizer(cfg.vocab_size), searcher,
                               SyntheticDocIds([], N_MSMARCO),
                               q_max_len=Q_LEN, max_batch=MAX_BATCH)
    flat = [x for qs in mesh_serve_requests() for x in qs]
    with torch.inference_mode():
        reps = torch.cat([service.encode_queries(flat[a:a + MAX_BATCH])
                          for a in range(0, len(flat), MAX_BATCH)])
        s, i = searcher.search(reps.contiguous())
    service.close()
    spec["ref_serve"] = os.path.join(root, "ref_serve.pt")
    torch.save((s.cpu(), i.cpu()), spec["ref_serve"])
    del service, searcher, index, s, i, reps
    torch.cuda.empty_cache()

    rr = RRModel(cfg, head_in_dim=cfg.hidden_size)
    rr.load_state_dict(seeded_state(rr, 15))
    spec["rr"] = os.path.join(root, "rr.pt")
    torch.save(rr.state_dict(), spec["rr"])
    reranker = mesh_reranker(rr.to(dev).eval(), cfg)
    inputs = mesh_rerank_inputs(cfg.vocab_size)
    reranker.rerank(*inputs)  # warm
    sync(dev)
    t0 = time.perf_counter()
    scores = reranker.rerank(*inputs)
    sync(dev)
    spec["rerank_pairs_s"] = MESH_RR_Q * MESH_RR_D / (time.perf_counter()
                                                       - t0)
    spec["ref_rerank"] = os.path.join(root, "ref_rerank.pt")
    torch.save(scores, spec["ref_rerank"])
    del rr, reranker
    torch.cuda.empty_cache()

    hf = os.path.join(root, "hf")
    hf_bert_base(np.random.default_rng(16), cfg, hf)
    rng = np.random.default_rng(17)
    with open(os.path.join(root, "train.jsonl"), "w") as f:
        for _ in range(64):
            rows = rng.integers(1000, cfg.vocab_size, (N_PSG, P_LEN - 2))
            f.write(json.dumps({
                "query": rows[0, :Q_LEN - 2].tolist(),
                "positives": [rows[0].tolist()],
                "negatives": rows[1:].tolist()}) + "\n")
    spec["hf"], spec["train"] = hf, os.path.join(root, "train.jsonl")

    # serve.main's small encoded index
    from openmatch_tpu_torch.retriever.encoder import (save_embeddings,
                                                       shard_path)

    spec["small_index"] = os.path.join(root, "small_index")
    rows = np.random.default_rng(18).standard_normal(
        (MESH_SMALL_INDEX, cfg.hidden_size), dtype=np.float32)
    save_embeddings(rows, [f"s{j}" for j in range(MESH_SMALL_INDEX)],
                    shard_path(spec["small_index"], "corpus", 0),
                    num_shards=1)

    # the v1 family on one process
    for mode in MESH_V1_MODES:
        ref = mesh_v1_run(dev, mode, spec["cfg"])
        spec[f"v1_ms_{mode}"] = float(np.median(ref["ms"][1:]))
        spec[f"ref_v1_{mode}"] = os.path.join(root, f"ref_v1_{mode}.pt")
        torch.save(ref, spec[f"ref_v1_{mode}"])
        del ref
    return spec


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.to(got.device)
    scale = want.abs().max().item()
    return (got.float() - want.float()).abs().max().item() / max(scale,
                                                                 1e-30)


def mesh_train(dev, spec, modes: dict) -> dict:
    """Each mode's MESH_STEPS steps on this rank: losses and the full
    parameters against the one-process reference (MESH_REL), and the
    parameters bit-identical on every rank."""
    import torch.distributed as dist

    from openmatch_tpu_torch.models.bert import BertConfig
    from openmatch_tpu_torch.models.dr_model import DRModel
    from openmatch_tpu_torch.parallel.mesh import (broadcast, make_mesh,
                                                   shard_batch)
    from openmatch_tpu_torch.train.dr_trainer import DRTrainer

    cfg = BertConfig(**spec["cfg"])
    init = torch.load(spec["init"], weights_only=True)
    out = {}
    for mode, (dp, tp, fields) in modes.items():
        mesh = make_mesh(dp, tp, dev)
        ref = torch.load(spec["ref_local" if mode == "local"
                              else "ref_global"], weights_only=True,
                         mmap=True)
        model = DRModel(cfg, pooling="mean")
        model.load_state_dict(init)
        trainer = DRTrainer(model, mesh_args(dp, fields), MESH_STEPS,
                            device=dev, mesh=mesh)
        losses, times = [], []
        for step in range(MESH_STEPS):
            batch = shard_batch(mesh_batch(step, cfg.vocab_size), mesh)
            sync(dev)
            t0 = time.perf_counter()
            losses.append(float(trainer.train_step(batch)))
            times.append((time.perf_counter() - t0) * 1000)
        state = trainer.full_state()
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(
            losses, ref["losses"]))
        errs = {k: rel_err(v, ref["state"][k]) for k, v in state.items()}
        worst = max(errs, key=errs.get)
        flat = torch.cat([v.reshape(-1) for v in state.values()])
        theirs = broadcast(flat.clone(), mesh)
        if loss_err > MESH_REL or errs[worst] > MESH_REL:
            raise AssertionError(
                f"mesh {mode}: rank {dist.get_rank()} vs one process: loss "
                f"rel err {loss_err:.3e}, {worst} rel err "
                f"{errs[worst]:.3e} (> {MESH_REL})")
        if not torch.equal(flat, theirs):
            raise AssertionError(f"mesh {mode}: rank {dist.get_rank()}'s "
                                 "parameters differ from rank 0's")
        out[mode] = dict(step_ms=float(np.median(times[1:])), losses=losses,
                         loss_err=loss_err, param_err=errs[worst],
                         worst=worst)
        del trainer, model, state, flat, theirs, ref
        torch.cuda.empty_cache()
    return out


def mesh_driver(dev, spec) -> dict:
    """train_dr's main on every rank for 2 steps; rank 0's saved model,
    loaded in this process, encodes bit-equal to the trained model."""
    from openmatch_tpu_torch.drivers import train_dr
    from openmatch_tpu_torch.models.dr_model import DRModel
    from openmatch_tpu_torch.parallel.mesh import world_size
    from openmatch_tpu_torch.train import dr_trainer

    out_dir = os.path.join(spec["root"], "driver")
    real_step, seen = dr_trainer.DRTrainer.train_step, []

    def step(self, batch):
        seen[:] = [self]
        return real_step(self, batch)

    dr_trainer.DRTrainer.train_step = step
    try:
        result = train_dr.main([
            "--model_name_or_path", spec["hf"], "--output_dir", out_dir,
            "--train_path", spec["train"], "--pooling", "mean",
            "--dtype", "bfloat16", "--per_device_train_batch_size", "4",
            "--train_n_passages", str(N_PSG), "--q_max_len", str(Q_LEN),
            "--p_max_len", str(P_LEN), "--max_steps", "2",
            "--logging_steps", "1", "--negatives_x_device",
            "--learning_rate", str(TRAIN_LR), "--device", dev.type],
            tokenizer=WhitespaceTokenizer(30522))
    finally:
        dr_trainer.DRTrainer.train_step = real_step
    (trainer,) = seen
    if result["final_step"] != 2 or not np.isfinite(result["losses"]).all() \
            or trainer.mesh.shape["data"] != world_size():
        raise AssertionError(f"mesh: train_dr on {world_size()} ranks: "
                             f"{result}")
    same = None
    if trainer.mesh.rank == 0:
        loaded = DRModel.load(out_dir, dtype=torch.bfloat16, device=dev)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in mesh_batch(
            7, spec["cfg"]["vocab_size"])["passage"].items()}
        with torch.inference_mode():
            a = loaded.encode_passage(batch["input_ids"],
                                      batch["attention_mask"])
            b = trainer.model.eval().encode_passage(batch["input_ids"],
                                                    batch["attention_mask"])
        same = torch.equal(a, b)
        if not same:
            raise AssertionError("mesh: rank 0's saved model does not "
                                 "encode bit-equal to the trained model")
    return dict(losses=result["losses"], saved_equal=same)


def hold_mesh_kernels(searcher, q: torch.Tensor) -> dict:
    """The kernels of a mesh Searcher's last search against their plain
    versions on its own operands: the docs partition's K1 and K3 over this
    rank's shard with the shard's valid blocks, the queries partition's K4
    and K5 over the replica's segments for this rank's slice of ``q``; K3
    and K5 at the selection K1 and K4 give. Called after the search's
    launches were read, so these are not counted. Returns each kernel's
    max abs error; on the CPU (the plain path ran) nothing is held."""
    if q.device.type != "cuda":
        return {}
    from openmatch_tpu_torch.ops import cuda_mips as cm
    from openmatch_tpu_torch.ops.mips import (FANOUT, _local_queries,
                                              _select_groups,
                                              pyramid_fanouts)

    mesh, k = searcher.mesh, searcher.k
    tag = f"mesh rank {mesh.rank}, {searcher.partition} partition:"
    if searcher.partition == "docs":
        body = searcher.corpus
        rows = body.shape[0]
        valid = min(max(searcher.n_docs - mesh.data_index * rows, 0), rows)
        nb, k = rows // 8, min(k, rows)
        # _plain_topk_core's masking: the blocks from the partial one on
        nb_valid = valid // 8 if valid < rows else None
        names, gmax, gmax_ref = (("plain_gmax", "gather_rescore"),
                                 cm.fused_plain_gmax, cm.plain_gmax_reference)
    else:
        body = searcher._prep.plain
        q = _local_queries(q, mesh, searcher.axis)
        nb, nb_valid = sum(x.shape[0] for x in body) // 8, None
        names, gmax, gmax_ref = (("plain_gmax_segs", "gather_rescore_seg"),
                                 cm.fused_plain_gmax_segs,
                                 cm.plain_gmax_segs_reference)
    emit_l1 = FANOUT if pyramid_fanouts(nb, k) else 0
    if not emit_l1 or nb // 2 <= k:
        raise AssertionError(f"{tag} {nb} blocks at k={k} do not take the "
                             "K1 path")
    size = f"Q={q.shape[0]} NB={nb} nb_valid={nb_valid}"
    g, l1 = gmax(q, body, emit_l1=emit_l1, nb_valid=nb_valid)
    rg, rl1 = gmax_ref(q, body, emit_l1=emit_l1, nb_valid=nb_valid)
    err = {names[0]: max(compare(f"{tag} {names[0]} {size}", g, rg),
                         compare(f"{tag} {names[0]} l1", l1, rl1))}
    del rg, rl1
    bid = _select_groups(g, k, l1=l1).to(torch.int32)
    err[names[1]] = compare(f"{tag} {names[1]} k={k}",
                            cm.gather_rescore(q, body, bid),
                            cm.gather_rescore_reference(q, body, bid))
    return err


def mesh_search(dev, spec) -> dict:
    """Both partitions over the seeded 8,841,823-row index on this rank:
    "docs" from a host index of which this rank makes and reads only its
    own rows (the whole index never on one device), "queries" with 2
    segments; each search's launches counted, its answer equal to one
    process above the tie band, its time; then its kernels held to their
    plain versions on the Searcher's own operands."""
    from openmatch_tpu_torch.ops import _build
    from openmatch_tpu_torch.ops.mips import (TILE_ROWS, Searcher,
                                              shard_rows_for)
    from openmatch_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(MESH_WORLD, 1, dev)
    n_docs, k = spec["n"], spec["k"]
    ref_s, ref_i = (t.to(dev) for t in torch.load(spec["ref_search"],
                                                  weights_only=True))
    q = mesh_queries(dev, spec["q"])
    out = {"launches": {}, "kernel_err": {}}
    for part in ("docs", "queries"):
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        if part == "docs":
            # a host index, as Retriever hands one over; the Searcher
            # (shard_corpus) reads only this rank's rows, so only they are
            # made: the others' pages are never written or read
            rows = shard_rows_for(n_docs, MESH_WORLD, TILE_ROWS)
            lo = mesh.data_index * rows
            host = torch.empty((n_docs, D), dtype=torch.bfloat16)
            seeded_rows(lo, min(lo + rows, n_docs), n_docs, dev,
                        out=host[lo:lo + rows])
            searcher = Searcher(host, k=k, mesh=mesh, method="kernel")
            del host
            held = searcher.corpus.numel() * 2
        else:
            index = seeded_rows(0, n_docs, n_docs, dev)
            searcher = Searcher(index, k=k, mesh=mesh, method="kernel",
                                partition="queries", n_segs=2)
            del index
            torch.cuda.empty_cache()
            held = sum(s.numel() * 2 for s in searcher._prep.plain)
        searcher.search(q)  # warm
        _build.launches.clear()
        s, i = searcher.search(q)
        sync(dev)
        n = _build.launches.copy()
        want = (("plain_gmax", "gather_rescore") if part == "docs"
                else ("plain_gmax_segs", "gather_rescore_seg"))
        # CPU tensors (a rehearsal) run the plain versions: no launches
        if dev.type == "cuda" and (any(n[x] < 1 for x in want) or any(
                v for x, v in n.items() if x not in want)):
            raise AssertionError(f"mesh {part}: launches {n}")
        for x in want:
            out["launches"][x] = out["launches"].get(x, 0) + n[x]
        same_above_band(f"{part} partition, rank {mesh.rank}", s, i, ref_s,
                        ref_i, phase="mesh")
        out[part] = dict(
            dispatch=searcher.last_dispatch, held_gib=held / 2**30,
            ms=mesh_ms(lambda: searcher.search(q), dev),
            peak_gib=peak_gib(dev))
        out["kernel_err"].update(hold_mesh_kernels(searcher, q))
        out[part]["serve"] = served = mesh_serve(dev, spec, mesh, searcher,
                                                 part)
        n = served["launches"]
        if dev.type == "cuda" and (any(n[x] < 1 for x in want) or any(
                v for x, v in n.items() if x not in want)):
            raise AssertionError(f"mesh serve {part}: launches {n}")
        for x in want:
            out["launches"][x] += n[x]
        del searcher, s, i
        torch.cuda.empty_cache()
    return out


def mesh_rerank(dev, spec) -> dict:
    """Reranker(mesh=) over the 2,048 pairs, fp32 monoBERT-base: the scores
    within MESH_REL x max|score| of one process; pairs/s."""
    from openmatch_tpu_torch.models.bert import BertConfig
    from openmatch_tpu_torch.models.rr_model import RRModel
    from openmatch_tpu_torch.parallel.mesh import make_mesh

    cfg = BertConfig(**spec["cfg"])
    rr = RRModel(cfg, head_in_dim=cfg.hidden_size)
    rr.load_state_dict(torch.load(spec["rr"], weights_only=True))
    reranker = mesh_reranker(rr.to(dev).eval(), cfg,
                             make_mesh(MESH_WORLD, 1, dev))
    inputs = mesh_rerank_inputs(cfg.vocab_size)
    reranker.rerank(*inputs)  # warm
    sync(dev)
    t0 = time.perf_counter()
    got = reranker.rerank(*inputs)
    sync(dev)
    dt = time.perf_counter() - t0
    want = torch.load(spec["ref_rerank"], weights_only=True)
    scale = max(abs(v) for d in want.values() for v in d.values())
    err = max(abs(got[q][d] - v) for q in want for d, v in want[q].items())
    if got.keys() != want.keys() or err > MESH_REL * scale:
        raise AssertionError(f"mesh rerank: max err {err} > {MESH_REL} x "
                             f"{scale}")
    return dict(pairs_s=MESH_RR_Q * MESH_RR_D / dt, err=err, scale=scale,
                batch=reranker.batch_size)


def mesh_serve_requests() -> list:
    """The served requests: MESH_SERVE_CLIENTS of MESH_SERVE_QUERIES."""
    rng = np.random.default_rng(41)
    words = [f"t{i}" for i in range(20000)]
    return [[" ".join(rng.choice(words, rng.integers(3, 9)))
             for _ in range(MESH_SERVE_QUERIES)]
            for _ in range(MESH_SERVE_CLIENTS)]


def mesh_serve_model(dev, spec):
    """The served BERT-base query encoder: the training audit's seeded
    weights, mean pooling, bf16 compute."""
    from openmatch_tpu_torch.models.bert import BertConfig
    from openmatch_tpu_torch.models.dr_model import DRModel

    model = DRModel(BertConfig(**spec["cfg"]), pooling="mean",
                    dtype=torch.bfloat16)
    model.load_state_dict(torch.load(spec["init"], weights_only=True))
    return model.to(dev).eval()


def mesh_serve(dev, spec, mesh, searcher, part: str) -> dict:
    """Serving over the ranks with this rank's mesh Searcher, as serve.main
    runs it: rank 0 a RetrievalService (the BERT-base query encoder,
    max_batch 64, the ControlChannel) behind the HTTP front, answering
    MESH_SERVE_CLIENTS concurrent /search requests at k=1000; the other
    rank follows. Each rank's launches are counted from the warmup to the
    stop; rank 0's answers equal one process's above the tie band."""
    from openmatch_tpu_torch.drivers.serve import (RetrievalService,
                                                   ServingHTTPServer, follow,
                                                   make_handler)
    from openmatch_tpu_torch.ops import _build
    from openmatch_tpu_torch.parallel.mesh import ControlChannel

    channel = ControlChannel(mesh, searcher.dim, searcher.dtype)
    _build.launches.clear()
    if mesh.rank:
        n = follow(searcher, channel)
        sync(dev)
        return {"follower_searches": n, "launches": _build.launches.copy()}
    service = RetrievalService(
        mesh_serve_model(dev, spec), WhitespaceTokenizer(spec["cfg"][
            "vocab_size"]), searcher, SyntheticDocIds([], searcher.n_docs),
        q_max_len=Q_LEN, max_batch=MAX_BATCH, channel=channel)
    requests = mesh_serve_requests()
    try:
        service.warmup()
        service.timeline = []
        service.stats.update(dispatch_groups=0, requests=0, max_coalesced=0)
        server = ServingHTTPServer(("127.0.0.1", 0),
                                   make_handler(service, K))
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            with ThreadPoolExecutor(max_workers=len(requests)) as pool:
                answers = [f.result() for f in [
                    pool.submit(http_json, base + "/search",
                                {"queries": qs, "k": K})
                    for qs in requests]]
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
    finally:
        service.close()  # "stop": the follower returns
    sync(dev)
    launches = _build.launches.copy()
    if any(st != 200 for st, _, _ in answers):
        raise AssertionError(f"mesh serve {part}: HTTP "
                             f"{[st for st, _, _ in answers]}")
    results = [res for _, body, _ in answers for res in body["results"]]
    s, i = answers_tensor(results, lambda d: int(d[3:]), dev)
    ref_s, ref_i = (t.to(dev) for t in torch.load(spec["ref_serve"],
                                                  weights_only=True))
    same_above_band(f"served {part} partition over {mesh.size('world')} "
                    "ranks", s, i, ref_s, ref_i, phase="mesh")
    return {"latency_ms": [sec * 1000 for _, _, sec in answers],
            "launches": launches, "stats": dict(service.stats),
            "dispatches": [(t["rows"], t["exec_s"] * 1000)
                           for t in service.timeline]}


def mesh_serve_main(dev, spec) -> dict:
    """serve.main through its real flags on every rank over the small
    encoded index (queries partition, 2 segments): rank 0's /search
    answered over HTTP, then SIGTERM to rank 0 stops the server and the
    follower; every rank returns from main."""
    import signal
    import socket

    from openmatch_tpu_torch.drivers import serve
    from openmatch_tpu_torch.ops import _build
    from openmatch_tpu_torch.parallel.mesh import world_size

    port, seen = 0, {}
    rank0 = torch.distributed.get_rank() == 0
    if rank0:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]

        def drive():
            base = f"http://127.0.0.1:{port}"
            try:
                end = time.monotonic() + 300
                while True:
                    try:
                        seen["health"] = http_json(base + "/health")[1]
                        break
                    except OSError:
                        if time.monotonic() > end:
                            raise
                        time.sleep(0.2)
                status, body, sec = http_json(base + "/search", {
                    "queries": mesh_serve_requests()[0], "k": 10})
                seen.update(status=status, results=body["results"],
                            ms=sec * 1000)
            except Exception as e:  # noqa: BLE001  (reported below)
                seen["error"] = repr(e)
            finally:
                os.kill(os.getpid(), signal.SIGTERM)

        threading.Thread(target=drive, daemon=True).start()
    _build.launches.clear()
    t0 = time.perf_counter()
    serve.main(["--model_name_or_path", spec["hf"], "--encoded_save_path",
                spec["small_index"], "--port", str(port), "--max_batch", "8",
                "--q_max_len", str(Q_LEN), "--retrieve_depth", "100",
                "--pooling", "mean", "--dtype", "bfloat16",
                "--search_partition", "queries", "--search_n_segs", "2",
                "--search_method", "kernel", "--device", dev.type],
               tokenizer=WhitespaceTokenizer(spec["cfg"]["vocab_size"]))
    sync(dev)
    out = {"launches": _build.launches.copy(),
           "seconds": time.perf_counter() - t0,
           "world": world_size()}
    if rank0:
        if "error" in seen or seen.get("status") != 200:
            raise AssertionError(f"mesh serve.main: {seen}")
        for res in seen["results"]:
            sc = np.array([x["score"] for x in res])
            if len(res) != 10 or not np.isfinite(sc).all() \
                    or (np.diff(sc) > 0).any():
                raise AssertionError("mesh serve.main: a response is not 10 "
                                     "finite non-increasing scores")
        out.update(health=seen["health"], ms=seen["ms"])
    return out


def seed_params(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Every parameter (not the buffers: the kernel matcher's mus and
    sigmas stay) drawn from a seed: embeddings N(0, 1), LayerNorm weights
    1 + N(0, 0.02), the rest N(0, 0.02); returns ``module``."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            x = torch.randn(p.shape, generator=g)
            if name.endswith("embedding") or name.endswith("embeddings.weight"):
                p.copy_(x)
            else:
                p.copy_(x * 0.02 + (1.0 if name.endswith("_ln.weight")
                                    else 0.0))
    return module


def mesh_v1_batch(mode: str, step: int, vocab: int) -> dict:
    """Step ``step``'s global batch of ``mode``: word ranking pairs (query
    and docs ragged under their masks) or BertRanker pos / neg pairs over
    ``vocab`` word pieces."""
    rng = np.random.default_rng(600 + step)
    if mode == "bert":
        out = {}
        for side in ("pos", "neg"):
            ids = rng.integers(1000, vocab, (MESH_BERT_PAIRS, MESH_BERT_LEN))
            ids[:, 0] = 101
            segs = np.zeros_like(ids)
            segs[:, MESH_BERT_LEN // 4:] = 1
            out.update({f"{side}_input_ids": ids,
                        f"{side}_input_mask": np.ones_like(ids),
                        f"{side}_segment_ids": segs})
        return out

    def words(n):
        ids = rng.integers(1, MESH_V1_VOCAB, (MESH_V1_BATCH, n))
        lengths = rng.integers(n // 2, n + 1, MESH_V1_BATCH)
        mask = (np.arange(n)[None] < lengths[:, None]).astype(np.float32)
        return ids * mask.astype(np.int64), mask

    q, qm = words(MESH_V1_QLEN)
    d, dm = words(MESH_V1_DLEN)
    d2, dm2 = words(MESH_V1_DLEN)
    return {"query_idx": q, "query_mask": qm, "doc_pos_idx": d,
            "doc_pos_mask": dm, "doc_neg_idx": d2, "doc_neg_mask": dm2}


def mesh_v1_run(dev, mode: str, cfg: dict, mesh=None) -> dict:
    """MESH_V1_STEPS steps of the v1-family trainer ``mode`` ("knrm" and
    "bert": V1Trainer; "meta": MetaLTRTrainer; "reinfoselect":
    ReInfoSelectTrainer with a Conv-KNRM policy, its draws from a generator
    seeded alike on every rank, one refresh after the second step) on the
    global batches, on one process or over ``mesh``; BertRanker's encoder
    is ``cfg`` (BERT-base on the card). Returns the losses, step ms, meta
    weights or keep decisions, and the parameters."""
    from openmatch_tpu_torch.config import TrainingArguments
    from openmatch_tpu_torch.models.bert import BertConfig
    from openmatch_tpu_torch.train.meta_trainer import MetaLTRTrainer
    from openmatch_tpu_torch.train.reinfoselect_trainer import \
        ReInfoSelectTrainer
    from openmatch_tpu_torch.train.v1_trainer import V1Trainer
    from openmatch_tpu_torch.v1.models import KNRM, BertRanker, ConvKNRM

    model = seed_params(BertRanker(BertConfig(**cfg), task="ranking")
                        if mode == "bert" else
                        KNRM(MESH_V1_VOCAB, V1_EMBED), 20)
    # adam_epsilon 1e-4: Adam would scale a gradient that is 0 but for
    # float noise into a full +-lr step, on one process and the ranks alike
    args = TrainingArguments(learning_rate=MESH_V1_LR, warmup_steps=0,
                             warmup_ratio=0.0, adam_epsilon=1e-4, seed=0,
                             logging_steps=100, save_steps=0)
    kw = {} if mesh is None else {"mesh": mesh}
    policy = generator = None
    if mode == "meta":
        trainer = MetaLTRTrainer(model, args, 10, device=dev, **kw)
    elif mode == "reinfoselect":
        policy = seed_params(ConvKNRM(MESH_V1_VOCAB, V1_EMBED,
                                      task="classification"), 21)
        trainer = ReInfoSelectTrainer(model, policy, args, 10, device=dev,
                                      **kw)
        generator = torch.Generator(device=dev).manual_seed(0)
    else:
        trainer = V1Trainer(model, args, 10, device=dev, **kw)
    out = {"losses": [], "ms": [], "extra": []}
    for step in range(MESH_V1_STEPS):
        batch = mesh_v1_batch(mode, step, cfg["vocab_size"])
        sync(dev)
        t0 = time.perf_counter()
        if mode == "meta":
            loss, extra = trainer.train_step(batch, mesh_v1_batch(
                mode, 100 + step, cfg["vocab_size"]))
        elif mode == "reinfoselect":
            loss, extra = trainer.train_step(batch, generator)
        else:
            loss, extra = trainer.train_step(batch), None
        out["losses"].append(float(loss))
        out["ms"].append((time.perf_counter() - t0) * 1000)
        if extra is not None:
            out["extra"].append(extra.cpu())
        if mode == "reinfoselect" and step == 1:
            trainer.refresh_policy(MESH_RIS_REWARD)
    out["state"] = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    if policy is not None:
        out["policy"] = {k: v.detach().cpu()
                         for k, v in policy.state_dict().items()}
    del trainer, model, policy
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def tol_ratio(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / (MESH_REL + MESH_REL x |want|) over the entries:
    at most 1 where ``allclose`` with rtol = atol = MESH_REL holds (the CPU
    tests' tolerance; a one-entry bias whose pairwise-loss gradient nearly
    cancels is held absolutely, not to its own tiny scale)."""
    want = want.to(got.device).float()
    return ((got.float() - want).abs()
            / (MESH_REL + MESH_REL * want.abs())).max().item()


def mesh_v1(dev, spec) -> dict:
    """The v1 family over 2 ranks against the one-process references: the
    loss within MESH_REL, every parameter (the policy's too) within rtol =
    atol = MESH_REL (``tol_ratio`` <= 1), the meta weights within
    META_W_ATOL, the keep decisions equal, and the parameters bit-identical
    on both ranks."""
    import torch.distributed as dist

    from openmatch_tpu_torch.parallel.mesh import broadcast, make_mesh

    mesh = make_mesh(MESH_WORLD, 1, dev)
    out = {}
    for mode in MESH_V1_MODES:
        got = mesh_v1_run(dev, mode, spec["cfg"], mesh)
        ref = torch.load(spec[f"ref_v1_{mode}"], weights_only=True,
                         mmap=True)
        loss_err = max(abs(a - b) / max(abs(b), 1e-30)
                       for a, b in zip(got["losses"], ref["losses"]))
        errs = {f"{part}.{k}": tol_ratio(v, ref[part][k])
                for part in ("state", "policy") if part in got
                for k, v in got[part].items() if v.is_floating_point()}
        worst = max(errs, key=errs.get)
        res = dict(losses=got["losses"], step_ms=float(np.median(
            got["ms"][1:])), loss_err=loss_err, param_err=errs[worst],
            worst=worst)
        if mode == "meta":
            res["weight_err"] = max(
                (a - b).abs().max().item()
                for a, b in zip(got["extra"], ref["extra"]))
        if mode == "reinfoselect":
            res["decisions_equal"] = all(torch.equal(a, b) for a, b in zip(
                got["extra"], ref["extra"]))
            res["kept"] = [int(a.sum()) for a in got["extra"]]
        flat = torch.cat([v.reshape(-1).float() for part in ("state",
                                                             "policy")
                          if part in got for v in got[part].values()])
        same = torch.equal(flat, broadcast(flat.clone(), mesh))
        if loss_err > MESH_REL or errs[worst] > 1.0 \
                or res.get("weight_err", 0.0) > META_W_ATOL \
                or not res.get("decisions_equal", True) or not same:
            raise AssertionError(
                f"mesh v1 {mode}: rank {dist.get_rank()} vs one process: "
                f"{res}; parameters equal to rank 0's: {same}")
        out[mode] = res
        del got, ref, flat
    return out


def same_on_ranks(model, mesh) -> bool:
    """Whether this rank's parameters equal rank 0's bit for bit (one
    broadcast of them all, flat)."""
    from openmatch_tpu_torch.parallel.mesh import broadcast

    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    return torch.equal(flat, broadcast(flat.clone(), mesh))


def mesh_ance(dev, spec) -> dict:
    """perf/ance_cycle's main on this rank over the ranks (DRTrainer(mesh=),
    the refresh through the docs-partitioned Retriever(mesh=),
    write_ann_data(mesh=)): the parameters bit-identical across ranks after
    each generation (checked as each refresh builds its Retriever, and at
    the end), generation 0's losses within MESH_REL of one process running
    the same loop, ann_training_data_0 published once with no .tmp left,
    every mined negative inside the fp32 audit's top 200 (the tie band
    added) over this rank's own trained encoder, and the refresh's search
    launching the gmax kernel (K1, or K2 where this rank's shard is too
    small for a pyramid level) and K3 on this rank."""
    import hashlib

    import torch.distributed as dist

    from openmatch_tpu_torch.ops import _build
    from openmatch_tpu_torch.ops.mips import (TILE_ROWS, pyramid_fanouts,
                                              shard_rows_for)
    from openmatch_tpu_torch.perf import ance_cycle
    from openmatch_tpu_torch.retriever import retriever as rmod

    rank = dist.get_rank()
    identical = []
    real = rmod.Retriever

    class Checked(real):
        """The refresh's Retriever: the ranks' replicas compared first."""

        def __init__(self, model, *args, **kw):
            super().__init__(model, *args, **kw)
            identical.append(same_on_ranks(model, kw["mesh"]))

    workdir = os.path.join(spec["root"], "ance")
    _build.launches.clear()
    sync(dev)
    t0 = time.perf_counter()
    rmod.Retriever = Checked
    try:
        cycle = ance_cycle.main(ance_argv(spec, dev, workdir))
    finally:
        rmod.Retriever = real
    sync(dev)
    seconds = time.perf_counter() - t0
    launches = _build.launches.copy()
    trainer = cycle.pop("trainer")
    identical.append(same_on_ranks(trainer.model, trainer.mesh))
    del trainer
    if cycle["ranks"] != MESH_WORLD or identical != [True, True]:
        raise AssertionError(f"mesh ance: rank {rank} of {cycle['ranks']}: "
                             f"parameters equal to rank 0's after each "
                             f"generation {identical}")
    steps = MESH_ANCE_STEPS
    ref = spec["ance_ref_losses"][:steps]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(
        cycle["losses"][:steps], ref))
    if loss_err > MESH_REL or not np.isfinite(cycle["losses"]).all():
        raise AssertionError(f"mesh ance: rank {rank} generation 0 losses "
                             f"{cycle['losses'][:steps]} vs one process "
                             f"{ref}: rel err {loss_err:.3e} > {MESH_REL}")
    listing = sorted(os.listdir(cycle["ann_dir"]))
    if listing != ["ann_training_data_0"]:
        raise AssertionError(f"mesh ance: ann_dir holds {listing}")
    with open(cycle["refresh"]["path"], "rb") as f:
        sha = hashlib.sha256(f.read()).hexdigest()
    mined = audit_mined(dev, cycle["refresh"], cycle["qrels"],
                        ance_cycle.TOPK_TRAINING)
    nb = shard_rows_for(MESH_ANCE_DOCS, MESH_WORLD, TILE_ROWS) // 8
    gmax = "K1" if pyramid_fanouts(nb, ance_cycle.TOPK_TRAINING) else "K2"
    if dev.type == "cuda" and (launches["plain_gmax"] < 1
                               or launches["gather_rescore"] < 1):
        raise AssertionError(f"mesh ance: rank {rank}'s refresh launched "
                             f"{launches}, not {gmax} and K3")
    return dict(seconds=seconds, phases=cycle["phases"],
                losses=cycle["losses"], loss_err=loss_err, sha=sha,
                mined=mined, gmax=gmax, shard_blocks=nb,
                launches={"gmax": launches["plain_gmax"],
                          "gather_rescore": launches["gather_rescore"]},
                peak_gib=peak_gib(dev))


def mesh_rank(dev, spec) -> dict:
    """One rank of the mesh phase (``spawn_ranks`` runs it in a fresh
    process that initialised CUDA and joined the group itself)."""
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    globals().update(spec["sizes"])
    t0 = time.perf_counter()
    out = {"rank": dist.get_rank(), "backend": dist.get_backend(),
           "device": str(dev)}
    out["train"] = mesh_train(dev, spec, MESH_MODES)
    out["driver"] = mesh_driver(dev, spec)
    out["search"] = mesh_search(dev, spec)
    out["serve_main"] = mesh_serve_main(dev, spec)
    out["rerank"] = mesh_rerank(dev, spec)
    out["v1"] = mesh_v1(dev, spec)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    out["ance"] = mesh_ance(dev, spec)
    out["seconds"] = time.perf_counter() - t0
    return out


def mesh_rank4(dev, spec) -> dict:
    """The dp = 2 x tp = 2 training audit on four cards."""
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"backend": dist.get_backend(),
            "train": mesh_train(dev, spec, MESH_MODES_4)}


def phase_mesh(dev, smi: str, cfg=None) -> dict:
    """The port's multi-rank paths on MESH_WORLD ranks (one process each,
    spawned; gloo when they share this card): DRTrainer in every mode,
    train_dr's main, both Searcher partitions over the 8.8M index and
    Reranker(mesh=), each against one process on the card. Returns the
    ranks' kernel launches on the mesh search's main path."""
    from openmatch_tpu_torch.models.bert import BertConfig
    from openmatch_tpu_torch.ops import _build
    from openmatch_tpu_torch.parallel.mesh import spawn_ranks

    cfg = cfg or BertConfig()
    cuda = dev.type == "cuda"
    if cuda:
        _build.load_library()  # the ranks load this build; none builds one
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        spec = mesh_references(dev, cfg, root)
        log(f"mesh: one-process references in {time.perf_counter() - t0:.2f}"
            f" s: search {spec['search_ms']:.3f} ms (Q={MAX_BATCH}, k={K}, "
            f"{N_MSMARCO} docs, one buffer), rerank "
            f"{spec['rerank_pairs_s']:.1f} pairs/s ({smi})")
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = spawn_ranks(mesh_rank, MESH_WORLD, args=(spec,),
                            device=dev.type, timeout_s=MESH_TIMEOUT)
        wall = time.perf_counter() - t0
        four = None
        if cuda and torch.cuda.device_count() >= 4:
            four = spawn_ranks(mesh_rank4, 4, args=(spec,), device="cuda",
                               timeout_s=MESH_TIMEOUT)
    r0 = ranks[0]
    shared = len({r["device"] for r in ranks}) == 1
    label = (f"({smi}; {r0['backend']}, {MESH_WORLD} ranks on "
             + ("one card)" if shared else f"{MESH_WORLD} cards)"))
    log(f"mesh: backend {r0['backend']}, world {MESH_WORLD}, devices "
        f"{[r['device'] for r in ranks]}; the ranks ran {wall:.2f} s from "
        f"spawn to join {label}")
    for mode, (dp, tp, _) in MESH_MODES.items():
        t = [r["train"][mode] for r in ranks]
        log(f"mesh: train {mode} (dp={dp}, tp={tp}, BERT-base fp32, "
            f"{MESH_Q} x {MESH_PSG} global batch): step ms by rank "
            f"{[round(x['step_ms'], 3) for x in t]}, losses "
            f"{t[0]['losses']}, loss rel err {max(x['loss_err'] for x in t):.3e}"
            f", worst parameter rel err "
            f"{max(x['param_err'] for x in t):.3e} ({t[0]['worst']}); "
            f"parameters bit-identical across ranks {label}")
    if four:
        t = four[0]["train"]["dp2_tp2"]
        log(f"mesh: train dp2_tp2 on 4 cards ({four[0]['backend']}): step "
            f"{t['step_ms']:.3f} ms, loss rel err {t['loss_err']:.3e}, "
            f"parameter rel err {t['param_err']:.3e} ({smi})")
    log(f"mesh: train_dr on {MESH_WORLD} ranks (2 steps, dp=2): losses "
        f"{r0['driver']['losses']}; rank 0's saved model encodes bit-equal "
        "to the trained one")
    launches = {}
    for part in ("docs", "queries"):
        x = [r["search"][part] for r in ranks]
        log(f"mesh: search {part} partition ({x[0]['dispatch']}, Q="
            f"{MAX_BATCH}, k={K}, {N_MSMARCO} x {D} bf16): ms by rank "
            f"{[round(v['ms'], 3) for v in x]} (CUDA events; one process "
            f"{spec['search_ms']:.3f} ms), each rank holds "
            f"{x[0]['held_gib']:.2f} GiB, peaks "
            f"{[round(v['peak_gib'], 2) for v in x]} GiB {label}")
    for part in ("docs", "queries"):
        x = ranks[0]["search"][part]["serve"]
        log(f"mesh: served {part} partition over {MESH_WORLD} ranks (rank 0 "
            f"encodes, BERT-base bf16; {MESH_SERVE_CLIENTS} concurrent "
            f"clients x {MESH_SERVE_QUERIES} queries, k={K}, max_batch "
            f"{MAX_BATCH}, {N_MSMARCO} x {D} bf16): request ms "
            f"{[round(v, 1) for v in x['latency_ms']]}; dispatches (rows, "
            f"exec ms) {[(a, round(b, 1)) for a, b in x['dispatches']]}; "
            f"service {x['stats']}; the follower ran "
            f"{ranks[1]['search'][part]['serve']['follower_searches']} "
            f"searches; equal to one process above the tie band {label}")
    for r in ranks:
        for k, n in r["search"]["launches"].items():
            launches[k] = launches.get(k, 0) + n
        for k in ("plain_gmax_segs", "gather_rescore_seg"):
            launches[k] = launches.get(k, 0) + r["serve_main"]["launches"][k]
    m = ranks[0]["serve_main"]
    log(f"mesh: serve.main on {m['world']} ranks (queries partition, 2 "
        f"segments, {MESH_SMALL_INDEX} docs, BERT-base from an HF "
        f"directory): /health {m['health']}, one /search of "
        f"{MESH_SERVE_QUERIES} queries in {m['ms']:.1f} ms, stopped by "
        f"SIGTERM after {[round(r['serve_main']['seconds'], 2) for r in ranks]}"
        f" s; launches by rank "
        f"{[r['serve_main']['launches'] for r in ranks]}")
    log(f"mesh: kernel launches on the mesh searches and served searches, "
        f"summed over ranks: "
        f"{launches}; kernel vs plain max abs err by rank "
        f"{[r['search']['kernel_err'] for r in ranks]}")
    rr = [r["rerank"] for r in ranks]
    log(f"mesh: Reranker(mesh=) {MESH_RR_Q * MESH_RR_D} pairs at S={P_LEN}, "
        f"batch {rr[0]['batch']}: {rr[0]['pairs_s']:.1f} pairs/s (one "
        f"process {spec['rerank_pairs_s']:.1f}), max err "
        f"{max(x['err'] for x in rr):.3e} of max|score| {rr[0]['scale']:.3e}"
        f" {label}")
    for mode in MESH_V1_MODES:
        t = [r["v1"][mode] for r in ranks]
        extra = ""
        if mode == "meta":
            extra = (f", meta weight max abs err "
                     f"{max(x['weight_err'] for x in t):.3e}")
        if mode == "reinfoselect":
            extra = (f", keep decisions equal to one process "
                     f"{all(x['decisions_equal'] for x in t)} (kept "
                     f"{t[0]['kept']} of {MESH_V1_BATCH} a step)")
        log(f"mesh: v1 {mode} (dp=2; {MESH_V1_STEPS} steps, global batch "
            f"{MESH_BERT_PAIRS if mode == 'bert' else MESH_V1_BATCH} pairs, "
            + ("BertRanker BERT-base fp32" if mode == "bert" else
               f"KNRM {MESH_V1_VOCAB} x {V1_EMBED}")
            + f"): step ms by rank {[round(x['step_ms'], 1) for x in t]} "
            f"(one process {spec['v1_ms_' + mode]:.1f}), losses "
            f"{t[0]['losses']}, loss rel err "
            f"{max(x['loss_err'] for x in t):.3e}, worst parameter error "
            f"{max(x['param_err'] for x in t):.3f} of its tolerance "
            f"(rtol = atol = {MESH_REL}; {t[0]['worst']})"
            f"{extra}; parameters bit-identical across ranks {label}")
    a = [r["ance"] for r in ranks]
    if a[0]["sha"] != a[1]["sha"]:
        raise AssertionError("mesh ance: the ranks read different bytes of "
                             "ann_training_data_0")
    per_step = [round(x["phases"]["train_gen_s"] / MESH_ANCE_STEPS * 1000, 1)
                for x in a]
    log(f"mesh: ANCE alternating over {MESH_WORLD} ranks (perf/ance_cycle, "
        f"BERT-base fp32, mean pooling, {MESH_ANCE_DOCS} docs of 128, "
        f"{MESH_ANCE_QUERIES} queries of 32, 2 generations x "
        f"{MESH_ANCE_STEPS} steps of 8 x 8): seconds by rank "
        f"{[round(x['seconds'], 2) for x in a]}, rank 0's phases "
        + ", ".join(f"{k} {v:.3f}" for k, v in a[0]["phases"].items())
        + f"; ms a step by rank {per_step}; losses {a[0]['losses']}, "
        f"generation 0 rel err vs one process "
        f"{max(x['loss_err'] for x in a):.3e} (one process: "
        f"{spec['ance_ref_s']:.2f} s, phases "
        + ", ".join(f"{k} {v:.3f}" for k, v in
                    spec["ance_ref_phases"].items())
        + f"); parameters bit-identical across ranks after each generation; "
        f"ann_training_data_0 published once (sha256 {a[0]['sha'][:16]} on "
        f"both ranks, no .tmp); {a[0]['mined']} mined negatives a rank pass "
        f"the fp32 audit; the refresh's search launched by rank "
        f"{[x['launches'] for x in a]} ({a[0]['gmax']} for the gmax: "
        f"{a[0]['shard_blocks']} blocks a shard at k=200); peaks "
        f"{[round(x['peak_gib'], 2) for x in a]} GiB {label}")
    for x in a:
        if x["gmax"] == "K1":
            launches["plain_gmax"] = launches.get("plain_gmax", 0) \
                + x["launches"]["gmax"]
        launches["gather_rescore"] = launches.get("gather_rescore", 0) \
            + x["launches"]["gather_rescore"]
    log(f"mesh: rank seconds {[round(r['seconds'], 2) for r in ranks]}")
    mesh_perf_twins(dev, smi)
    return launches


def mesh_perf_twins(dev, smi: str):
    """The mesh paths' perf twins at short settings, through their
    ``main(argv)``: mesh_parity at its defaults (2,210,456 docs, Q=128,
    k=1000), sharded_merge over 2 ranks at the TPU script's sizes, and
    serve_load for 5 s over 1,000,000 docs."""
    from openmatch_tpu_torch.perf import mesh_parity, serve_load, sharded_merge

    if dev.type != "cuda":  # a CPU rehearsal: the CPU tests run them
        return
    t0 = time.perf_counter()
    p = mesh_parity.main([])
    log(f"mesh: perf/mesh_parity: direct {p['direct_ms']:.3f} ms, mesh "
        f"{p['mesh_ms']:.3f} ms ({p['dispatch']}), ratio {p['ratio']:.3f} "
        f"({'done' if p['done'] else 'above 5%'}), max score diff "
        f"{p['max_score_diff']:.3e} ({smi})")
    m = sharded_merge.main(["--world", str(MESH_WORLD)])
    log(f"mesh: perf/sharded_merge ({MESH_WORLD} ranks on "
        f"{'one card' if torch.cuda.device_count() < MESH_WORLD else 'cards'}"
        f", kernel path, {m['shard_rows']} rows x {m['dim']} a rank): "
        + "; ".join(f"Q={r['Q']} k={r['k']} full {r['t_full_ms']:.3f} ms, "
                    f"sharded {r['t_sharded_ms']:.3f} ms"
                    for r in m["rows"]) + f" ({smi})")
    gc.collect()
    torch.cuda.empty_cache()
    out = serve_load.main(["--mode", "search", "--n-docs", "1000000",
                           "--concurrency", "32", "--duration", "5",
                           "--port", "0"])
    log(f"mesh: perf/serve_load (one card, 1,000,000 docs, 32 clients, "
        f"5 s): {json.dumps(out)} ({smi})")
    log(f"mesh: perf twins {time.perf_counter() - t0:.2f} s")


GRAPH_GAP = 0.0  # graph against eager, over max |rep|: the same kernels


def call_ms(fn, reps: int = 20) -> float:
    """Median ms of ``fn()`` to a synchronise, host clock."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def host_ms(fn, reps: int = 20) -> float:
    """Median host ms of ``fn()`` to its return, the card idle before."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return float(np.median(times))


def phase_graphs(dev) -> dict:
    from openmatch_tpu_torch.models.bert import BertConfig
    from openmatch_tpu_torch.models.dr_model import DRModel

    for name, backbone, cfg, rows, cols, is_query in (
            ("bert-base", "bert", BertConfig(), MAX_BATCH, 32, True),
            ("t5-base", "t5_encdec", t5_base(), 128, 128, False)):
        with torch.device(dev):
            model = DRModel(cfg, backbone, dtype=torch.bfloat16)
        model.load_state_dict(seeded_state(model, 0))
        model.eval()
        g = torch.Generator(device=dev).manual_seed(1)
        gaps, equal = [], True
        with torch.inference_mode():
            for _ in range(3):
                ids = torch.randint(1, cfg.vocab_size, (rows, cols),
                                    generator=g, device=dev)
                lens = torch.randint(cols // 4, cols + 1, (rows, 1),
                                     generator=g, device=dev)
                mask = (torch.arange(cols, device=dev) < lens).long()
                ids = ids * mask
                got = model.encode(ids, mask, is_query=is_query)
                want = model.encode_eager(ids, mask, is_query=is_query)
                equal = equal and torch.equal(got, want)
                gaps.append(float((got.float() - want.float()).abs().max()
                                  / want.float().abs().max()))
            eager = call_ms(lambda: model.encode_eager(ids, mask, is_query))
            graph = call_ms(lambda: model.encode(ids, mask, is_query))
            eager_host = host_ms(
                lambda: model.encode_eager(ids, mask, is_query))
            graph_host = host_ms(lambda: model.encode(ids, mask, is_query))
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]):
                traced_host = host_ms(
                    lambda: model.encode(ids, mask, is_query))
        log(f"graphs: {name} [{rows}, {cols}] graph against eager: largest "
            f"gap / max|rep| {max(gaps):.3e} (limit {GRAPH_GAP}), "
            f"bit-equal {equal}; {model.graph_stats}; eager "
            f"{eager:.3f} ms, graph {graph:.3f} ms a call; the host's ms "
            f"to the call's return: {eager_host:.3f} eager, {graph_host:.3f} "
            f"as a graph, {traced_host:.3f} as a graph under torch.profiler")
        if max(gaps) > GRAPH_GAP or model.graph_stats["captures"] != 1:
            raise AssertionError(f"graphs: {name}: the graph's reps are "
                                 "not the eager ones")
        if backbone == "t5_encdec":
            step = model.encoder_q
            hidden = torch.randn(rows, 1, cfg.d_model, generator=g,
                                 device=dev).to(torch.bfloat16)
            old = torch.tensor(cfg.d_model ** -0.5, dtype=torch.bfloat16,
                               device=dev)
            same = torch.equal(hidden * step.lm_scale, hidden * old)
            log(f"graphs: T5's tied-head scale {step.lm_scale!r} on the "
                f"host against the card's bf16 scalar: bit-equal {same}")
            if not same:
                raise AssertionError("graphs: T5's head scale moved")
        del model
    return {}


MOE_ROWS, MOE_LEN, MOE_REAL = 64, 512, 13_400  # the encode cell's batch
MOE_REL = 2.0**-7  # kernel against plain, over max|out|: both round fp32
#                    sums to bf16 (2^-8 each), taken in other orders


def moe_offsets(n_rows: int, E: int, g) -> torch.Tensor:
    """[E + 1] int32 offsets of ``n_rows`` routed slots over E experts with
    a router's skew (expert shares in proportion to squared uniforms)."""
    share = torch.rand(E, generator=g).square()
    counts = torch.multinomial(share, n_rows, replacement=True,
                               generator=g).bincount(minlength=E)
    return torch.cat([torch.zeros(1, dtype=torch.long),
                      counts.cumsum(0)]).to(torch.int32)


def uniform_offsets(n_rows: int, E: int) -> torch.Tensor:
    """[E + 1] int32 offsets of ``n_rows`` routed slots spread evenly over
    E experts."""
    counts = torch.full((E,), n_rows // E, dtype=torch.long)
    counts[:n_rows % E] += 1
    return torch.cat([torch.zeros(1, dtype=torch.long),
                      counts.cumsum(0)]).to(torch.int32)


def library_grouped_ms(x, w, offsets):
    """``torch._grouped_mm`` on the same rows and weights, where this
    torch has it and takes them: (ms, max abs gap to the kernel's rows)."""
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return None, None
    ends = offsets[1:].contiguous()
    try:
        out = fn(x, w.transpose(-2, -1), offs=ends, out_dtype=torch.bfloat16)
        ms = kernel_ms(lambda: fn(x, w.transpose(-2, -1), offs=ends,
                                  out_dtype=torch.bfloat16))
    except (RuntimeError, TypeError) as e:
        log(f"moe: torch._grouped_mm refused the operands "
            f"({type(e).__name__}: {str(e).splitlines()[0][:120]})")
        return None, None
    return ms, out


def phase_moe(dev) -> tuple:
    """The grouped expert GEMM against its plain version at the encode
    cell's shapes, and a published-width DeepSeek-V3 tower of one dense
    and one MoE layer as a CUDA graph against eager. Returns K12's row
    (err, ms, plain ms, (bound ms, bound by), library ms) of the gate-and-up
    product under the skewed routing, and K12's launches on the main path,
    the tower's encodes. A graph replay runs no Python and is not counted,
    so that count comes from the tower's eager calls and its one capture
    (the capture's eager warm-up run and the captured run); the timing
    loops' launches are left out."""
    from openmatch_tpu_torch.models.deepseek_v3 import DeepseekV3Config
    from openmatch_tpu_torch.models.dr_model import DRModel
    from openmatch_tpu_torch.ops import _build
    from openmatch_tpu_torch.ops.grouped_gemm import (grouped_gemm,
                                                      grouped_gemm_plain)

    _build.load_library()
    usage = _build.ptxas_usage(_build.build_info["log"],
                               "grouped_gemm_kernel")
    for name, u in usage.items():
        log(f"moe: ptxas {name}: {u}")
    if not usage or any(u.get("stack_frame") != 0 or u.get("spill_stores")
                        or u.get("spill_loads") for u in usage.values()):
        raise AssertionError(f"moe: grouped_gemm_kernel has a stack frame "
                             f"or spills, or ptxas's report is missing: "
                             f"{usage}")
    cfg = DeepseekV3Config(num_hidden_layers=2)
    E, d, w_ = cfg.n_routed_experts, cfg.hidden_size, cfg.moe_intermediate_size
    g = torch.Generator().manual_seed(0)
    gd = torch.Generator(device=dev).manual_seed(0)
    M = MOE_ROWS * MOE_LEN * cfg.num_experts_per_tok
    routed = MOE_REAL * cfg.num_experts_per_tok
    routings = (("skewed", moe_offsets(routed, E, g).to(dev)),
                ("uniform", uniform_offsets(routed, E).to(dev)))
    row = None
    for label, N, K in (("gate_up", 2 * w_, d), ("down", d, w_)):
        x = torch.randn(M, K, generator=gd, device=dev).bfloat16()
        w = (torch.randn(E, N, K, generator=gd, device=dev) * 0.02).bfloat16()
        for routing, offsets in routings:
            real = int(offsets[-1])
            got = grouped_gemm(x, w, offsets)
            torch.cuda.synchronize()
            want = grouped_gemm_plain(x, w, offsets)
            err = float((got[:real].float() - want[:real].float()).abs()
                        .max())
            scale = float(want[:real].float().abs().max())
            if not err <= MOE_REL * scale:
                raise AssertionError(f"moe: grouped_gemm {label} {routing}: "
                                     f"max abs err {err} > {MOE_REL} * "
                                     f"{scale}")
            ms = kernel_ms(lambda: grouped_gemm(x, w, offsets))
            plain = kernel_ms(lambda: grouped_gemm_plain(x, w, offsets), 1, 3)
            b = bound(E * N * K * 2 + real * (K + N) * 2, 2.0 * real * N * K)
            lib_ms, lib = library_grouped_ms(x, w, offsets)
            lib_gap = (float((lib[:real].float() - got[:real].float()).abs()
                             .max()) if lib is not None else None)
            lib_txt = ("None" if lib_ms is None else
                       f"{lib_ms:.3f} ms ({100 * b[0] / lib_ms:.1f}% of the "
                       f"bound)")
            log(f"moe: grouped_gemm {label} {routing} [{M} rows, {real} "
                f"routed] x [{E}, {N}, {K}]: kernel {ms:.3f} ms, bound "
                f"{b[0]:.3f} ms ({b[1]}), {100 * b[0] / ms:.1f}% of it; "
                f"plain {plain:.3f} ms; torch._grouped_mm (library_ms) "
                f"{lib_txt}, its max gap to the kernel {lib_gap}; max abs "
                f"err {err:.3e}")
            if row is None:  # the table's row: gate_up under the skew
                row = (err, ms, plain, b, lib_ms)
            del got, want, lib
        del x, w
    with torch.device(dev):
        model = DRModel(cfg, "deepseek_v3", pooling="last", normalize=True,
                        dtype=torch.bfloat16)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "layernorm" in name or name.endswith("norm.weight"):
                continue
            p.normal_(0.0, 0.02, generator=gd)
        for layer in model.encoder_q.layers[1:]:
            layer.mlp.gate.e_score_correction_bias.normal_(0.0, 0.05,
                                                          generator=gd)
    model.eval()
    gaps, equal = [], True
    _build.launches.clear()
    with torch.inference_mode():
        for _ in range(3):
            ids = torch.randint(0, cfg.vocab_size, (MOE_ROWS, MOE_LEN),
                                generator=gd, device=dev)
            # about MOE_REAL real tokens a batch, as the cell's, so each
            # batch fits the packed stream and replays the graph
            lens = torch.randint(32, 2 * MOE_REAL // MOE_ROWS - 31,
                                 (MOE_ROWS, 1), generator=gd, device=dev)
            mask = (torch.arange(MOE_LEN, device=dev) < lens).long()
            got = model.encode(ids, mask)
            want = model.encode_eager(ids, mask)
            equal = equal and torch.equal(got, want)
            gaps.append(float((got.float() - want.float()).abs().max()))
        tower_launches = _build.launches["grouped_gemm"]
        enc = model.encoder_q
        enc.reset_expert_slots()
        model.encode(ids, mask)
        slots = int(enc.expert_slots.sum())
        eager = call_ms(lambda: model.encode_eager(ids, mask))
        graph = call_ms(lambda: model.encode(ids, mask))
    want_slots = cfg.num_experts_per_tok * int(mask.sum())
    log(f"moe: DeepSeek-V3 tower (1 dense + 1 MoE layer, published widths) "
        f"[{MOE_ROWS}, {MOE_LEN}] graph against eager: largest gap "
        f"{max(gaps):.3e} (limit {GRAPH_GAP}), bit-equal {equal}; "
        f"{model.graph_stats}; one replay counted {slots} routed slots "
        f"(want {want_slots}); eager {eager:.3f} ms, graph {graph:.3f} ms a "
        f"call; grouped_gemm launches in the tower's encodes "
        f"{tower_launches}")
    if not equal or model.graph_stats["captures"] != 1 \
            or slots != want_slots:
        raise AssertionError("moe: the graph's reps or counter are not the "
                             "eager ones")
    del model
    return {"grouped_gemm": row}, {"grouped_gemm": tower_launches}


PHASES = ("device", "build", "kernels", "serve", "perf", "stages", "train",
          "rerank", "ance", "beir", "v1", "research", "twins", "mesh",
          "graphs", "moe")


LEFT_BYTES = 2**30  # what a phase may leave allocated for the next


def run_phase(name: str, fn, *args):
    """Run one phase with the peak allocation counter reset first; log what
    was allocated at its start, its peak, what it left allocated and its
    wall time."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = fn(*args)
    # a served phase's services stay reachable from the HTTP handler class
    # make_handler built (its methods close over them), and classes sit in
    # reference cycles: only the cyclic collector frees them, and with them
    # the index
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated()
    log(f"memory: phase {name}: {start / 2**30:.2f} GiB allocated at its "
        f"start, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"{left / 2**30:.2f} GiB at its end; wall time "
        f"{time.perf_counter() - t0:.2f} s")
    if left > LEFT_BYTES:
        raise AssertionError(f"phase {name} left {left / 2**30:.2f} GiB "
                             "allocated")
    return out


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
        run_phase("kernels", phase_kernels, dev)
    rows, launches, replay = {}, {}, []

    def merge(r, n):
        rows.update(r)
        for kernel, count in n.items():
            launches[kernel] = launches.get(kernel, 0) + count

    if "serve" in phases:
        merge(*run_phase("serve", phase_serve, dev, replay))
    if "perf" in phases:
        merge(*run_phase("perf", phase_perf, dev))
    if "stages" in phases and replay:
        run_phase("stages", phase_stages, dev, replay)
    # the chains' retrieves add their K1 and K3 launches to the table's
    # (the twins phase its pipeline's retrieve stage's), the mesh phase
    # its ranks' K1, K3, K4 and K5
    for name, fn, args in (("train", phase_train, ()),
                           ("rerank", phase_rerank, ()),
                           ("ance", phase_ance, ()), ("beir", phase_beir, ()),
                           ("v1", phase_v1, ()),
                           ("research", phase_research, ()),
                           ("twins", phase_twins, ()),
                           ("mesh", phase_mesh, (info["smi"],)),
                           ("graphs", phase_graphs, ())):
        if name in phases:
            merge({}, run_phase(name, fn, dev, *args))
    if "moe" in phases:
        merge(*run_phase("moe", phase_moe, dev))
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
