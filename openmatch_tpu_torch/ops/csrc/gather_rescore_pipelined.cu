// gather_rescore_pipelined: exact scores of the 8 docs of each selected
// block in one cooperative launch, with the copies of later blocks in
// flight while a block is scored.
//
// Replaces openmatch_tpu/ops/pallas_mips.py
// `_gather_rescore_kernel_pipelined` (K6, reached through
// `pallas_gather_rescore(pipeline=True)`), which double-buffers its DMA
// scratch so that the next grid step's copies run under this step's dots.
//
// What it computes is what gather_rescore.cu (K3) computes, for queries
// q [Q, D] bf16, the doc-major body [NB*8, D] bf16 (one buffer) and block
// ids bids [Q, k] int32:
//   out[q, j*8 + m] = <q[q], body[bids[q, j]*8 + m]>      (fp32)
// exactly [Q, k*8], no k padding; ids outside [0, NB) are clamped and may
// repeat within a row.
//
// What bounds it on an H100: memory, counted over the DISTINCT selected
// blocks, each read once (8 x D bf16, 12 KB at D = 768): at Q = 64, k =
// 1000 over the 8,841,823-doc serving index, 5,010 distinct blocks, 61.6
// MB, 18 us at 3.35 TB/s; all distinct, 786 MB, 0.235 ms.
//
// What the design does about it: one launch with nothing else on the
// stream. One persistent CTA per SM, launched cooperatively, its phases
// separated by grid-wide barriers (cooperative_groups' grid sync). Per
// round of at most 64 queries:
//   1. clear and claim  In the first round the grid zeroes the claim table
//                       (a uint64 query mask per block, then the distinct
//                       count). One thread per (q, j) sets bit q of its
//                       block's mask with atomicOr; the thread that found
//                       the mask 0 appends the block to the distinct list
//                       and records its slot.
//   2. score            CTA c takes distinct blocks c, c + G, ... A
//                       producer warp loads 32 blocks' ids and masks at
//                       once; its lane 0 copies each block's contiguous
//                       8 x D slab with one cp.async.bulk into a ring of
//                       16 stages with full and empty mbarriers: the
//                       Hopper form of the TPU kernel's copy-ahead. 16
//                       consumer warps, 4 query tiles x 4 depth quarters,
//                       hold the round's query fragments in registers
//                       (16 queries x 192 deep a warp, 48 registers a
//                       thread; no staged queries in shared memory) and
//                       score each arrived block with mma.sync m16n8k16
//                       (bf16 in, fp32 sums), the block's rows as the B
//                       operand, skipping each query tile whose mask bits
//                       are all 0. The 4 quarters' sums meet in shared
//                       memory and are added in a fixed order, so a call
//                       gives the same bits every time; the rows of set
//                       bits go to S[slot, q, 0:8]. Depth comes in pieces
//                       of 768 (registers hold one piece of the queries);
//                       a deeper D walks the blocks once per piece (a bulk
//                       copy per row piece), each piece resuming from the
//                       stored sums, so every byte of a block is still
//                       read once.
//   3. scatter          out[q, j*8 + m] = S[slot(b), q, m], 16-byte moves;
//                       between rounds it also clears the masks it read and
//                       the count, so only the first round clears the table.
// Data written inside the launch (masks, list, slots, scores, count) is
// read past L1 (ld.global.cg): an SM may hold a stale line of it from an
// earlier round. Offsets are 64-bit.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <atomic>

#include "score_tile_sm90.cuh"  // mbarrier, named barrier and ring helpers

namespace {

namespace cg = cooperative_groups;
using sm90::Ring;

constexpr int GROUP = 8;
constexpr int QCHUNK = 64;            // queries per round: one mask bit each
constexpr int TILES = QCHUNK / 16;    // 16-query mma tiles of a round
constexpr int QUARTERS = 4;           // depth quarters of a piece
constexpr int CONSUMER_WARPS = TILES * QUARTERS;
constexpr int PRODUCER_WARP = CONSUMER_WARPS;
constexpr int THREADS = (CONSUMER_WARPS + 1) * 32;
constexpr int STEP = 32;              // depth per register step (two k16)
constexpr int QSTEPS = 6;             // steps a warp holds: 192 deep
static_assert(QSTEPS % 2 == 0, "steps are loaded in 64-deep pairs");
constexpr int QDEPTH = QSTEPS * STEP;
constexpr int PIECE = QUARTERS * QDEPTH;  // 768
constexpr int STAGE_BYTES = GROUP * PIECE * 2;  // 8 rows of a piece
constexpr int STAGES = 16;

struct Meta {
  unsigned long long bits;  // the block's query mask
  int u;                    // its slot in the distinct list
  int pad;
};

struct Smem {
  uint8_t stages[STAGES][STAGE_BYTES];
  float4 red[2][CONSUMER_WARPS][32];
  Meta meta[STAGES];
  uint64_t full[STAGES];
  uint64_t empty[STAGES];
};
static_assert(sizeof(Smem) <= 232448, "shared memory of one block");
static_assert(offsetof(Smem, red) % 16 == 0, "aligned partial sums");

__device__ __forceinline__ long long clamp_block(long long b, long long nb) {
  return b < 0 ? 0 : (b >= nb ? nb - 1 : b);
}

__device__ __forceinline__ int blocks_of(int first, int step, int count) {
  return first < count ? (count - first + step - 1) / step : 0;
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`, reported
// to `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(sm90::smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(sm90::smem_u32(bar))
      : "memory");
}

// c += a * b for one m16n8k16 tile: a row-major 16 x 16, b column-major
// 16 x 8, both bf16, c fp32
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The producer warp: for each depth piece, each of this CTA's distinct
// blocks' 8 row pieces into the next stage of the ring (rows 2 * len bytes
// apart), with the block's mask and slot beside it: one bulk copy of the
// contiguous 8 x D slab where the piece is the whole row (D <= 768), else
// one a row. Lane l loads block j0 + l's id and mask, so no copy waits on
// its own two dependent loads.
__device__ __forceinline__ void produce(Smem& s, Ring& r,
                                        const __nv_bfloat16* body,
                                        const int32_t* ulist,
                                        const unsigned long long* mask,
                                        int mine, int D, int lane) {
  for (int d0 = 0; d0 < D; d0 += PIECE) {
    const uint32_t bytes = 2u * static_cast<uint32_t>(min(PIECE, D - d0));
    const bool whole = d0 == 0 && D <= PIECE;
    for (int j0 = 0; j0 < mine; j0 += 32) {
      const int mu = blockIdx.x + (j0 + lane) * gridDim.x;
      long long b = 0;
      unsigned long long bits = 0;
      if (j0 + lane < mine) {
        b = __ldcg(ulist + mu);
        bits = __ldcg(mask + b);
      }
      const int n = min(32, mine - j0);
      for (int j = 0; j < n; ++j) {
        const long long bj = __shfl_sync(0xffffffffu, b, j);
        const unsigned long long bitsj = __shfl_sync(0xffffffffu, bits, j);
        if (lane == 0) {
          sm90::mbar_wait(&s.empty[r.s], r.ph ^ 1);
          s.meta[r.s] = Meta{bitsj, static_cast<int>(blockIdx.x) +
                                        (j0 + j) * static_cast<int>(gridDim.x),
                             0};
          sm90::mbar_expect_tx(&s.full[r.s], GROUP * bytes);
          const __nv_bfloat16* src =
              body + static_cast<size_t>(bj) * GROUP * D + d0;
          if (whole)
            bulk_copy(s.stages[r.s], src, GROUP * bytes, &s.full[r.s]);
          else
            for (int m = 0; m < GROUP; ++m)
              bulk_copy(s.stages[r.s] + m * bytes,
                        src + static_cast<size_t>(m) * D, bytes, &s.full[r.s]);
        }
        r.next(STAGES);
      }
    }
  }
}

// Consumer warp (tile tt, quarter dq): lane (g, t4) = (lane / 4, lane % 4)
// holds query rows g and g + 8 of the tile and doc g of each block. Its
// 16-byte loads at depth c + 8 t4 of a 32-deep step feed two k-steps
// (words 0-1 and 2-3): logical k = 2 t4 + e is depth c + 8 t4 + 4 s + e,
// logical k = 2 t4 + 8 + e is c + 8 t4 + 4 s + 2 + e, in A and B alike (a
// dot product does not depend on the order of its terms). The staged rows
// are not padded (one bulk copy a slab), so where a row is a multiple of
// 128 bytes the lanes of odd docs load the two steps of a 64-deep pair in
// the other order: the 8 lanes of a load then read both halves of a
// 128-byte bank line, not the same half twice.
__device__ __forceinline__ void consume(Smem& s, Ring& r,
                                        const __nv_bfloat16* qc, int nq,
                                        float* S, int mine, int D, int warp,
                                        int lane) {
  const int tt = warp % TILES, dq = warp / TILES;
  const int g = lane >> 2, t4 = lane & 3;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const int r0 = 16 * tt + g;  // the lane's first query row of the round
  int par = 0;                 // which set of partial sums
  for (int d0 = 0; d0 < D; d0 += PIECE) {
    const int len = min(PIECE, D - d0);
    const int base = dq * QDEPTH;  // the quarter's depth in the piece
    const int swap = (2 * len) % 128 == 0 ? g & 1 : 0;
    uint4 ax[QSTEPS], ay[QSTEPS];
#pragma unroll
    for (int i = 0; i < QSTEPS; ++i) {
      const int d = base + STEP * i + 8 * t4;
      const bool in = d < len;
      ax[i] = in && r0 < nq ? __ldg(reinterpret_cast<const uint4*>(
                                  qc + static_cast<size_t>(r0) * D + d0 + d))
                            : zero;
      ay[i] = in && r0 + 8 < nq
                  ? __ldg(reinterpret_cast<const uint4*>(
                        qc + static_cast<size_t>(r0 + 8) * D + d0 + d))
                  : zero;
    }
    for (int j = 0; j < mine; ++j) {
      sm90::mbar_wait(&s.full[r.s], r.ph);
      const Meta m = s.meta[r.s];
      const bool active = (m.bits >> (16 * tt)) & 0xffffull;
      float c0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, c1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (active) {
        const uint8_t* row = s.stages[r.s] + g * 2 * len;
#pragma unroll
        for (int p = 0; p < QSTEPS / 2; ++p) {
          const int e = base + 2 * STEP * p;  // the pair's first depth
          if (e >= len) break;  // the same for the whole warp
          const int d1 = e + STEP * swap + 8 * t4;
          const int d2 = e + STEP * (1 - swap) + 8 * t4;
          const uint4 v1 =
              d1 < len ? *reinterpret_cast<const uint4*>(row + 2 * d1) : zero;
          const uint4 v2 =
              d2 < len ? *reinterpret_cast<const uint4*>(row + 2 * d2) : zero;
          const uint4 b0 = swap ? v2 : v1, b1 = swap ? v1 : v2;
          const uint4 &x0 = ax[2 * p], &y0 = ay[2 * p];
          mma_bf16(c0, x0.x, y0.x, x0.y, y0.y, b0.x, b0.y);
          mma_bf16(c1, x0.z, y0.z, x0.w, y0.w, b0.z, b0.w);
          if (e + STEP >= len) break;
          const uint4 &x1 = ax[2 * p + 1], &y1 = ay[2 * p + 1];
          mma_bf16(c0, x1.x, y1.x, x1.y, y1.y, b1.x, b1.y);
          mma_bf16(c1, x1.z, y1.z, x1.w, y1.w, b1.z, b1.w);
        }
      }
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&s.empty[r.s]);  // done with the stage
      r.next(STAGES);
      if (!active) continue;  // the same for the tile's four warps
      s.red[par][warp][lane] = make_float4(c0[0] + c1[0], c0[1] + c1[1],
                                           c0[2] + c1[2], c0[3] + c1[3]);
      sm90::named_sync(1 + tt, 4 * 32);
      if (dq == 0) {
        float4 v = s.red[par][tt][lane];
#pragma unroll
        for (int q = 1; q < QUARTERS; ++q) {
          const float4 w = s.red[par][tt + q * TILES][lane];
          v.x += w.x;
          v.y += w.y;
          v.z += w.z;
          v.w += w.w;
        }
        float* srow = S + (static_cast<size_t>(m.u) * QCHUNK + r0) * GROUP +
                      2 * t4;
        const bool lo = (m.bits >> r0) & 1, hi = (m.bits >> (r0 + 8)) & 1;
        if (d0 > 0) {  // resume this lane's own sums of the earlier pieces
          if (lo) {
            const float2 p = *reinterpret_cast<const float2*>(srow);
            v.x += p.x;
            v.y += p.y;
          }
          if (hi) {
            const float2 p =
                *reinterpret_cast<const float2*>(srow + 8 * GROUP);
            v.z += p.x;
            v.w += p.y;
          }
        }
        if (lo) *reinterpret_cast<float2*>(srow) = make_float2(v.x, v.y);
        if (hi)
          *reinterpret_cast<float2*>(srow + 8 * GROUP) = make_float2(v.z, v.w);
      }
      par ^= 1;
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
gather_rescore_pipelined_kernel(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ body,
                                const int32_t* __restrict__ bids,
                                float* __restrict__ out,
                                unsigned long long* __restrict__ mask,
                                int32_t* __restrict__ slot,
                                int32_t* __restrict__ ulist,
                                float* __restrict__ S, int Q, int D, int k,
                                long long nb) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const cg::grid_group grid = cg::this_grid();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long gtid =
      static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const long long gsize = static_cast<long long>(gridDim.x) * THREADS;
  auto* const count = reinterpret_cast<unsigned int*>(mask + nb);
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      sm90::mbar_init(&s.full[i], 1);
      sm90::mbar_init(&s.empty[i], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (long long i = gtid; i <= nb; i += gsize) mask[i] = 0;  // + the count
  grid.sync();

  Ring r;  // the ring's position carries over from round to round
  for (int q0 = 0; q0 < Q; q0 += QCHUNK) {
    const int nq = min(QCHUNK, Q - q0);
    const long long n = static_cast<long long>(nq) * k;
    const int32_t* const b = bids + static_cast<size_t>(q0) * k;
    const bool more = q0 + QCHUNK < Q;

    for (long long i = gtid; i < n; i += gsize) {  // 1. claim
      const long long blk = clamp_block(__ldg(b + i), nb);
      if (atomicOr(mask + blk, 1ull << (i / k)) == 0) {
        const unsigned int u = atomicAdd(count, 1u);
        ulist[u] = static_cast<int32_t>(blk);
        slot[blk] = static_cast<int32_t>(u);
      }
    }
    grid.sync();

    const int mine = blocks_of(blockIdx.x, gridDim.x,  // 2. score
                               static_cast<int>(__ldcg(count)));
    if (warp == PRODUCER_WARP)
      produce(s, r, body, ulist, mask, mine, D, lane);
    else
      consume(s, r, q + static_cast<size_t>(q0) * D, nq, S, mine, D, warp,
              lane);
    grid.sync();

    for (long long i = gtid; i < 2 * n; i += gsize) {  // 3. scatter
      const long long pair = i >> 1;
      const int half = static_cast<int>(i & 1);
      const long long blk = clamp_block(__ldg(b + pair), nb);
      const size_t src =
          (static_cast<size_t>(__ldcg(slot + blk)) * QCHUNK + pair / k) *
              GROUP +
          4 * half;
      *reinterpret_cast<float4*>(
          out + (static_cast<size_t>(q0) * k + pair) * GROUP + 4 * half) =
          __ldcg(reinterpret_cast<const float4*>(S + src));
      if (more && half == 0) mask[blk] = 0;  // no stage of this round reads it
    }
    if (more) {
      if (gtid == 0) *count = 0;
      grid.sync();
    }
  }
}

constexpr int MAX_DEVICES = 64;

// The current device's SM count, read once per device; the first call on a
// device also raises the kernel's dynamic shared-memory cap and checks that
// one block of it fits on an SM (a cooperative grid must be co-resident).
// Done per launch, these calls cost the host more than the kernel's
// phases take on the card.
cudaError_t device_sms(int* sms) {
  static std::atomic<int> known[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if ((*sms = known[dev].load()) > 0) return cudaSuccess;
  err = cudaFuncSetAttribute(gather_rescore_pipelined_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(sizeof(Smem)));
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gather_rescore_pipelined_kernel, THREADS, sizeof(Smem));
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorCooperativeLaunchTooLarge;
  int coop = 0;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) known[dev].store(*sms);
  return err;
}

}  // namespace

// One cooperative launch on `stream` (one block per SM) and nothing else;
// returns the launch's CUDA error. Scratch, all device memory, for the
// body's nb blocks and qc = min(Q, 64): mask (nb + 1) uint64 (the last
// holds the distinct count; the kernel zeroes it), slot int32 [nb], and for
// U = min(nb, qc * k) distinct blocks at most, ulist int32 [U] and scores
// fp32 [U, 64, 8]. D must be a multiple of 8 and every pointer 16-byte
// aligned.
extern "C" int gather_rescore_pipelined_launch(
    const void* q, const void* body, const void* bids, void* out, void* mask,
    void* slot, void* ulist, void* scores, int Q, int D, int k, long long nb,
    void* stream) {
  if (Q < 1 || D < 8 || D % 8 || k < 1 || nb < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  const cudaError_t err = device_sms(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&q,     &body,  &bids,   &out, &mask, &slot, &ulist,
                  &scores, &Q,    &D,      &k,   &nb};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(gather_rescore_pipelined_kernel),
      dim3(sms), dim3(THREADS), args, sizeof(Smem),
      static_cast<cudaStream_t>(stream)));
}
