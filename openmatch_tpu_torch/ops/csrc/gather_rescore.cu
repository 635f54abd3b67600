// gather_rescore: exact scores of the 8 docs of each selected block.
//
// Replaces openmatch_tpu/ops/pallas_mips.py `_gather_rescore_kernel` (K3,
// reached through `pallas_gather_rescore(pipeline=False)`) and
// `_make_gather_rescore_seg_kernel` (K5: the same over a corpus held as
// several segment allocations, each block read routed to its segment).
//
// What it computes, for queries q [Q, D] bf16, the doc-major body
// [NB*8, D] bf16 held as the segments of a SegTable (segments.cuh; one
// segment for a single buffer) and global block ids bids [Q, k] int32:
//   out[q, j*8 + m] = <q[q], body[bids[q, j]*8 + m]>      (fp32)
// The output is exactly [Q, k*8]: there is no k padding, so no pad column
// needs masking. Block ids outside [0, NB) are clamped, so a bad id can
// never read outside the corpus; an id may repeat within a query.
//
// What bounds it on an H100: memory, counted over the DISTINCT selected
// blocks, each of which must be read once (8 x D bf16, 12 KB at D = 768).
// The queries of a batch select overlapping blocks: at Q = 64, k = 1000
// over the 8,841,823-doc serving index the 64,000 (query, block) pairs
// name 5,010 distinct blocks, 61.6 MB. The previous design read one slab
// per pair, 786 MB, and took 0.123 ms: 6.4 TB/s, L2's rate and not HBM's,
// so it was bound by L2 traffic that repeated the same blocks. Where every
// pair names its own block (64,000 distinct) any design reads 786 MB from
// HBM, 0.235 ms.
//
// What the design does about it: each distinct block is read once per 64
// queries and scored against every query of the chunk that selected it.
// Per chunk of at most 64 queries, on the caller's stream, with the
// distinct count kept on the device (the host never waits):
//   1. claim    one thread per (q, j) sets bit q of its block's uint64
//               mask with atomicOr; the thread that found the mask 0
//               appends the block to the distinct list (atomicAdd on the
//               count) and records the block's slot in it.
//   2. score    two persistent grids over the distinct list; a warp loads
//               the ids and masks of 32 of its blocks at once.
//      dense    blocks selected by more than SPARSE_BITS queries: one CTA
//               of 16 warps per SM stages the chunk's queries in shared
//               memory as bf16 (in pieces of 1536 deep when D is larger; a
//               later piece resumes from the stored sums). A warp reads
//               its block's 8 rows once with 16-byte loads (8 in flight
//               per lane) and computes [16 queries x 8 docs] tiles with
//               mma.sync m16n8k16 (bf16 in, fp32 sums) over D, skipping
//               each 16-query tile whose mask bits are all 0.
//      sparse   blocks of one or two queries (every block of an
//               all-distinct selection): a warp per block on CUDA cores,
//               no staged queries, at the occupancy the dense kernel's
//               100 KB query tile and 128 registers a thread do not allow.
//               Both store only the rows of queries whose bit is set, to
//               S[slot, q, 0:8].
//   3. scatter  one thread per (q, j, half): out[q, j*8 + m] =
//               S[slot[b], q, m]; between chunks it also clears the masks
//               it read and the count, so one memset per call suffices.
// Measured on an H100 by chip_smoke.py: at the serving selection the stages
// take 3 + 3 + 32 + 15 + 3 us; the dense stage is bound by its warps' load
// latency and the 96 KB of staged queries each block reads from shared
// memory, not by HBM.
//
// Why mma.sync and not wgmma: a block gives 8 docs from one scattered
// 12 KB address, so the doc tiles are 8 wide with no long K-major stream
// for TMA to feed, while a wgmma wants 64 rows of one operand from shared
// memory. The 8 doc rows, each contiguous along D, already are mma.sync's
// column-major B operand (n = 8, k = 16). The k order of a 32-deep step is
// permuted alike in both operands (a dot product does not depend on the
// order of its terms), so one 16-byte load of a lane holds its B fragments
// of two k-steps, and two 16-byte shared loads its A fragments.
//
// Segments: a warp finds its block's segment by a binary search of the
// by-value cut table (warp-uniform, from the constant bank). Only the score
// stage reads the corpus, and the path a block takes and its sums' order
// depend on its query mask alone, not on the table, so the segmented
// instantiation (kSegmented) equals the single-buffer one bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

#include "segments.cuh"

namespace {

constexpr int GROUP = 8;
constexpr int QCHUNK = 64;          // queries per round: one mask bit each
constexpr int TILES = QCHUNK / 16;  // the chunk's 16-query mma tiles
constexpr int WARPS = 16;           // dense: one CTA of 16 warps per SM
constexpr int THREADS = WARPS * 32;
constexpr int PIECE = 1536;         // query depth staged at once
constexpr int RND = 8;              // 16-byte loads in flight per lane
constexpr int SPARSE_BITS = 2;      // blocks of <= 2 queries: sparse_kernel
constexpr int SPARSE_THREADS = 256;
constexpr int SPARSE_CTAS = 2;      // resident sparse CTAs per SM
constexpr int EDGE_THREADS = 256;   // claim and scatter

__device__ __forceinline__ long long clamp_block(long long b, long long nb) {
  return b < 0 ? 0 : (b >= nb ? nb - 1 : b);
}

__global__ void __launch_bounds__(EDGE_THREADS)
claim_kernel(const int32_t* __restrict__ bids, int n, int k, long long nb,
             unsigned long long* __restrict__ mask,
             unsigned int* __restrict__ count, int32_t* __restrict__ ulist,
             int32_t* __restrict__ slot) {
  const int i = blockIdx.x * EDGE_THREADS + threadIdx.x;  // q * k + j
  if (i >= n) return;
  const long long b = clamp_block(bids[i], nb);
  if (atomicOr(mask + b, 1ull << (i / k)) == 0) {
    const unsigned int u = atomicAdd(count, 1u);
    ulist[u] = static_cast<int32_t>(b);
    slot[b] = static_cast<int32_t>(u);
  }
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

// One 16-byte row load that asks L2 to fetch 256 bytes: a warp's load
// touches 64 bytes of each of 8 rows, and the rest of those bytes are
// read by the warp's next loads.
__device__ __forceinline__ uint4 ld_row(const __nv_bfloat16* p) {
  uint4 v;
  asm volatile(
      "ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// The first of the 8 doc rows of global block b, at depth d0.
template <bool kSegmented>
__device__ __forceinline__ const __nv_bfloat16* block_rows(
    const SegTable& segs, long long b, int D, int d0) {
  const int seg = kSegmented ? seg_of(segs, b) : 0;
  return segs.base[seg] +
         static_cast<size_t>(kSegmented ? b - segs.blk0[seg] : b) * GROUP * D +
         d0;
}

// A warp's distinct blocks are u = first + j * step, j < nblk. Lane l
// holds block j0 + l's id and query mask, loaded together for 32 blocks,
// so no block waits on its own two dependent loads.
struct WarpBlocks {
  long long b;
  unsigned long long bits;
  __device__ void load(const int32_t* ulist, const unsigned long long* mask,
                       int first, int step, int j0, int nblk, int lane) {
    b = 0;
    bits = 0;
    if (j0 + lane < nblk) {
      b = ulist[first + (j0 + lane) * step];
      bits = mask[b];
    }
  }
  __device__ long long block(int j) const {
    return __shfl_sync(0xffffffffu, b, j);
  }
  __device__ unsigned long long mask_of(int j) const {
    return __shfl_sync(0xffffffffu, bits, j);
  }
};

__device__ __forceinline__ int blocks_of(int first, int step, int count) {
  return first < count ? (count - first + step - 1) / step : 0;
}

// Lane (g, t) of a warp, g = lane / 4 and t = lane % 4, holds doc g of the
// block and, for each 16-query tile, query rows g and g + 8. Its 16-byte
// load at depth c + 8t feeds k-step 0 with words 0-1 and k-step 1 with
// words 2-3: logical k = 2t + e is depth c + 8t + 4s + e, and logical
// k = 2t + 8 + e is c + 8t + 4s + 2 + e, in A and in B alike. Blocks that
// at most SPARSE_BITS queries selected are left to sparse_kernel.
template <bool kSegmented>
__global__ void __launch_bounds__(THREADS, 1)
dense_kernel(const __nv_bfloat16* __restrict__ q, int nq, int rows,
             const __grid_constant__ SegTable segs,
             const unsigned long long* __restrict__ mask,
             const unsigned int* __restrict__ count_p,
             const int32_t* __restrict__ ulist, float* __restrict__ S, int D,
             int sq) {
  extern __shared__ uint4 qs[];  // [rows][sq] 16-byte units
  const int count = static_cast<int>(*count_p);
  if (blockIdx.x * WARPS >= count) return;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int step = gridDim.x * WARPS;
  const int first = blockIdx.x * WARPS + (tid >> 5);
  const int nblk = blocks_of(first, step, count);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  WarpBlocks wb;

  bool dense = false;  // skip the query staging where no block is dense
  for (int j0 = 0; j0 < nblk && !dense; j0 += 32) {
    wb.load(ulist, mask, first, step, j0, nblk, lane);
    dense = __any_sync(0xffffffffu, __popcll(wb.bits) > SPARSE_BITS);
  }
  if (!__syncthreads_or(dense)) return;

  for (int d0 = 0; d0 < D; d0 += PIECE) {
    const int len = min(PIECE, D - d0);  // a multiple of 8
    const int len32 = (len + 31) & ~31;
    const int units = len32 / 8;
    __syncthreads();  // every warp is done with the previous piece
    for (int i = tid; i < rows * units; i += THREADS) {
      const int r = i / units;
      const int c = i - r * units;
      qs[r * sq + c] =
          r < nq && c * 8 < len
              ? __ldg(reinterpret_cast<const uint4*>(
                    q + static_cast<size_t>(r) * D + d0 + c * 8))
              : zero;
    }
    __syncthreads();

    for (int j0 = 0; j0 < nblk; j0 += 32) {
      wb.load(ulist, mask, first, step, j0, nblk, lane);
      for (int j = 0; j < min(32, nblk - j0); ++j) {
        const unsigned long long bits = wb.mask_of(j);
        if (__popcll(bits) <= SPARSE_BITS) continue;
        const __nv_bfloat16* row =
            block_rows<kSegmented>(segs, wb.block(j), D, d0) +
            static_cast<size_t>(g) * D;
        float* srow = S +
                      static_cast<size_t>(first + (j0 + j) * step) * QCHUNK *
                          GROUP +
                      2 * t4;
        float acc[TILES][4];
#pragma unroll
        for (int t = 0; t < TILES; ++t) {
          const int r0 = 16 * t + g;
          float2 lo = make_float2(0.0f, 0.0f), hi = lo;
          if (d0 > 0 && ((bits >> r0) & 1))  // resume this lane's own sums
            lo = *reinterpret_cast<const float2*>(srow + r0 * GROUP);
          if (d0 > 0 && ((bits >> (r0 + 8)) & 1))
            hi = *reinterpret_cast<const float2*>(srow + (r0 + 8) * GROUP);
          acc[t][0] = lo.x;
          acc[t][1] = lo.y;
          acc[t][2] = hi.x;
          acc[t][3] = hi.y;
        }
        for (int c0 = 0; c0 < len32; c0 += 32 * RND) {
          uint4 bv[RND];
#pragma unroll
          for (int r = 0; r < RND; ++r) {
            const int d = c0 + 32 * r + 8 * t4;
            bv[r] = d < len ? ld_row(row + d) : zero;
          }
#pragma unroll
          for (int r = 0; r < RND; ++r) {
            if (c0 + 32 * r >= len32) break;
            const int cu = (c0 + 32 * r) / 8 + t4;
#pragma unroll
            for (int t = 0; t < TILES; ++t) {
              if (!((bits >> (16 * t)) & 0xffffull)) continue;
              const uint4 x = qs[(16 * t + g) * sq + cu];
              const uint4 y = qs[(16 * t + g + 8) * sq + cu];
              mma_bf16(acc[t], x.x, y.x, x.y, y.y, bv[r].x, bv[r].y);
              mma_bf16(acc[t], x.z, y.z, x.w, y.w, bv[r].z, bv[r].w);
            }
          }
        }
#pragma unroll
        for (int t = 0; t < TILES; ++t) {
          const int r0 = 16 * t + g;
          if ((bits >> r0) & 1)
            *reinterpret_cast<float2*>(srow + r0 * GROUP) =
                make_float2(acc[t][0], acc[t][1]);
          if ((bits >> (r0 + 8)) & 1)
            *reinterpret_cast<float2*>(srow + (r0 + 8) * GROUP) =
                make_float2(acc[t][2], acc[t][3]);
        }
      }
    }
  }
}

// The 8 scores of one block for NQ queries on CUDA cores: lane l takes
// depths 8l + 256i of every row, then a butterfly of shuffles sums each
// score; lanes 0-7 store doc l's score of each query.
template <int NQ>
__device__ __forceinline__ void sparse_scores(const __nv_bfloat16* rows,
                                              const __nv_bfloat16* qa,
                                              const __nv_bfloat16* qb,
                                              float* out_a, float* out_b,
                                              int D, int lane) {
  float acc[NQ][GROUP];
#pragma unroll
  for (int i = 0; i < NQ; ++i)
#pragma unroll
    for (int m = 0; m < GROUP; ++m) acc[i][m] = 0.0f;
  for (int c = lane * 8; c < D; c += 256) {
    uint4 v[GROUP];
#pragma unroll
    for (int m = 0; m < GROUP; ++m)
      v[m] = ld_row(rows + static_cast<size_t>(m) * D + c);
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const uint4 qv =
          __ldg(reinterpret_cast<const uint4*>((i == 0 ? qa : qb) + c));
      const __nv_bfloat162* qh = reinterpret_cast<const __nv_bfloat162*>(&qv);
#pragma unroll
      for (int m = 0; m < GROUP; ++m) {
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v[m]);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float2 x = __bfloat1622float2(h[t]);
          const float2 y = __bfloat1622float2(qh[t]);
          acc[i][m] = fmaf(x.x, y.x, acc[i][m]);
          acc[i][m] = fmaf(x.y, y.y, acc[i][m]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    float mine = 0.0f;
#pragma unroll
    for (int m = 0; m < GROUP; ++m) {
      float s = acc[i][m];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == m) mine = s;
    }
    if (lane < GROUP) (i == 0 ? out_a : out_b)[lane] = mine;
  }
}

// The distinct blocks that at most SPARSE_BITS queries selected (all of
// them where every pair names its own block): a warp per block, the
// block's rows read once for its one or two queries, at the occupancy the
// dense kernel's staged query tile does not allow.
template <bool kSegmented>
__global__ void __launch_bounds__(SPARSE_THREADS, SPARSE_CTAS)
sparse_kernel(const __nv_bfloat16* __restrict__ q,
              const __grid_constant__ SegTable segs,
              const unsigned long long* __restrict__ mask,
              const unsigned int* __restrict__ count_p,
              const int32_t* __restrict__ ulist, float* __restrict__ S,
              int D) {
  constexpr int SW = SPARSE_THREADS / 32;
  const int count = static_cast<int>(*count_p);
  const int lane = threadIdx.x & 31;
  const int step = gridDim.x * SW;
  const int first = blockIdx.x * SW + (threadIdx.x >> 5);
  const int nblk = blocks_of(first, step, count);
  WarpBlocks wb;
  for (int j0 = 0; j0 < nblk; j0 += 32) {
    wb.load(ulist, mask, first, step, j0, nblk, lane);
    for (int j = 0; j < min(32, nblk - j0); ++j) {
      const unsigned long long bits = wb.mask_of(j);
      if (__popcll(bits) > SPARSE_BITS) continue;
      const __nv_bfloat16* rows =
          block_rows<kSegmented>(segs, wb.block(j), D, 0);
      float* srow = S + static_cast<size_t>(first + (j0 + j) * step) *
                            QCHUNK * GROUP;
      const int qa = __ffsll(static_cast<long long>(bits)) - 1;
      const unsigned long long rest = bits & (bits - 1);
      const int qb = rest ? __ffsll(static_cast<long long>(rest)) - 1 : qa;
      const __nv_bfloat16* qa_row = q + static_cast<size_t>(qa) * D;
      const __nv_bfloat16* qb_row = q + static_cast<size_t>(qb) * D;
      if (rest)
        sparse_scores<2>(rows, qa_row, qb_row, srow + qa * GROUP,
                         srow + qb * GROUP, D, lane);
      else
        sparse_scores<1>(rows, qa_row, qa_row, srow + qa * GROUP,
                         srow + qa * GROUP, D, lane);
    }
  }
}

__global__ void __launch_bounds__(EDGE_THREADS)
scatter_kernel(const int32_t* __restrict__ bids, int n, int k, long long nb,
               const int32_t* __restrict__ slot, const float* __restrict__ S,
               float* __restrict__ out, unsigned long long* __restrict__ mask,
               unsigned int* __restrict__ count, int reset) {
  const int i = blockIdx.x * EDGE_THREADS + threadIdx.x;  // (q * k + j, half)
  if (i >= 2 * n) return;
  const int pair = i >> 1;
  const int half = i & 1;
  const long long b = clamp_block(bids[pair], nb);
  const size_t src =
      (static_cast<size_t>(slot[b]) * QCHUNK + pair / k) * GROUP + 4 * half;
  *reinterpret_cast<float4*>(out + static_cast<size_t>(pair) * GROUP +
                             4 * half) =
      *reinterpret_cast<const float4*>(S + src);
  if (reset && half == 0) mask[b] = 0;  // no stage of this chunk reads it
  if (reset && i == 0) *count = 0;
}

// A staged query row's stride in 16-byte units for rows of min(D, PIECE)
// bf16: 64 bytes past a multiple of 128, so the two rows a quarter-warp
// reads fall on disjoint banks.
constexpr int staged_stride(int D) {
  return (((2 * ((std::min(D, PIECE) + 31) & ~31) + 127) & ~127) + 64) / 16;
}

constexpr int MAX_DEVICES = 64;

// The current device's SM count, read once per device; the first call on a
// device also raises both dense instantiations' dynamic shared-memory cap
// to the largest staged piece. Done per launch, these calls cost the host
// more than a stage takes on the card.
cudaError_t device_sms(int* sms) {
  static std::atomic<int> known[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if ((*sms = known[dev].load()) > 0) return cudaSuccess;
  const int cap = QCHUNK * staged_stride(PIECE) * 16;
  err = cudaFuncSetAttribute(dense_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, cap);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        dense_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, cap);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) known[dev].store(*sms);
  return err;
}

}  // namespace

// Launches on `stream` and returns the first CUDA error. The corpus is the
// n_segs segments at seg_base (host array), segment s holding global blocks
// [seg_blk0[s], seg_blk0[s + 1]) (host array of n_segs + 1). Scratch, all
// device memory, for NB blocks and qc = min(Q, 64): mask (NB + 1) uint64
// (the last holds the distinct count; zeroed here), slot int32 [NB], and
// for U = min(NB, qc * k) distinct blocks at most, ulist int32 [U] and
// scores fp32 [U, 64, 8]. D must be a multiple of 8
// and every pointer 16-byte aligned.
extern "C" int gather_rescore_launch(const void* q, const void* const* seg_base,
                                     const long long* seg_blk0, int n_segs,
                                     const void* bids, void* out, void* mask,
                                     void* slot, void* ulist, void* scores,
                                     int Q, int D, int k, void* stream) {
  SegTable segs;
  if (!make_seg_table(&segs, seg_base, seg_blk0, n_segs) || D < 8 ||
      D % 8 || k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nb = segs.blk0[n_segs];
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* const m = static_cast<unsigned long long*>(mask);
  auto* const count = reinterpret_cast<unsigned int*>(m + nb);
  auto* const sl = static_cast<int32_t*>(slot);
  auto* const ul = static_cast<int32_t*>(ulist);
  auto* const S = static_cast<float*>(scores);
  const int sq = staged_stride(D);
  const auto dense = n_segs > 1 ? dense_kernel<true> : dense_kernel<false>;
  const auto sparse = n_segs > 1 ? sparse_kernel<true> : sparse_kernel<false>;
  int sms = 0;
  cudaError_t err = device_sms(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(mask, 0, static_cast<size_t>(nb + 1) * 8, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int q0 = 0; q0 < Q; q0 += QCHUNK) {
    const int nq = std::min(QCHUNK, Q - q0);
    const int n = nq * k;
    const int rows = (nq + 15) & ~15;
    const int32_t* b = static_cast<const int32_t*>(bids) +
                       static_cast<size_t>(q0) * k;
    const __nv_bfloat16* qc =
        static_cast<const __nv_bfloat16*>(q) + static_cast<size_t>(q0) * D;
    claim_kernel<<<(n + EDGE_THREADS - 1) / EDGE_THREADS, EDGE_THREADS, 0,
                   st>>>(b, n, k, nb, m, count, ul, sl);
    dense<<<std::min(sms, (n + WARPS - 1) / WARPS), THREADS,
            static_cast<size_t>(rows) * sq * 16, st>>>(qc, nq, rows, segs, m,
                                                       count, ul, S, D, sq);
    sparse<<<std::min(sms * SPARSE_CTAS,
                      (n + SPARSE_THREADS / 32 - 1) / (SPARSE_THREADS / 32)),
             SPARSE_THREADS, 0, st>>>(qc, segs, m, count, ul, S, D);
    scatter_kernel<<<(2 * n + EDGE_THREADS - 1) / EDGE_THREADS, EDGE_THREADS,
                     0, st>>>(
        b, n, k, nb, sl, S,
        static_cast<float*>(out) + static_cast<size_t>(q0) * k * GROUP, m,
        count, q0 + QCHUNK < Q);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}
