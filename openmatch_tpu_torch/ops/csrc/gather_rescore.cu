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
// never read outside the corpus.
//
// What bounds it on an H100: memory. Each (query, block) pair reads one
// contiguous 8 x D bf16 slab (12 KB at D = 768) and does 2*8*D flops with
// it; at Q = 64 and k = 1000 that is 786 MB of scattered 12 KB reads.
//
// What the design does about it: one CUDA block per (query, 64 selected
// blocks). The block stages its own query row in shared memory as fp32 and
// reads its own block ids (the TPU kernel needed scalar prefetch for
// that). Each warp takes one selected block at a time and walks its 8
// contiguous rows with 16-byte loads, the 8 rows' loads for one column
// chunk started together so that 8 independent requests per lane are in
// flight. Each lane keeps 8 fp32 partial dots; warp shuffles reduce them
// and lanes 0..7 store the 8 scores of the block as one 32-byte segment.
// Offsets are 64-bit: bid*8*D passes 2^32 at 8.84M docs.
//
// Segments: a warp finds its block's segment by a binary search of the
// by-value cut table (warp-uniform, ceil(log2 n) compares from the
// constant bank), where the TPU paid a scalar branch dispatch per copy.
// The segmented kernel is its own instantiation (kSegmented), so the
// single-buffer kernel does no routing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "segments.cuh"

namespace {

constexpr int GROUP = 8;
constexpr int THREADS = 256;        // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int BIDS_PER_BLOCK = 64;  // selected blocks per CUDA block
constexpr int VEC = 8;              // bf16 per 16-byte load

template <bool kSegmented>
__global__ void __launch_bounds__(THREADS)
gather_rescore_kernel(const __nv_bfloat16* __restrict__ q,
                      const __grid_constant__ SegTable segs,
                      const int32_t* __restrict__ bids,
                      float* __restrict__ out, int D, int k, long long nb,
                      int n_chunks) {
  extern __shared__ float qs[];  // [D]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long qi = blockIdx.x / n_chunks;
  const int chunk = static_cast<int>(blockIdx.x % n_chunks);

  const __nv_bfloat16* qrow = q + static_cast<size_t>(qi) * D;
  for (int d = tid; d < D; d += THREADS) qs[d] = __bfloat162float(qrow[d]);
  __syncthreads();

  const int j_end = min(k, (chunk + 1) * BIDS_PER_BLOCK);
  for (int j = chunk * BIDS_PER_BLOCK + warp; j < j_end; j += WARPS) {
    long long b = bids[static_cast<size_t>(qi) * k + j];
    b = b < 0 ? 0 : (b >= nb ? nb - 1 : b);
    const int seg = kSegmented ? seg_of(segs, b) : 0;
    const __nv_bfloat16* rows =
        segs.base[seg] +
        static_cast<size_t>(kSegmented ? b - segs.blk0[seg] : b) * GROUP * D;
    float acc[GROUP];
#pragma unroll
    for (int m = 0; m < GROUP; ++m) acc[m] = 0.0f;
    for (int c = lane * VEC; c < D; c += 32 * VEC) {
      uint4 v[GROUP];
#pragma unroll
      for (int m = 0; m < GROUP; ++m)
        v[m] = __ldg(reinterpret_cast<const uint4*>(
            rows + static_cast<size_t>(m) * D + c));
      float qv[VEC];
#pragma unroll
      for (int t = 0; t < VEC; ++t) qv[t] = qs[c + t];
#pragma unroll
      for (int m = 0; m < GROUP; ++m) {
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v[m]);
#pragma unroll
        for (int t = 0; t < VEC / 2; ++t) {
          const float2 x = __bfloat1622float2(h[t]);
          acc[m] = fmaf(x.x, qv[2 * t], acc[m]);
          acc[m] = fmaf(x.y, qv[2 * t + 1], acc[m]);
        }
      }
    }
    float mine = 0.0f;
#pragma unroll
    for (int m = 0; m < GROUP; ++m) {
      float s = acc[m];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == m) mine = s;
    }
    if (lane < GROUP)
      out[(static_cast<size_t>(qi) * k + j) * GROUP + lane] = mine;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(). The corpus is the
// n_segs segments at seg_base (host array), segment s holding global blocks
// [seg_blk0[s], seg_blk0[s + 1]) (host array of n_segs + 1). D must be a
// multiple of 8 and every pointer 16-byte aligned.
extern "C" int gather_rescore_launch(const void* q, const void* const* seg_base,
                                     const long long* seg_blk0, int n_segs,
                                     const void* bids, void* out, int Q, int D,
                                     int k, void* stream) {
  SegTable segs;
  if (!make_seg_table(&segs, seg_base, seg_blk0, n_segs))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nb = segs.blk0[n_segs];
  const int n_chunks = (k + BIDS_PER_BLOCK - 1) / BIDS_PER_BLOCK;
  const dim3 grid(static_cast<unsigned>(static_cast<long long>(Q) * n_chunks));
  const size_t smem = static_cast<size_t>(D) * sizeof(float);
  const auto kernel = n_segs > 1 ? gather_rescore_kernel<true>
                                 : gather_rescore_kernel<false>;
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), segs,
      static_cast<const int32_t*>(bids), static_cast<float*>(out), D, k, nb,
      n_chunks);
  return static_cast<int>(cudaGetLastError());
}
