// plain_gmax: per-8-doc-block score maxima over the doc-major corpus, with an
// optional first pyramid level and pad-block masking.
//
// Replaces openmatch_tpu/ops/pallas_mips.py `_make_plain_gmax_l1_kernel`
// (K1, gmax plus level-1 maxima plus masking) and `_plain_gmax_kernel` (K2,
// gmax only), both reached through `fused_plain_gmax`, and
// `fused_plain_gmax_segs` (K4: K1 over a corpus held as several segment
// allocations, writing one shared gmax and l1), and `_block_gmax_kernel` (K7,
// via `fused_block_gmax`: block maxima from the block-row layout
// cb [NB, 8*D]). The TPU kernel took the 8 members of a block as 8 static
// D-wide column slabs of a block row because Mosaic could not slice them out
// of the doc-major layout; on the card cb is the doc-major body viewed as
// [NB, 8*D], the same bytes, so K7 is the single-buffer instantiation with
// no level 1 and no masking, behind its own entry point `block_gmax_launch`.
//
// What it computes, for queries q [Q, D] bf16 and the body [NB*8, D] bf16
// held as the segments of a SegTable (segments.cuh; one segment for a
// single buffer), over the window of global blocks [blk_lo, blk_lo + n_blk):
//   gmax[q, b] = max_{m<8} <q, body[(blk_lo + b)*8 + m]>      (fp32)
//   gmax[q, b] = -FLT_MAX  where blk_lo + b >= nb_valid
//   l1[q, i]   = max_{b in [i*f, i*f+f) and b < n_blk} gmax[q, b]   (f > 0)
// Both outputs are query-major. -FLT_MAX is finfo(float32).min, the value
// the TPU kernel masks with; it is finite on purpose.
//
// What bounds it on an H100: at the serving batch (Q = 64) every corpus
// byte feeds 64 multiply-adds, below the ~295 FLOP/byte ridge of bf16
// tensor cores, so the kernel is bound by reading the corpus once from HBM
// (12.65 GiB at 8.84M x 768).
//
// What the design does about it: each CUDA block owns one tile of 128 doc
// rows (16 blocks of 8) and 64 queries, so the corpus tile is read from
// HBM once per 64 queries (the query tiles of one corpus tile are adjacent
// in the launch order, so a second query tile finds the tile in L2). The
// mainloop is score_tile.cuh's (a 3-stage cp.async ring into wmma bf16
// with fp32 accumulation), over contiguous doc rows,
// and the 64 x 128 score tile never leaves the SM: the epilogue reduces
// 8 contiguous doc rows per block, masks, and reduces f blocks for l1.
// Only the [Q, NB] maxima reach HBM (1/8 of the score bytes). The ragged
// last tile is zero-filled in shared memory and its missing blocks are not
// stored; the corpus is never padded. All element offsets are 64-bit: at
// 8.84M x 768 they pass 2^32.
//
// Segments: every tile lies inside one segment (the caller cuts segments
// at multiples of 16 blocks), so a CUDA block resolves its segment once and
// reads segment-local rows; output columns and nb_valid stay global. One
// launch covers all segments, where the TPU needed one `pallas_call` per
// segment with aliased, windowed outputs. The segmented kernel is its own
// instantiation (kSegmented): routing through the table in the
// single-buffer kernel measured 1.2% slower at Q=64 over 8.84M docs
// (6.82-6.84 vs 6.75-6.76 ms, H100 80GB HBM3 at 700 W).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "score_tile.cuh"
#include "segments.cuh"

namespace {

using namespace score_tile;

constexpr int GROUP = 8;         // docs per block
constexpr int NBT = TD / GROUP;  // 8-doc blocks per tile

// tile row r is body row row0 + r, present while r < rows_left
struct BodyRows {
  const __nv_bfloat16* base;
  long long row0;
  long long rows_left;
  int D;
  __device__ __forceinline__ bool ok(int r) const { return r < rows_left; }
  __device__ __forceinline__ const __nv_bfloat16* at(int r) const {
    return base + static_cast<size_t>(row0 + r) * D;
  }
};

template <bool kSegmented>
__global__ void __launch_bounds__(THREADS)
plain_gmax_kernel(const __nv_bfloat16* __restrict__ q,
                  const __grid_constant__ SegTable segs,
                  float* __restrict__ gmax, float* __restrict__ l1, int Q,
                  int D, long long blk_lo, long long n_blk,
                  long long nb_valid, int f, int n_qt) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int qt = static_cast<int>(blockIdx.x % n_qt);
  const long long tile = blockIdx.x / n_qt;
  const int q0 = qt * TQ;
  const long long b0 = tile * NBT;                  // window-local block
  const long long gb0 = blk_lo + b0;                // global block
  const int seg = kSegmented ? seg_of(segs, gb0) : 0;
  // the first row in the segment, and the rows of the window and segment
  const long long row0 = (kSegmented ? gb0 - segs.blk0[seg] : gb0) * GROUP;
  const long long rows_left =
      ((kSegmented ? min(blk_lo + n_blk, segs.blk0[seg + 1]) : blk_lo + n_blk)
       - gb0) * GROUP;
  compute(sm, q, Q, D, q0, BodyRows{segs.base[seg], row0, rows_left, D});

  const float neg = -FLT_MAX;
  for (int v = tid; v < TQ * NBT; v += THREADS) {
    const int r = v / NBT;
    const int b = v % NBT;
    const long long lb = b0 + b;
    float m = sm.s[r][b * GROUP];
#pragma unroll
    for (int t = 1; t < GROUP; ++t) m = fmaxf(m, sm.s[r][b * GROUP + t]);
    if (blk_lo + lb >= nb_valid) m = neg;
    // each thread owns its block's 8 columns: park the maximum in the
    // first one for the level-1 pass
    sm.s[r][b * GROUP] = m;
    if (q0 + r < Q && lb < n_blk)
      gmax[static_cast<size_t>(q0 + r) * n_blk + lb] = m;
  }
  if (f <= 0) return;
  __syncthreads();
  const int per = NBT / f;
  const long long n_l1 = (n_blk + f - 1) / f;
  for (int v = tid; v < TQ * per; v += THREADS) {
    const int r = v / per;
    const int g = v % per;
    float m = neg;
    for (int t = 0; t < f; ++t)
      if (b0 + g * f + t < n_blk) m = fmaxf(m, sm.s[r][(g * f + t) * GROUP]);
    const long long li = b0 / f + g;
    if (q0 + r < Q && li < n_l1)
      l1[static_cast<size_t>(q0 + r) * n_l1 + li] = m;
  }
}

// launch the single-buffer (one segment) or segmented instantiation
int launch_gmax(const void* q, const SegTable& segs, void* gmax, void* l1,
                int Q, int D, long long blk_lo, long long n_blk,
                long long nb_valid, int f, void* stream) {
  const int n_qt = (Q + TQ - 1) / TQ;
  const long long n_tiles = (n_blk + NBT - 1) / NBT;
  const dim3 grid(static_cast<unsigned>(n_tiles * n_qt));
  const auto kernel =
      segs.n > 1 ? plain_gmax_kernel<true> : plain_gmax_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), segs, static_cast<float*>(gmax),
      static_cast<float*>(l1), Q, D, blk_lo, n_blk, nb_valid, f, n_qt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(). The corpus is the
// n_segs segments at seg_base (host array), segment s holding global blocks
// [seg_blk0[s], seg_blk0[s + 1]) (host array of n_segs + 1); every cut
// inside the window must sit a multiple of 16 blocks after blk_lo. `l1`
// may be null when f == 0; f must divide 16 (the blocks of one tile).
// nb_valid masks global block ids >= nb_valid (pass a value >= blk_lo +
// n_blk for none).
extern "C" int plain_gmax_launch(const void* q, const void* const* seg_base,
                                 const long long* seg_blk0, int n_segs,
                                 void* gmax, void* l1, int Q, int D,
                                 long long blk_lo, long long n_blk,
                                 long long nb_valid, int f, void* stream) {
  SegTable segs;
  if (!make_seg_table(&segs, seg_base, seg_blk0, n_segs))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_gmax(q, segs, gmax, l1, Q, D, blk_lo, n_blk, nb_valid, f,
                     stream);
}

// K7: gmax [Q, NB] fp32 from the block rows cb [NB, 8*D] bf16, read as the
// doc-major [NB*8, D] rows they are. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int block_gmax_launch(const void* q, const void* cb, void* gmax,
                                 int Q, int D, long long NB, void* stream) {
  const long long blk0[2] = {0, NB};
  SegTable segs;
  if (!make_seg_table(&segs, &cb, blk0, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_gmax(q, segs, gmax, nullptr, Q, D, 0, NB, NB, 0, stream);
}
