// plain_gmax: per-8-doc-block score maxima over the doc-major corpus, with an
// optional first pyramid level and pad-block masking.
//
// Replaces openmatch_tpu/ops/pallas_mips.py `_make_plain_gmax_l1_kernel`
// (K1, gmax plus level-1 maxima plus masking) and `_plain_gmax_kernel` (K2,
// gmax only), both reached through `fused_plain_gmax`, and
// `fused_plain_gmax_segs` (K4: K1 over a corpus held as several segment
// allocations, writing one shared gmax and l1).
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
// in the launch order, so a second query tile finds the tile in L2). D is
// consumed in 64-wide chunks through a 3-stage ring in shared memory fed by
// cp.async 16-byte copies, so the loads of the next two chunks are in
// flight while the tensor cores (wmma bf16 16x16x16, fp32 accumulate) work
// on the current one,
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
#include <mma.h>
#include <stdint.h>

#include "segments.cuh"

using namespace nvcuda;

namespace {

constexpr int GROUP = 8;             // docs per block
constexpr int TQ = 64;               // queries per CUDA block
constexpr int TD = 128;              // doc rows per CUDA block
constexpr int NBT = TD / GROUP;      // 8-doc blocks per tile
constexpr int KC = 64;               // depth staged per step
constexpr int LDS = KC + 8;          // padded shared row, bf16 elements
constexpr int LDC = TD + 4;          // padded score row, floats
constexpr int THREADS = 256;         // 8 warps: 4 over queries x 2 over docs
constexpr int VEC = 8;               // bf16 per 16-byte load

constexpr int STAGES = 3;            // depth chunks in flight

struct Operands {
  __nv_bfloat16 q[TQ][LDS];
  __nv_bfloat16 d[TD][LDS];
};

union __align__(128) Smem {
  Operands ops[STAGES];
  float s[TQ][LDC];
};

constexpr size_t SMEM_BYTES = sizeof(Smem);

// 16-byte global -> shared copy that does not wait; src_bytes = 0 fills
// the destination with zeros (the ragged edges) without reading
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// start the copies of depth chunk [k0, k0 + KC) into one stage
__device__ __forceinline__ void load_chunk(
    Operands& st, const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ body, int Q, int D, int q0,
    long long row0, long long rows_left, int k0, int tid) {
  for (int v = tid; v < TQ * (KC / VEC); v += THREADS) {
    const int r = v / (KC / VEC);
    const int c = (v % (KC / VEC)) * VEC;
    const bool ok = q0 + r < Q && k0 + c < D;
    cp_async16(&st.q[r][c],
               ok ? q + static_cast<size_t>(q0 + r) * D + k0 + c : q,
               ok ? 16 : 0);
  }
  for (int v = tid; v < TD * (KC / VEC); v += THREADS) {
    const int r = v / (KC / VEC);
    const int c = (v % (KC / VEC)) * VEC;
    const bool ok = r < rows_left && k0 + c < D;
    cp_async16(&st.d[r][c],
               ok ? body + static_cast<size_t>(row0 + r) * D + k0 + c : body,
               ok ? 16 : 0);
  }
}

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
  const int warp = tid / 32;
  const int wq = warp & 3;   // 16-query slice of the tile
  const int wd = warp >> 2;  // 64-doc slice of the tile
  const int qt = static_cast<int>(blockIdx.x % n_qt);
  const long long tile = blockIdx.x / n_qt;
  const int q0 = qt * TQ;
  const long long b0 = tile * NBT;                  // window-local block
  const long long gb0 = blk_lo + b0;                // global block
  const int seg = kSegmented ? seg_of(segs, gb0) : 0;
  const __nv_bfloat16* __restrict__ body = segs.base[seg];
  // the first row in the segment, and the rows of the window and segment
  const long long row0 = (kSegmented ? gb0 - segs.blk0[seg] : gb0) * GROUP;
  const long long rows_left =
      ((kSegmented ? min(blk_lo + n_blk, segs.blk0[seg + 1]) : blk_lo + n_blk)
       - gb0) * GROUP;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.0f);

  // a STAGES-deep ring: while the tensor cores work on chunk c, the
  // copies of chunks c+1 .. c+STAGES-1 are in flight
  const int n_chunks = (D + KC - 1) / KC;
#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < n_chunks)
      load_chunk(sm.ops[c], q, body, Q, D, q0, row0, rows_left, c * KC, tid);
    cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<STAGES - 2>();  // chunk c has landed (for this thread)
    __syncthreads();              // ... for every thread; stage c-1 is free
    const int next = c + STAGES - 1;
    if (next < n_chunks)
      load_chunk(sm.ops[next % STAGES], q, body, Q, D, q0, row0, rows_left,
                 next * KC, tid);
    cp_async_commit();
    const Operands& st = sm.ops[c % STAGES];
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          a;
      wmma::load_matrix_sync(a, &st.q[wq * 16][kk], LDS);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // docs are stored [doc][depth]: as the K x N operand that is
        // column-major with leading dimension LDS
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major>
            b;
        wmma::load_matrix_sync(b, &st.d[wd * 64 + j * 16][kk], LDS);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // the operand buffers are dead: the score tile reuses their memory
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(&sm.s[wq * 16][wd * 64 + j * 16], acc[j], LDC,
                            wmma::mem_row_major);
  __syncthreads();

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
  const int n_qt = (Q + TQ - 1) / TQ;
  const long long n_tiles = (n_blk + NBT - 1) / NBT;
  const dim3 grid(static_cast<unsigned>(n_tiles * n_qt));
  const auto kernel =
      n_segs > 1 ? plain_gmax_kernel<true> : plain_gmax_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), segs, static_cast<float*>(gmax),
      static_cast<float*>(l1), Q, D, blk_lo, n_blk, nb_valid, f, n_qt);
  return static_cast<int>(cudaGetLastError());
}
