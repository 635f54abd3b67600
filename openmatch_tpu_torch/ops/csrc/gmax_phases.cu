// gmax_phases: the per-8-doc-block score maxima of the plain-corpus gmax
// kernel (K2) with one of four epilogues, for timing the epilogue's share of
// the kernel (a phase ablation).
//
// Replaces scripts/perf/score_path_phases.py `make_kernel(phase)` (K11, the
// `pl.pallas_call` of `gmax_x`), a perf-script kernel: K2's body with
// ablated epilogues. What each phase computes, for q [Q, D] bf16 and the
// doc-major body plain [NB*8, D] bf16 (fp32 sums), and how it maps here:
//
//   a3base   g[q, b] = max_{m<8} <q, plain[8b + m]>              [Q, NB]
//            The TPU took a doc-major score tile (docs on sublanes), took
//            the stride-8 member max and transposed it on the vector unit
//            for a query-major store. Here the score tile is query-major
//            (score_tile.cuh, Smem::s[TQ][LDC]), so no transpose is needed:
//            this is K2's epilogue (max over 8 consecutive tile columns,
//            row-major store): plain_gmax.cu's values with emit_l1 = 0, up
//            to the order of the fp32 sums (wmma here, wgmma there).
//   a3notr   the same maxima stored doc-major                    [NB, Q]
//            On the TPU this skipped the transpose; here the doc-major
//            store is the one that changes layout. The maxima are taken as
//            in a3base and parked in the tile, then a second pass gives
//            consecutive threads consecutive queries of one block, so each
//            warp writes 128 contiguous bytes (no strided scatter).
//   a3mxutr  a3base's values                                     [Q, NB]
//            The TPU moved the transpose onto the matrix unit, as a product
//            with an identity. Here the 64 x 16 maxima tile is written
//            doc-major to shared memory and read back by the tensor cores
//            as a column-major operand of a tf32 wmma product with a 16 x 16
//            identity, so the transpose happens inside the matrix unit.
//            tf32 keeps 10 mantissa bits, so each maximum is split into
//            three tf32 parts (hi + mid + lo == g exactly: 11 + 11 + 2
//            significant bits) and the three products accumulate in fp32 on
//            the identity's diagonal; every partial sum is representable,
//            so the result equals a3base for normal values (the check
//            allows 2^-22 * |g| all the same, and counts the entries that
//            are not bit-equal).
//   a3nomax  g[q, b] = <q, plain[8b]>: member 0 only, no max     [Q, NB]
//
// What bounds it on an H100: at the script's Q = 512 every corpus byte feeds
// 512 multiply-adds, above the ~295 FLOP/byte ridge of bf16 tensor cores,
// so the bound is the tensor cores: 2 * Q * NB*8 * D operations (1.74
// TFLOP at 512 x 2,211,840 x 768, 1.76 ms at 989 TFLOP/s), against 1.18 ms
// to move 3.40 GB of corpus and 0.57 GB of maxima at 3.35 TB/s.
//
// What the design does about it: nothing beyond K2's. The mainloop is
// score_tile.cuh's (64 queries x 128 rows per CUDA block, 3-stage cp.async
// ring, wmma bf16 16x16x16), so the corpus is read once per 64-query tile
// (8 times at Q = 512, mostly from L2 since the query tiles of one corpus
// tile are adjacent in launch order) and the wmma rate is far from the
// wgmma peak. The kernel is a right and simple ablation, not a fast one.
// Q is any size and the body any multiple of 8 rows: ragged query and
// corpus tiles are zero-filled in shared memory and not stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <mma.h>
#include <stdint.h>

#include "score_tile.cuh"

namespace {

using namespace score_tile;

constexpr int GROUP = 8;         // docs per block
constexpr int NBT = TD / GROUP;  // 8-doc blocks per tile (16)

enum Phase { kBase = 0, kNoTranspose = 1, kMxuTranspose = 2, kNoMax = 3 };

// a3mxutr's scratch, after the score tile inside the (larger) operand ring
constexpr int LDG = TQ + 4;   // maxima tile, doc-major: gt[b][q]
constexpr int LDO = NBT + 4;  // product tile, query-major: ot[q][b]
struct Transpose {
  float gt[NBT][LDG];
  float eye[NBT][NBT];
  float ot[TQ][LDO];
};
constexpr size_t SCRATCH_OFF = sizeof(float) * TQ * LDC;
static_assert(SCRATCH_OFF % 32 == 0, "wmma operands need 32-byte alignment");
static_assert(SCRATCH_OFF + sizeof(Transpose) <= SMEM_BYTES,
              "the transpose scratch must fit beside the score tile");

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

// a3mxutr: out tile = (maxima tile read doc-major) x identity, on the
// tensor cores in tf32, split so the product is exact
__device__ __forceinline__ void mxu_transpose(Transpose& x) {
  using namespace nvcuda;
  const int warp = threadIdx.x / 32;
  if (warp >= TQ / 16) return;  // one 16-query slice per warp
  wmma::fragment<wmma::accumulator, 16, 16, 8, float> acc;
  wmma::fill_fragment(acc, 0.0f);
#pragma unroll
  for (int kk = 0; kk < NBT; kk += 8) {
    // A (16 queries x 8 blocks) read column-major from the doc-major tile
    wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32,
                   wmma::col_major>
        hi, mid, lo;
    wmma::load_matrix_sync(hi, &x.gt[kk][warp * 16], LDG);
#pragma unroll
    for (int i = 0; i < hi.num_elements; ++i) {
      const float g = hi.x[i];
      const float h = wmma::__float_to_tf32(g);
      const float r = g - h;  // exact
      const float m = wmma::__float_to_tf32(r);
      hi.x[i] = h;
      mid.x[i] = m;
      lo.x[i] = wmma::__float_to_tf32(r - m);  // r - m is exact, 2 bits
    }
    wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32,
                   wmma::row_major>
        eye;
    wmma::load_matrix_sync(eye, &x.eye[kk][0], NBT);
    wmma::mma_sync(acc, hi, eye, acc);
    wmma::mma_sync(acc, mid, eye, acc);
    wmma::mma_sync(acc, lo, eye, acc);
  }
  wmma::store_matrix_sync(&x.ot[warp * 16][0], acc, LDO,
                          wmma::mem_row_major);
}

template <int kPhase>
__global__ void __launch_bounds__(THREADS)
gmax_phase_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ plain,
                  float* __restrict__ out, int Q, int D, long long NB,
                  int n_qt) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  Transpose& x = *reinterpret_cast<Transpose*>(smem_raw + SCRATCH_OFF);
  const int tid = threadIdx.x;
  const int qt = static_cast<int>(blockIdx.x % n_qt);
  const long long tile = blockIdx.x / n_qt;
  const int q0 = qt * TQ;
  const long long b0 = tile * NBT;
  compute(sm, q, Q, D, q0,
          BodyRows{plain, b0 * GROUP, (NB - b0) * GROUP, D});

  // pass 1, K2's thread map: (query r, block b) per thread
  for (int v = tid; v < TQ * NBT; v += THREADS) {
    const int r = v / NBT;
    const int b = v % NBT;
    float m = sm.s[r][b * GROUP];
    if (kPhase != kNoMax) {
#pragma unroll
      for (int t = 1; t < GROUP; ++t) m = fmaxf(m, sm.s[r][b * GROUP + t]);
    }
    if (kPhase == kBase || kPhase == kNoMax) {
      if (q0 + r < Q && b0 + b < NB)
        out[static_cast<size_t>(q0 + r) * NB + b0 + b] = m;
    } else if (kPhase == kNoTranspose) {
      sm.s[r][b * GROUP] = m;  // the thread owns its block's 8 columns
    } else {
      x.gt[b][r] = m;
    }
  }
  if (kPhase == kBase || kPhase == kNoMax) return;
  if (kPhase == kMxuTranspose) {
    for (int v = tid; v < NBT * NBT; v += THREADS)
      x.eye[v / NBT][v % NBT] = (v / NBT == v % NBT) ? 1.0f : 0.0f;
  }
  __syncthreads();
  if (kPhase == kNoTranspose) {
    // pass 2: consecutive threads take consecutive queries of one block
    for (int v = tid; v < NBT * TQ; v += THREADS) {
      const int b = v / TQ;
      const int r = v % TQ;
      if (q0 + r < Q && b0 + b < NB)
        out[static_cast<size_t>(b0 + b) * Q + q0 + r] = sm.s[r][b * GROUP];
    }
    return;
  }
  mxu_transpose(x);
  __syncthreads();
  for (int v = tid; v < TQ * NBT; v += THREADS) {
    const int r = v / NBT;
    const int b = v % NBT;
    if (q0 + r < Q && b0 + b < NB)
      out[static_cast<size_t>(q0 + r) * NB + b0 + b] = x.ot[r][b];
  }
}

template <int kPhase>
int launch(const void* q, const void* plain, void* out, int Q, int D,
           long long NB, void* stream) {
  const int n_qt = (Q + TQ - 1) / TQ;
  const long long n_tiles = (NB + NBT - 1) / NBT;
  if (n_tiles * n_qt > INT_MAX)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto kernel = gmax_phase_kernel<kPhase>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(n_tiles * n_qt), THREADS, SMEM_BYTES,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(plain), static_cast<float*>(out), Q,
      D, NB, n_qt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K11: `phase` 0 a3base, 1 a3notr, 2 a3mxutr, 3 a3nomax. out is [Q, NB]
// fp32, or [NB, Q] for a3notr. Q, NB >= 1, D % 8 == 0, pointers 16-byte
// aligned. Launches on `stream` and returns cudaGetLastError().
extern "C" int gmax_phase_launch(const void* q, const void* plain, void* out,
                                 int Q, int D, long long NB, int phase,
                                 void* stream) {
  switch (phase) {
    case kBase:
      return launch<kBase>(q, plain, out, Q, D, NB, stream);
    case kNoTranspose:
      return launch<kNoTranspose>(q, plain, out, Q, D, NB, stream);
    case kMxuTranspose:
      return launch<kMxuTranspose>(q, plain, out, Q, D, NB, stream);
    case kNoMax:
      return launch<kNoMax>(q, plain, out, Q, D, NB, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
