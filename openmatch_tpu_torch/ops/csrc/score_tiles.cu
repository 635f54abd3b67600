// score_tiles: full score tiles of the doc-major corpus reduced over strided
// groups of 8 rows, with or without the scores.
//
// Replaces openmatch_tpu/ops/pallas_mips.py
//   `_score_gmax_kernel` (K9, via `fused_score_gmax`): every score plus the
//       strided group maxima within each `tile` of corpus rows;
//   `_gmax_only_kernel` (K10, via `fused_gmax_only`): K9's group maxima
//       only; the scores never leave the SM.
// (K8, every score, is scores.cu, on the Hopper mainloop.)
//
// What it computes, for q [Q, D] bf16 and corpus [N, D] bf16 (fp32 sums),
// with gw = tile / 8 and Np = ceil(N / tile) * tile:
//   s(q, n) = <q, corpus[n]> for n < N, -FLT_MAX for N <= n < Np
//   scores[q, n] = s(q, n)                                   [Q, Np]  (K9)
//   gmax[q, t*gw + w] = max_{m<8} s(q, t*tile + m*gw + w)           [Q, Np/8]
// The member layout (group w of tile t holds rows w, w + gw, ..., w + 7*gw
// of the tile) is the TPU kernel's, which took the 8 members as 8 gw-wide
// column slabs of its score tile; the group and candidate ids of the hier2
// paths depend on it. Rows past N: the TPU callers padded the corpus to a
// tile multiple (a second corpus copy) and masked; here the missing rows are
// zero-filled in shared memory and their scores set to -FLT_MAX before the
// store and the max, so any N is taken as it is. -FLT_MAX is
// finfo(float32).min, the value the TPU path masks with.
//
// What bounds it on an H100: at Q = 64 each corpus byte feeds 64
// multiply-adds, below the bf16 ridge, so K10 is bound by one read of the
// corpus (as K1 is), and K9 also writes 4 * Q * 9/8 bytes of scores and
// maxima per corpus row.
//
// What the design does about it: score_tile.cuh's mainloop, 64 queries x
// 128 corpus rows per CUDA block, D in 64-wide chunks through a 3-stage
// cp.async ring, wmma bf16 16x16x16 with fp32 accumulation; only the row
// map and the epilogue are these kernels'. Tile row r holds corpus row
// base + (r / 16) * gw + r % 16: a CUDA block owns tile t and the window of
// 16 groups w0 .. w0 + 15 and loads 8 runs of 16 contiguous rows,
// t*tile + m*gw + w0 + i (m < 8, i < 16), into tile rows m*16 + i, so a
// group's 8 members sit 16 columns apart in the score tile and its max is
// 8 shared-memory reads; K9 stores each run of 16 scores as four 16-byte
// stores. Offsets are 64-bit (8.84M x 768 passes 2^32); the grid is
// flattened (69k tiles exceed gridDim.y), the query tiles of one corpus
// tile adjacent in launch order so the second finds its rows in L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <stdint.h>

#include "score_tile.cuh"

namespace {

using namespace score_tile;

constexpr int GROUP = 8;         // members of a group
constexpr int RUN = TD / GROUP;  // contiguous rows per member run

enum Mode { kScoreGmax = 1, kGmaxOnly = 2 };

// the corpus row of tile row r
__device__ __forceinline__ long long row_of(long long base, long long stride,
                                            int r) {
  return base + (r / RUN) * stride + (r % RUN);
}

// tile row r is corpus row row_of(row0, stride, r), present below N
struct StridedRows {
  const __nv_bfloat16* base;
  long long row0;
  long long stride;
  long long N;
  int D;
  __device__ __forceinline__ bool ok(int r) const {
    return row_of(row0, stride, r) < N;
  }
  __device__ __forceinline__ const __nv_bfloat16* at(int r) const {
    return base + static_cast<size_t>(row_of(row0, stride, r)) * D;
  }
};

// gw: the group stride, tile / 8
template <int kMode>
__global__ void __launch_bounds__(THREADS)
score_tile_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ corpus,
                  float* __restrict__ scores, float* __restrict__ gmax, int Q,
                  int D, long long N, long long gw, int n_qt) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int qt = static_cast<int>(blockIdx.x % n_qt);
  const long long ct = blockIdx.x / n_qt;  // (tile, window of 16 groups)
  const long long wins = gw / RUN;
  const long long t = ct / wins;
  const long long w0 = (ct % wins) * RUN;
  const long long base = t * GROUP * gw + w0;  // corpus row of tile row 0
  const int q0 = qt * TQ;
  compute(sm, q, Q, D, q0, StridedRows{corpus, base, gw, N, D});

  // rows past N (only in the last tile): -FLT_MAX before the store and max
  const float neg = -FLT_MAX;
  if (row_of(base, gw, TD - 1) >= N) {
    for (int v = tid; v < TQ * TD; v += THREADS) {
      const int r = v / TD;
      const int c = v % TD;
      if (row_of(base, gw, c) >= N) sm.s[r][c] = neg;
    }
    __syncthreads();
  }
  const long long n_groups = ((N + GROUP * gw - 1) / (GROUP * gw)) * gw;
  const long long g0 = t * gw + w0;  // the first group of the window
  for (int v = tid; v < TQ * RUN; v += THREADS) {
    const int r = v / RUN;
    const int i = v % RUN;
    float m = sm.s[r][i];
#pragma unroll
    for (int e = 1; e < GROUP; ++e) m = fmaxf(m, sm.s[r][e * RUN + i]);
    if (q0 + r < Q) gmax[static_cast<size_t>(q0 + r) * n_groups + g0 + i] = m;
  }
  if (kMode == kScoreGmax) {
    // the run of 16 scores of member e: Np = 8 * n_groups, and Np, gw and
    // w0 are multiples of 16, so every float4 is aligned
    const long long Np = GROUP * n_groups;
    for (int v = tid; v < TQ * GROUP * (RUN / 4); v += THREADS) {
      const int r = v / (GROUP * (RUN / 4));
      const int e = (v / (RUN / 4)) % GROUP;
      const int i = (v % (RUN / 4)) * 4;
      if (q0 + r >= Q) continue;
      *reinterpret_cast<float4*>(scores + static_cast<size_t>(q0 + r) * Np +
                                 base + e * gw + i) =
          *reinterpret_cast<const float4*>(&sm.s[r][e * RUN + i]);
    }
  }
}

template <int kMode>
int launch(const void* q, const void* corpus, void* scores, void* gmax,
           int Q, int D, long long N, long long gw, void* stream) {
  const int n_qt = (Q + TQ - 1) / TQ;
  const long long tile = GROUP * gw;
  const long long n_ct = (N + tile - 1) / tile * (gw / RUN);
  if (n_ct * n_qt > INT_MAX)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto kernel = score_tile_kernel<kMode>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(n_ct * n_qt), THREADS, SMEM_BYTES,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(corpus), static_cast<float*>(scores),
      static_cast<float*>(gmax), Q, D, N, gw, n_qt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each launches on `stream` and returns cudaGetLastError(). Q, N >= 1,
// D % 8 == 0, all pointers 16-byte aligned; `tile` must be a multiple of
// 128 (the JAX package asks 1024).

// K9: scores [Q, Np] and gmax [Q, Np / 8] fp32, Np = ceil(N / tile) * tile.
extern "C" int score_gmax_launch(const void* q, const void* corpus,
                                 void* scores, void* gmax, int Q, int D,
                                 long long N, int tile, void* stream) {
  if (tile <= 0 || tile % TD) return static_cast<int>(cudaErrorInvalidValue);
  return launch<kScoreGmax>(q, corpus, scores, gmax, Q, D, N, tile / GROUP,
                            stream);
}

// K10: gmax [Q, Np / 8] fp32 only.
extern "C" int gmax_only_launch(const void* q, const void* corpus, void* gmax,
                                int Q, int D, long long N, int tile,
                                void* stream) {
  if (tile <= 0 || tile % TD) return static_cast<int>(cudaErrorInvalidValue);
  return launch<kGmaxOnly>(q, corpus, nullptr, gmax, Q, D, N, tile / GROUP,
                           stream);
}
