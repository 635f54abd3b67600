// grouped_gemm: one product per expert over the rows routed to it, the
// rows of each expert known only on the device.
//
// Replaces no TPU kernel: the JAX package has no mixture-of-experts model.
// It was added for the DeepSeek-V3 backbone (models/deepseek_v3.py), whose
// routed experts are about 60% of a Moonlight-16B-A3B token's operations.
// What it computes, for x [M, K] bf16 whose rows are sorted by expert,
// w [E, N, K] bf16 (each expert's nn.Linear weight) and offsets [E + 1]
// int32 (expert e owns rows offsets[e] .. offsets[e + 1] - 1):
//   out[r] = x[r] @ w[e].T        for every r in expert e's rows, [M, N]
// with fp32 sums rounded once to bf16. Rows at or past offsets[E] (the
// routing's unrouted slots) are neither read nor written.
//
// What bounds it on an H100: at the encode cell's shapes an expert sees
// about 1,250 rows a call, so each weight byte feeds over a thousand
// multiply-adds: bound by operations. A loop over experts on the host would
// read the offsets back (a sync a layer) and launch a GEMM per expert; the
// device-side offsets keep the call one launch and capturable in a CUDA
// graph.
//
// What the design does about it: the grid is sized from shapes alone,
// ceil(N / 128) x (ceil(M / 128) + E) blocks, the worst case over any
// routing; each block finds its (expert, 128-row tile) by walking the
// offsets, and blocks past the last expert's tiles exit at once. A block
// computes a 128-row x 128-column tile with wmma bf16 16x16x16 (8 warps, 2
// over rows x 4 over columns, 64 x 32 each) over a 3-stage cp.async ring
// of 64-deep chunks, as score_tile.cuh does. Rows past the expert's last
// and columns past N are zero-filled in shared memory and not stored.
// Consecutive blocks share an expert's weight tile, which stays in L2.
// First version: wmma, not wgmma; making it fast is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int TM = 128;       // rows (routed slots) per block
constexpr int TN = 128;       // output columns per block
constexpr int KC = 64;        // depth staged per step
constexpr int LDS = KC + 8;   // padded shared row, bf16 elements
constexpr int LDC = TN + 4;   // padded fp32 output row
constexpr int THREADS = 256;  // 8 warps: 2 over rows x 4 over columns
constexpr int VEC = 8;        // bf16 per 16-byte copy
constexpr int STAGES = 3;

struct Operands {
  __nv_bfloat16 a[TM][LDS];
  __nv_bfloat16 b[TN][LDS];
};

union __align__(128) Smem {
  Operands ops[STAGES];
  float c[TM][LDC];
};

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

// two floats as a bf16 pair, the first in the low half (lower address)
__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// start the copies of depth chunk [k0, k0 + KC): `rows` rows of a from
// a0, TN rows of the expert's weight from b0 (those at column n >= N
// zero-filled)
__device__ __forceinline__ void load_chunk(
    Operands& st, const __nv_bfloat16* __restrict__ a0, int rows,
    const __nv_bfloat16* __restrict__ b0, int n_left, int K, int k0,
    int tid) {
  for (int v = tid; v < TM * (KC / VEC); v += THREADS) {
    const int r = v / (KC / VEC);
    const int c = (v % (KC / VEC)) * VEC;
    const bool ok = r < rows && k0 + c < K;
    cp_async16(&st.a[r][c], ok ? a0 + static_cast<size_t>(r) * K + k0 + c
                                 : a0,
               ok ? 16 : 0);
  }
  for (int v = tid; v < TN * (KC / VEC); v += THREADS) {
    const int r = v / (KC / VEC);
    const int c = (v % (KC / VEC)) * VEC;
    const bool ok = r < n_left && k0 + c < K;
    cp_async16(&st.b[r][c], ok ? b0 + static_cast<size_t>(r) * K + k0 + c
                                 : b0,
               ok ? 16 : 0);
  }
}

__global__ void __launch_bounds__(THREADS)
grouped_gemm_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ w,
                    const int* __restrict__ offsets,
                    __nv_bfloat16* __restrict__ out, int n_experts, int N,
                    int K) {
  using namespace nvcuda;
  // this block's expert and row tile: the same for every thread
  int t = blockIdx.y;
  int e = 0, row0 = 0, rows = 0;
  for (; e < n_experts; ++e) {
    const int lo = offsets[e];
    const int n_rows = offsets[e + 1] - lo;
    const int tiles = (n_rows + TM - 1) / TM;
    if (t < tiles) {
      row0 = lo + t * TM;
      rows = min(TM, n_rows - t * TM);
      break;
    }
    t -= tiles;
  }
  if (e == n_experts) return;  // past the last expert's tiles
  const int n0 = blockIdx.x * TN;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp >> 2;  // 64-row half of the tile
  const int wn = warp & 3;   // 32-column quarter of the tile
  const __nv_bfloat16* a0 = x + static_cast<size_t>(row0) * K;
  const __nv_bfloat16* b0 =
      w + (static_cast<size_t>(e) * N + n0) * static_cast<size_t>(K);
  const int n_left = N - n0;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int n_chunks = (K + KC - 1) / KC;
#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < n_chunks)
      load_chunk(sm.ops[c], a0, rows, b0, n_left, K, c * KC, tid);
    cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<STAGES - 2>();  // chunk c has landed (for this thread)
    __syncthreads();              // ... for every thread; stage c-1 is free
    const int next = c + STAGES - 1;
    if (next < n_chunks)
      load_chunk(sm.ops[next % STAGES], a0, rows, b0, n_left, K, next * KC,
                 tid);
    cp_async_commit();
    const Operands& st = sm.ops[c % STAGES];
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          a[4];
      // weight rows are stored [n][k]: the K x N operand, column-major
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major>
          b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], &st.a[wm * 64 + i * 16][kk], LDS);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &st.b[wn * 32 + j * 16][kk], LDS);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // the operand ring is dead: the fp32 tile reuses its memory
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&sm.c[wm * 64 + i * 16][wn * 32 + j * 16],
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();

  // 8 columns a thread, one 16-byte store each; N % 8 == 0
  for (int v = tid; v < TM * (TN / VEC); v += THREADS) {
    const int r = v / (TN / VEC);
    const int c = (v % (TN / VEC)) * VEC;
    if (r >= rows || c >= n_left) continue;
    const float* s = &sm.c[r][c];
    const uint4 packed = make_uint4(pack2(s[0], s[1]), pack2(s[2], s[3]),
                                    pack2(s[4], s[5]), pack2(s[6], s[7]));
    *reinterpret_cast<uint4*>(out + static_cast<size_t>(row0 + r) * N + n0 +
                              c) = packed;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(). x [m_rows, K] and
// out [m_rows, N] bf16 row-major, w [n_experts, N, K] bf16, offsets
// [n_experts + 1] int32 non-decreasing with offsets[n_experts] <= m_rows;
// N % 8 == 0, K % 8 == 0, all pointers 16-byte aligned.
extern "C" int grouped_gemm_launch(const void* x, const void* w,
                                   const void* offsets, void* out,
                                   int n_experts, int m_rows, int N, int K,
                                   void* stream) {
  if (n_experts < 1 || m_rows < 1 || N < 1 || K < 1 || N % VEC || K % VEC)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long y_tiles =
      (static_cast<long long>(m_rows) + TM - 1) / TM + n_experts;
  if (y_tiles > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaFuncSetAttribute(
      grouped_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(Smem)));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + TN - 1) / TN, static_cast<unsigned>(y_tiles));
  grouped_gemm_kernel<<<grid, THREADS, sizeof(Smem),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<const int*>(offsets),
      static_cast<__nv_bfloat16*>(out), n_experts, N, K);
  return static_cast<int>(cudaGetLastError());
}
