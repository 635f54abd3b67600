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
// routing's unrouted slots) are never written, and no stored row depends
// on them.
//
// What bounds it on an H100: at the encode cell's shapes an expert sees
// about 1,250 rows a call, so each weight byte feeds over a thousand
// multiply-adds, far above the ~295 FLOP/byte ridge: the tensor cores
// bound it, as long as each expert's weight is read from HBM about once a
// call (gate-up: 64 x 11.5 MB, 0.33 ms at 3.35 TB/s against 1.41 ms of
// operations at 80,400 routed rows). A loop over experts on the host would
// read the offsets back (a sync a layer) and launch a GEMM per expert; the
// device-side offsets keep the call one launch and capturable in a CUDA
// graph.
//
// What the design does about it: score_tile_sm90.cuh's Hopper mainloop,
// over a schedule the blocks derive from the offsets on the device.
// - Persistent blocks, one per SM. Each reads the E + 1 offsets into
//   shared memory once and derives every expert's count of 128-row tiles
//   and the prefix sum of its work tiles (m-tiles x n-tiles). Work tile t
//   is dealt to block t % grid: no block is launched idle, and nothing is
//   read back to the host.
// - Tiles run expert-major (within an expert, the m-tiles of one n-tile
//   follow each other), so the ~132 blocks running at one time work on one
//   expert: its weight (11.5 MB for gate-up) and its rows stay in the 50 MB
//   L2, and each weight byte comes from HBM about once a call.
// - One producer thread keeps TMA loads of 64-deep chunks in flight into a
//   ring of 4 stages (8 at the narrow tile) with full and empty mbarriers:
//   128 rows of x from a tensor map over [M, K], and TN rows of the
//   expert's weight from one over w viewed as [E * N, K], both with the
//   128-byte swizzle. TMA zero-fills depth past K and rows past the maps.
//   An x tile that runs past its expert's last row reads the next
//   expert's rows (or unrouted slots): they are computed, never stored.
// - Two consumer warpgroups issue m64nTNk16 wgmma, each on its 64 rows of
//   the stage against the weight tile, both operands K-major; the fp32
//   sums stay in registers. TN is 256 where N % 256 == 0 (both products of
//   the Moonlight cell), else 64; the launcher picks it from N.
// - The epilogue rounds the sums to bf16 once and stores them from
//   registers, 16 bytes a lane after a transpose inside each quad of
//   lanes, only rows below the expert's end and columns below N, while
//   the producer already loads the next tile's chunks.
// - No TMA store of whole tiles: a tile's tail rows belong to the next
//   expert, whose own tile (on another block, at another time) writes
//   them; a whole-tile store would race with it.
// - No split-K: each output element is summed and written by one block in
//   a fixed order, so the output is the same bits run to run (a CUDA graph
//   equals eager), with no atomics and no second pass. The work tiles
//   (about 7,000 for gate-up) already fill 132 SMs many times over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "score_tile_sm90.cuh"

namespace {

using namespace sm90;

constexpr int TN_WIDE = QN_WIDE;      // output columns a tile, N % 256 == 0
constexpr int TN_NARROW = QN_NARROW;  // ... otherwise
constexpr int VEC = 8;                // bf16 per 16-byte store

// two floats as a bf16 pair, the first in the low half (lower address)
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c ? a : b, as `selp` (see sm90::select)
__device__ __forceinline__ uint32_t select_u32(bool c, uint32_t a,
                                               uint32_t b) {
  uint32_t r;
  asm("{\n.reg .pred p;\nsetp.ne.u32 p, %3, 0;\nselp.b32 %0, %1, %2, p;\n}\n"
      : "=r"(r)
      : "r"(a), "r"(b), "r"(static_cast<uint32_t>(c)));
  return r;
}

// The block's schedule in shared memory: the offsets, and the first work
// tile of each expert (tile0[E] is the call's count of work tiles).
struct Schedule {
  const int* first;  // [E + 1] offsets
  const int* tile0;  // [E + 1]
  int n_experts;
  int n_nt;          // n-tiles per expert, ceil(N / TN)
  int m_rows;        // rows of x and out
};

// Calls fn(e, row0, rows, n0) for each of the block's work tiles in
// order: expert e's 128 rows from row0, of which the first `rows` are its
// own, against its weight rows n0 .. n0 + TN - 1.
template <int TN, class Fn>
__device__ __forceinline__ void for_each_tile(const Schedule& S,
                                              const Fn& fn) {
  const int total = S.tile0[S.n_experts];
  int e = 0;
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    while (t >= S.tile0[e + 1]) ++e;
    const int lo = S.first[e];
    const int hi = min(S.first[e + 1], S.m_rows);
    const int m_tiles = (hi - lo + TILE_ROWS - 1) / TILE_ROWS;
    const int u = t - S.tile0[e];
    const int row0 = lo + (u % m_tiles) * TILE_ROWS;
    fn(e, row0, min(TILE_ROWS, hi - row0), (u / m_tiles) * TN);
  }
}

// Consumer warpgroup g's 64 x TN sums (mma_tile's layout) to out, bf16.
// The four lanes of a quad hold two columns each of every 8; a transpose
// inside the quad (two xor exchanges) leaves each lane the 8 columns of one
// group of 8, stored as 16 bytes, so a warp stores 64 contiguous bytes of
// each of its 8 rows.
template <int TN>
__device__ __forceinline__ void store_tile(const float (&acc)[TN / 2],
                                           __nv_bfloat16* __restrict__ out,
                                           int row0, int rows, int n0, int N,
                                           int g) {
  const int lane = threadIdx.x % 32;
  const int w = (threadIdx.x / 32) % 4;
  const int q = lane & 3;
  const bool hi2 = q & 2, hi1 = q & 1;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = g * WG_ROWS + 16 * w + 8 * half + lane / 4;
    __nv_bfloat16* const dst =
        out + static_cast<size_t>(row0 + r) * N + n0;
#pragma unroll
    for (int m = 0; m < TN / 32; ++m) {
      // v[i]: this lane's 2 columns of group 4m + i
      uint32_t v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 4 * m + i;
        v[i] = pack2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {  // lanes q, q ^ 2 swap 2 x 2 blocks
        const uint32_t got = __shfl_xor_sync(
            0xffffffffu, select_u32(hi2, v[i], v[i + 2]), 2);
        v[i] = select_u32(hi2, got, v[i]);
        v[i + 2] = select_u32(hi2, v[i + 2], got);
      }
#pragma unroll
      for (int i = 0; i < 4; i += 2) {  // lanes q, q ^ 1 swap single words
        const uint32_t got = __shfl_xor_sync(
            0xffffffffu, select_u32(hi1, v[i], v[i + 1]), 1);
        v[i] = select_u32(hi1, got, v[i]);
        v[i + 1] = select_u32(hi1, v[i + 1], got);
      }
      // now v[p]: lane p's 2 columns of group 4m + q
      const int col = VEC * (4 * m + q);
      if (r < rows && n0 + col < N)
        *reinterpret_cast<uint4*>(dst + col) =
            make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

template <int TN>
__global__ void __launch_bounds__(THREADS, 1)
grouped_gemm_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap,
                    const int* __restrict__ offsets,
                    __nv_bfloat16* __restrict__ out, int n_experts,
                    int m_rows, int N, const Layout L) {
  uint8_t* sm = aligned_smem();
  int* const first = reinterpret_cast<int*>(sm + L.off_epi);
  int* const tile0 = first + n_experts + 1;
  for (int e = threadIdx.x; e <= n_experts; e += blockDim.x)
    first[e] = offsets[e];
  __syncthreads();
  const int n_nt = (N + TN - 1) / TN;
  if (threadIdx.x == 0) {
    tile0[0] = 0;
    for (int e = 0; e < n_experts; ++e) {
      const int n_rows = min(first[e + 1], m_rows) - first[e];
      tile0[e + 1] =
          tile0[e] + max(0, (n_rows + TILE_ROWS - 1) / TILE_ROWS) * n_nt;
    }
  }
  Barriers& bar = init_barriers(sm, L);  // also syncs the schedule
  const Schedule S{first, tile0, n_experts, n_nt, m_rows};

  if (threadIdx.x >= CONSUMER_THREADS) {
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMER_THREADS) {
      Ring r;
      for_each_tile<TN>(S, [&](int e, int row0, int, int n0) {
        const int w_row0 = e * N + n0;
        for (int c = 0; c < L.n_chunks; ++c) {
          mbar_wait(&bar.empty[r.s], r.ph ^ 1);
          uint8_t* st = sm + L.off_stages + r.s * L.stage_bytes;
          mbar_expect_tx(&bar.full[r.s], L.stage_bytes);
          tma_load(st, &xmap, c * KC, row0, &bar.full[r.s]);
          tma_load(st + TILE_ROWS * ROW_BYTES, &wmap, c * KC, w_row0,
                   &bar.full[r.s]);
          r.next(L.stages);
        }
      });
    }
  } else {
    reg_alloc<CONSUMER_REGS>();
    const int g = threadIdx.x / 128;  // consumer warpgroup: rows 64 g ..
    Ring r;
    float acc[TN / 2];
    for_each_tile<TN>(S, [&](int, int row0, int rows, int n0) {
      mma_tile<TN>(acc, L, sm, bar, r, g);
      store_tile<TN>(acc, out, row0, rows, n0, N, g);
    });
  }
}

// The ring's stages, then the schedule's 2 (E + 1) ints, then the
// barriers; every stage streams its weight tile (nothing is resident).
inline Layout gemm_layout(int TN, int K, int n_experts) {
  Layout L;
  const int table = (2 * (n_experts + 1) * 4 + 7) / 8 * 8;
  L.n_chunks = (K + KC - 1) / KC;
  L.resident = 0;
  L.stage_bytes = (TILE_ROWS + TN) * ROW_BYTES;
  L.off_stages = 0;
  const int fit = (SMEM_LIMIT - ALIGN - static_cast<int>(sizeof(Barriers)) -
                   table) / L.stage_bytes;
  L.stages = fit < MAX_STAGES ? fit : MAX_STAGES;
  L.off_epi = L.stages * L.stage_bytes;
  L.off_bar = L.off_epi + table;
  L.bytes = L.off_bar + static_cast<int>(sizeof(Barriers)) + ALIGN;
  return L;
}

template <int TN>
int run(const void* x, const void* w, const void* offsets, void* out,
        int n_experts, int m_rows, int N, int K, void* stream) {
  const Layout L = gemm_layout(TN, K, n_experts);
  if (L.stages < 2) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xmap, wmap;
  int rc = encode_rows(&xmap, x, m_rows, K, TILE_ROWS);
  if (rc) return rc;
  rc = encode_rows(&wmap, w, static_cast<long long>(n_experts) * N, K, TN);
  if (rc) return rc;
  const auto kernel = grouped_gemm_kernel<TN>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the most work tiles any routing of m_rows rows can make
  const long long most =
      (static_cast<long long>(m_rows) / TILE_ROWS + n_experts) *
      ((N + TN - 1) / TN);
  kernel<<<grid_for(most), THREADS, L.bytes,
           static_cast<cudaStream_t>(stream)>>>(
      xmap, wmap, static_cast<const int*>(offsets),
      static_cast<__nv_bfloat16*>(out), n_experts, m_rows, N, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(), or the code of a
// failed tensor-map encode (score_tile_sm90.cuh). x [m_rows, K] and out
// [m_rows, N] bf16 row-major, w [n_experts, N, K] bf16, offsets
// [n_experts + 1] int32 non-decreasing with offsets[n_experts] <= m_rows;
// N % 8 == 0, K % 8 == 0, all pointers 16-byte aligned.
extern "C" int grouped_gemm_launch(const void* x, const void* w,
                                   const void* offsets, void* out,
                                   int n_experts, int m_rows, int N, int K,
                                   void* stream) {
  if (n_experts < 1 || m_rows < 1 || N < 1 || K < 1 || N % VEC || K % VEC)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((static_cast<long long>(m_rows) / TILE_ROWS + n_experts) *
          ((N + TN_NARROW - 1) / TN_NARROW) >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  return N % TN_WIDE == 0
             ? run<TN_WIDE>(x, w, offsets, out, n_experts, m_rows, N, K,
                            stream)
             : run<TN_NARROW>(x, w, offsets, out, n_experts, m_rows, N, K,
                              stream);
}
