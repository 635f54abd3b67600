// scores: every score of the doc-major corpus, stored query-major.
//
// Replaces openmatch_tpu/ops/pallas_mips.py `_score_only_kernel` (K8, via
// `fused_scores`). What it computes, for q [Q, D] bf16 and corpus [N, D]
// bf16 (fp32 sums):
//   scores[q, n] = <q, corpus[n]>                                   [Q, N]
//
// What bounds it on an H100: at Q = 64 each corpus byte feeds 64
// multiply-adds, below the bf16 ridge, so it is bound by bytes: one read of
// the corpus and one write of 4 * Q bytes of scores per corpus row (13.58
// GB read and 2.26 GB written at Q = 64 over 8.84M x 768).
//
// What the design does about it: score_tile_sm90.cuh's mainloop (persistent
// blocks, a TMA producer, wgmma with corpus rows on the M side and up to 256
// queries on the N side, the query tile resident at Q <= 64), so the loads
// of the next tile are in flight while a tile's scores are stored. Each
// consumer warpgroup moves its 64 rows x QN queries through a [64][68]
// fp32 staging tile, 64 queries at a time, so that the stores are
// query-major: a query's 64 scores are 256 contiguous bytes, written as
// 16-byte stores. When N % 4 != 0 a query's row starts off the 16-byte
// grid, and the same kernel writes them as 4-byte stores. Rows past N are
// zero-filled by TMA and not stored; query rows past Q are not stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "score_tile_sm90.cuh"

namespace {

using namespace sm90;

constexpr int LDS = WG_ROWS + 4;  // padded staging row (one query), floats
constexpr int SUB_Q = 64;         // queries staged at a time

template <int QN>
__global__ void __launch_bounds__(THREADS, 1)
scores_kernel(const __grid_constant__ CUtensorMap qmap,
              const __grid_constant__ CUtensorMap cmap,
              float* __restrict__ scores, int Q, long long N, int n_qt,
              const Layout L) {
  uint8_t* sm = aligned_smem();
  Barriers& bar = init_barriers(sm, L);
  const long long n_work = (N + TILE_ROWS - 1) / TILE_ROWS * n_qt;

  if (threadIdx.x >= CONSUMER_THREADS) {
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMER_THREADS)
      produce<QN>(&qmap, L, sm, bar, n_work, n_qt, 1,
                  [&](long long t, const CUtensorMap*& map, int& row0) {
                    map = &cmap;
                    row0 = static_cast<int>(t * TILE_ROWS);
                  });
  } else {
    reg_alloc<CONSUMER_REGS>();
    const int g = threadIdx.x / 128;
    const int tg = threadIdx.x % 128;  // thread of the warpgroup
    const int w = tg / 32;
    const int lane = tg % 32;
    float* const buf =
        reinterpret_cast<float*>(sm + L.off_epi) + g * SUB_Q * LDS;
    const bool aligned = N % 4 == 0;
    if (L.resident) mbar_wait(&bar.q, 0);
    Ring r;
    float acc[QN / 2];
    for_each_item(n_work, 1, [&](long long wk, int, int) {
      const long long n0 = wk / n_qt * TILE_ROWS + g * WG_ROWS;
      const int q0 = static_cast<int>(wk % n_qt) * QN;
      mma_tile<QN>(acc, L, sm, bar, r, g);
#pragma unroll
      for (int sq = 0; sq < QN / SUB_Q; ++sq) {
        const int qb = q0 + sq * SUB_Q;
        if (qb >= Q) break;  // the same for the whole warpgroup
        // buf[query][row]: the transpose of the accumulator's layout
#pragma unroll
        for (int jj = 0; jj < SUB_Q / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            buf[(8 * jj + 2 * (lane & 3) + (e & 1)) * LDS + 16 * w +
                lane / 4 + 8 * (e >> 1)] = acc[4 * (sq * SUB_Q / 8 + jj) + e];
        named_sync(2 + g, 128);
        if (aligned) {
          for (int v = tg; v < SUB_Q * (WG_ROWS / 4); v += 128) {
            const int qq = v / (WG_ROWS / 4);
            const int c = (v % (WG_ROWS / 4)) * 4;
            if (qb + qq < Q && n0 + c < N)
              *reinterpret_cast<float4*>(
                  scores + static_cast<size_t>(qb + qq) * N + n0 + c) =
                  *reinterpret_cast<const float4*>(buf + qq * LDS + c);
          }
        } else {
          for (int v = tg; v < SUB_Q * WG_ROWS; v += 128) {
            const int qq = v / WG_ROWS;
            const int c = v % WG_ROWS;
            if (qb + qq < Q && n0 + c < N)
              scores[static_cast<size_t>(qb + qq) * N + n0 + c] =
                  buf[qq * LDS + c];
          }
        }
        named_sync(2 + g, 128);  // buf is free again
      }
    });
  }
}

template <int QN>
int run(const CUtensorMap& qmap, const CUtensorMap& cmap, void* scores,
        int Q, int D, long long N, void* stream) {
  const Layout L = make_layout(QN, D, CONSUMERS * SUB_Q * LDS * 4);
  if (L.stages < 2) return static_cast<int>(cudaErrorInvalidValue);
  const int n_qt = (Q + QN - 1) / QN;
  const auto kernel = scores_kernel<QN>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid_for((N + TILE_ROWS - 1) / TILE_ROWS * n_qt), THREADS,
           L.bytes, static_cast<cudaStream_t>(stream)>>>(
      qmap, cmap, static_cast<float*>(scores), Q, N, n_qt, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K8: scores [Q, N] fp32. Launches on `stream` and returns
// cudaGetLastError() or a failed tensor-map encode's code
// (score_tile_sm90.cuh). Q, N >= 1, D % 8 == 0, pointers 16-byte aligned.
extern "C" int scores_launch(const void* q, const void* corpus, void* scores,
                             int Q, int D, long long N, void* stream) {
  const int QN = query_tile(Q);
  CUtensorMap qmap, cmap;
  int rc = encode_rows(&qmap, q, Q, D, QN);
  if (!rc) rc = encode_rows(&cmap, corpus, N, D, TILE_ROWS);
  if (rc) return rc;
  return QN == QN_NARROW ? run<QN_NARROW>(qmap, cmap, scores, Q, D, N, stream)
                         : run<QN_WIDE>(qmap, cmap, scores, Q, D, N, stream);
}
