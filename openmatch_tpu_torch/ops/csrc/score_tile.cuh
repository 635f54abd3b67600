// One 64-query x 128-row fp32 score tile: the wmma mainloop of
// score_tiles.cu (K9, K10) and gmax_phases.cu (K11), its only users. Only
// which corpus rows a tile reads (a row map) and what the epilogue keeps
// differ. (K1, K2, K4, K7 and K8 run on score_tile_sm90.cuh.)
//
// The tile is computed from queries q [Q, D] bf16 and 128 corpus rows of D
// bf16 each, with fp32 accumulation. D is consumed in 64-wide chunks
// through a 3-stage ring in shared memory fed by cp.async 16-byte copies,
// so the loads of the next two chunks are in flight while the tensor cores
// (wmma bf16 16x16x16) work on the current one. Query rows >= Q and corpus
// rows the map marks missing are zero-filled in shared memory without being
// read, so ragged edges need no padded copy. The finished tile is left in
// shared memory (Smem::s), over the dead operand ring.

#pragma once

#include <cuda_bf16.h>
#include <mma.h>

namespace score_tile {

constexpr int TQ = 64;        // queries per CUDA block
constexpr int TD = 128;       // corpus rows per CUDA block
constexpr int KC = 64;        // depth staged per step
constexpr int LDS = KC + 8;   // padded shared row, bf16 elements
constexpr int LDC = TD + 4;   // padded score row, floats
constexpr int THREADS = 256;  // 8 warps: 4 over queries x 2 over rows
constexpr int VEC = 8;        // bf16 per 16-byte load
constexpr int STAGES = 3;     // depth chunks in flight

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

// start the copies of depth chunk [k0, k0 + KC) into one stage. Rows is a
// row map: rows.ok(r) says whether tile row r exists, rows.at(r) points at
// its first element, rows.base is any readable address of the corpus.
template <class Rows>
__device__ __forceinline__ void load_chunk(Operands& st,
                                           const __nv_bfloat16* __restrict__ q,
                                           int Q, int D, int q0,
                                           const Rows& rows, int k0,
                                           int tid) {
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
    const bool ok = rows.ok(r) && k0 + c < D;
    cp_async16(&st.d[r][c], ok ? rows.at(r) + k0 + c : rows.base,
               ok ? 16 : 0);
  }
}

// s[r][c] = <q[q0 + r], row c of the map> for the 64 x 128 tile, left in
// sm.s for every thread of the CUDA block (THREADS threads).
template <class Rows>
__device__ __forceinline__ void compute(Smem& sm,
                                        const __nv_bfloat16* __restrict__ q,
                                        int Q, int D, int q0,
                                        const Rows& rows) {
  using namespace nvcuda;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wq = warp & 3;   // 16-query slice of the tile
  const int wd = warp >> 2;  // 64-row slice of the tile

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.0f);

  // a STAGES-deep ring: while the tensor cores work on chunk c, the
  // copies of chunks c+1 .. c+STAGES-1 are in flight
  const int n_chunks = (D + KC - 1) / KC;
#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < n_chunks) load_chunk(sm.ops[c], q, Q, D, q0, rows, c * KC, tid);
    cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<STAGES - 2>();  // chunk c has landed (for this thread)
    __syncthreads();              // ... for every thread; stage c-1 is free
    const int next = c + STAGES - 1;
    if (next < n_chunks)
      load_chunk(sm.ops[next % STAGES], q, Q, D, q0, rows, next * KC, tid);
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
        // rows are stored [row][depth]: as the K x N operand that is
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
}

}  // namespace score_tile
