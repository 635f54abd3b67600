// The Hopper (sm_90a) mainloop of the corpus-streaming kernels:
// plain_gmax.cu (K1, K2, K4, K7) and scores.cu (K8); grouped_gemm.cu (K12)
// runs mma_tile over its own schedule, with every stage streamed.
// score_tile.cuh keeps the older wmma mainloop for K9, K10 and K11.
//
// What it computes: fp32 tiles of <corpus row, query> for 128 corpus rows
// by QN queries (QN = 64 for Q <= 64, else 256), bf16 in, fp32 sums; the
// kernel that includes it keeps what its epilogue needs.
//
// What bounds it on an H100: at the serving batch (Q = 64) each corpus byte
// feeds 64 multiply-adds, below the ~295 FLOP/byte ridge of the bf16 tensor
// cores, so the kernels are bound by one read of the corpus from HBM. At
// Q = 512 the tensor cores bound it if the corpus is not read once per
// query tile.
//
// What the design does about it:
// - Persistent blocks: one CUDA block per SM walks over the tiles (runs
//   of a few neighbouring tiles dealt round-robin), so the ring of loads
//   never drains between tiles and one tile's epilogue runs while the
//   next tile's chunks load.
// - One producer thread (warpgroup 2, its registers given up with
//   setmaxnreg; its other three warps are free for a kernel's stores)
//   keeps TMA loads of 64-deep chunks in flight: 128 corpus
//   rows x 128 bytes with the 128-byte swizzle, into a ring of 2-8 stages
//   (as many as shared memory holds) with full and empty mbarriers. The
//   tensor map's extent is the rows that may be read, so TMA zero-fills
//   rows and depth past it without reading them (ragged tiles, D = 776).
// - Corpus rows are the M side of wgmma, queries the N side: each of the
//   two consumer warpgroups issues m64nQNk16 on its 64 rows of the stage
//   against the query tile, both operands K-major from swizzled shared
//   memory. Then the 8 rows of a doc block sit in 8 lanes of one warp,
//   and the query tile is as wide as wgmma allows: the corpus is read once
//   for Q <= 256 and twice at Q = 512.
// - At QN = 64 the query tile ([64, D], 96 KB at D = 768) is loaded once
//   per block and stays in shared memory; query rows past Q are
//   zero-filled by TMA. At QN = 256 ([256, D] does not fit) each stage
//   also carries the tile's 64-deep query chunk, read from L2.
// - TMA coordinates are int32: a tensor map addresses fewer than 2^31 rows
//   (8.84M rows fit).
// - Register arrays are indexed by constants only (`select` below): an
//   array the compiler moves to local memory (ptxas then reports a stack
//   frame) costs far more than the shuffles it was meant to feed.
// perf/ablate.py --kernel gmax times the mainloop alone, with no epilogue.

#pragma once

#include <cuda.h>  // CUtensorMap and cuTensorMapEncodeTiled's types only
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#if CUDART_VERSION < 12010
#error "plain_gmax.cu passes 8 KB of tensor maps as parameters: CUDA >= 12.1"
#endif

namespace sm90 {

constexpr int KC = 64;               // depth per chunk: one 128-byte row
constexpr int ROW_BYTES = KC * 2;
constexpr int TILE_ROWS = 128;       // corpus rows per tile
constexpr int WG_ROWS = 64;          // ... per consumer warpgroup (wgmma M)
constexpr int CONSUMERS = 2;         // consumer warpgroups
constexpr int CONSUMER_THREADS = 128 * CONSUMERS;
constexpr int THREADS = CONSUMER_THREADS + 128;  // + the producer warpgroup
constexpr int QN_NARROW = 64;        // query tile for Q <= 64, resident
constexpr int QN_WIDE = 256;         // query tile for Q > 64, streamed
constexpr int MAX_STAGES = 8;
constexpr int RESIDENT_MIN_STAGES = 4;
constexpr int SMEM_LIMIT = 232448;   // dynamic shared memory a block may ask
constexpr int ALIGN = 1024;          // the 128-byte swizzle's atom
constexpr int PRODUCER_REGS = 64;
constexpr int CONSUMER_REGS = 216;
constexpr int ENCODE_FAILED = 10000;  // returned + CUresult of a failed encode

struct Barriers {
  uint64_t full[MAX_STAGES];   // the stage's bytes have landed
  uint64_t empty[MAX_STAGES];  // every consumer warp is done with it
  uint64_t q;                  // the resident query tile has landed
};

// Where each part of dynamic shared memory lives, from its 1024-aligned
// base: [resident queries][stages][epilogue][barriers].
struct Layout {
  int n_chunks;     // ceil(D / 64)
  int stages;
  int resident;     // 1: queries loaded once; 0: with every chunk
  int stage_bytes;  // 128 corpus rows, then QN query rows when streamed
  int off_stages;
  int off_epi;
  int off_bar;
  int bytes;        // dynamic shared memory to request
};

// stages < 2 means D is too deep for shared memory
inline Layout make_layout(int QN, int D, int epi_bytes) {
  Layout L;
  L.n_chunks = (D + KC - 1) / KC;
  const int fixed = ALIGN + static_cast<int>(sizeof(Barriers)) + epi_bytes;
  const int corpus = TILE_ROWS * ROW_BYTES;
  const int q_bytes = L.n_chunks * QN * ROW_BYTES;
  L.resident = QN == QN_NARROW &&
               fixed + q_bytes + RESIDENT_MIN_STAGES * corpus <= SMEM_LIMIT;
  L.stage_bytes = corpus + (L.resident ? 0 : QN * ROW_BYTES);
  L.off_stages = L.resident ? q_bytes : 0;
  const int fit = (SMEM_LIMIT - fixed - L.off_stages) / L.stage_bytes;
  L.stages = fit < MAX_STAGES ? fit : MAX_STAGES;
  L.off_epi = L.off_stages + L.stages * L.stage_bytes;
  L.off_bar = L.off_epi + epi_bytes;
  L.bytes = L.off_bar + static_cast<int>(sizeof(Barriers)) + ALIGN;
  return L;
}

// ---- PTX wrappers -----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(b)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(b))
               : "memory");
}

// `count` arrivals at once
__device__ __forceinline__ void mbar_arrive(uint64_t* b, int count) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(b)),
               "r"(count)
               : "memory");
}

// Spin until the barrier's phase differs from `parity`. A wait that never
// ends (a broken pipeline) traps after 2^26 tries, so the launch fails with
// an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  const uint32_t a = smem_u32(b);
  uint32_t done, tries = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (!done && ++tries == (1u << 26)) __trap();
  } while (!done);
}

// the box at (x = depth, y = row) of `map` into `dst`, reported to `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
      "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from reading the accumulators before wgmma_wait
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The wgmma descriptor of a K-major tile in 128-byte-swizzled shared memory
// at a 1024-byte boundary: rows of 128 bytes, 8-row groups 1024 bytes apart
// (SBO 64 x 16 B; LBO unused by this layout, 1). The k-th 16-deep slice of
// the 64-deep chunk is this + 2k (32 bytes further; the hardware applies
// the swizzle to the address).
__device__ __forceinline__ uint64_t desc_sw128(const void* tile) {
  return ((smem_u32(tile) & 0x3FFFFu) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64]: bf16 in, fp32 accumulate;
// A and B K-major in 128-byte-swizzled shared memory
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t a,
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}


// A and B K-major in 128-byte-swizzled shared memory
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t a,
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <int QN>
__device__ __forceinline__ void wgmma(float (&d)[QN / 2], uint64_t a,
                                      uint64_t b, int accumulate) {
  static_assert(QN == QN_NARROW || QN == QN_WIDE, "query tile 64 or 256");
  if constexpr (QN == QN_NARROW)
    wgmma_n64(d, a, b, accumulate);
  else
    wgmma_n256(d, a, b, accumulate);
}

template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---- the pipeline -----------------------------------------------------------

// the block's dynamic shared memory from its first 1024-byte boundary
__device__ __forceinline__ uint8_t* aligned_smem() {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t pad = (ALIGN - (smem_u32(smem_raw) & (ALIGN - 1))) &
                       (ALIGN - 1);
  return smem_raw + pad;
}

// thread 0 initialises the barriers; every thread of the block returns them
__device__ __forceinline__ Barriers& init_barriers(uint8_t* sm,
                                                   const Layout& L) {
  Barriers& bar = *reinterpret_cast<Barriers*>(sm + L.off_bar);
  if (threadIdx.x == 0) {
    for (int s = 0; s < L.stages; ++s) {
      mbar_init(&bar.full[s], 1);
      mbar_init(&bar.empty[s], CONSUMER_THREADS / 32);
    }
    mbar_init(&bar.q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return bar;
}

// The block's work items (item w = corpus tile w / n_qt, query tile
// w % n_qt): runs of `run` consecutive items dealt round-robin over the
// blocks. Calls fn(w, j, n) for item j of each run of n items, in order.
template <class Fn>
__device__ __forceinline__ void for_each_item(long long n_work, int run,
                                              const Fn& fn) {
  for (long long r0 = static_cast<long long>(blockIdx.x) * run; r0 < n_work;
       r0 += static_cast<long long>(gridDim.x) * run) {
    const int n = static_cast<int>(n_work - r0 < run ? n_work - r0 : run);
    for (int j = 0; j < n; ++j) fn(r0 + j, j, n);
  }
}

// a position in the ring: stage and the parity of its round
struct Ring {
  int s = 0;
  uint32_t ph = 0;
  __device__ __forceinline__ void next(int stages) {
    if (++s == stages) {
      s = 0;
      ph ^= 1;
    }
  }
};

// The producer, one thread: the resident query tile once, then for each
// of the block's work items (for_each_item) every depth chunk of its 128
// corpus rows, and of its query tile when streamed, into the ring.
// rows(t, map, row0) names the tensor map and first row of corpus tile t.
template <int QN, class Rows>
__device__ __forceinline__ void produce(const CUtensorMap* qmap,
                                        const Layout& L, uint8_t* sm,
                                        Barriers& bar, long long n_work,
                                        int n_qt, int run, const Rows& rows) {
  if (L.resident) {
    mbar_expect_tx(&bar.q, L.n_chunks * QN * ROW_BYTES);
    for (int c = 0; c < L.n_chunks; ++c)
      tma_load(sm + c * QN * ROW_BYTES, qmap, c * KC, 0, &bar.q);
  }
  Ring r;
  for_each_item(n_work, run, [&](long long w, int, int) {
    const CUtensorMap* map;
    int row0;
    rows(w / n_qt, map, row0);
    const int q0 = static_cast<int>(w % n_qt) * QN;
    for (int c = 0; c < L.n_chunks; ++c) {
      mbar_wait(&bar.empty[r.s], r.ph ^ 1);
      uint8_t* st = sm + L.off_stages + r.s * L.stage_bytes;
      mbar_expect_tx(&bar.full[r.s], L.stage_bytes);
      tma_load(st, map, c * KC, row0, &bar.full[r.s]);
      if (!L.resident)
        tma_load(st + TILE_ROWS * ROW_BYTES, qmap, c * KC, q0,
                 &bar.full[r.s]);
      r.next(L.stages);
    }
  });
}

// Consumer warpgroup g's 64 x QN tile: acc = <corpus row 64 g + m of the
// tile, query n of the query tile> over every depth chunk. Thread (warp w,
// lane l) holds rows 16w + l/4 (acc[4j], acc[4j+1]) and 16w + 8 + l/4
// (acc[4j+2], acc[4j+3]), queries 8j + 2(l%4) and 8j + 2(l%4) + 1. Each
// stage is released once the wgmma groups that read it have completed.
template <int QN>
__device__ __forceinline__ void mma_tile(float (&acc)[QN / 2],
                                         const Layout& L, uint8_t* sm,
                                         Barriers& bar, Ring& r, int g) {
  const bool lead = threadIdx.x % 32 == 0;
  int prev = -1;
  for (int c = 0; c < L.n_chunks; ++c) {
    mbar_wait(&bar.full[r.s], r.ph);
    const uint8_t* st = sm + L.off_stages + r.s * L.stage_bytes;
    const uint64_t a = desc_sw128(st + g * WG_ROWS * ROW_BYTES);
    const uint64_t b = desc_sw128(L.resident ? sm + c * QN * ROW_BYTES
                                             : st + TILE_ROWS * ROW_BYTES);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < KC / 16; ++k)
      wgmma<QN>(acc, a + 2 * k, b + 2 * k, c > 0 || k > 0);
    wgmma_commit();
    wgmma_wait<1>();  // the previous chunk's products are done
    if (prev >= 0 && lead) mbar_arrive(&bar.empty[prev]);
    prev = r.s;
    r.next(L.stages);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (lead) mbar_arrive(&bar.empty[prev]);
}

// c ? a : b on registers; written as `selp` so that the compiler cannot
// turn a choice between two elements of a register array into a runtime
// index into a copy of it in local memory
__device__ __forceinline__ float select(bool c, float a, float b) {
  float r;
  asm("{\n.reg .pred p;\nsetp.ne.u32 p, %3, 0;\nselp.f32 %0, %1, %2, p;\n}\n"
      : "=f"(r)
      : "f"(a), "f"(b), "r"(static_cast<uint32_t>(c)));
  return r;
}

// The maxima over each 8-row doc block of a consumer's 64 x QN tile. The 8
// rows of a block are lane bits 2-4 of one warp; three halving exchanges
// (xor 4, 8, 16) leave each lane the maxima of QN / 32 of the block's
// queries. Calls put(query, half, max) for block 2 * warp + half of the
// consumer's 8.
template <int QN, class Put>
__device__ __forceinline__ void block_maxima(const float (&acc)[QN / 2],
                                             int lane, const Put& put) {
  constexpr int V = QN / 4;  // a block's values held by one thread
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float v[V];
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = acc[4 * (i >> 1) + 2 * half + (i & 1)];
    // keep the half of v that this lane's bit names and max in the
    // partner's copy of it: lane bit 2, then 3, then 4 (constant bounds,
    // so v stays in registers)
    const bool b2 = (lane >> 2) & 1, b3 = (lane >> 3) & 1,
               b4 = (lane >> 4) & 1;
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {
      const float send = select(b2, v[i], v[i + V / 2]);
      v[i] = fmaxf(select(b2, v[i + V / 2], v[i]),
                   __shfl_xor_sync(0xffffffffu, send, 4));
    }
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      const float send = select(b3, v[i], v[i + V / 4]);
      v[i] = fmaxf(select(b3, v[i + V / 4], v[i]),
                   __shfl_xor_sync(0xffffffffu, send, 8));
    }
#pragma unroll
    for (int i = 0; i < V / 8; ++i) {
      const float send = select(b4, v[i], v[i + V / 8]);
      v[i] = fmaxf(select(b4, v[i + V / 8], v[i]),
                   __shfl_xor_sync(0xffffffffu, send, 16));
    }
    const int base = b2 * (V / 2) + b3 * (V / 4) + b4 * (V / 8);
#pragma unroll
    for (int i = 0; i < V / 8; ++i) {
      const int idx = base + i;
      put(8 * (idx >> 1) + 2 * (lane & 3) + (idx & 1), half, v[i]);
    }
  }
}

// ---- host side --------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up in the libcuda the runtime loaded: the
// library links with nvcc alone, not with libcuda
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    return err == cudaSuccess && res == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A tensor map of `rows` x D bf16 row-major at `base` (16-byte aligned,
// D % 8 == 0) in boxes of 64 deep x box_rows, 128-byte swizzled; what lies
// past `rows` or D is zero-filled. Returns 0, cudaErrorInvalidValue, or
// ENCODE_FAILED + the CUresult.
inline int encode_rows(CUtensorMap* map, const void* base, long long rows,
                       int D, int box_rows) {
  if (rows < 1 || rows >= (1ll << 31) || D < 8 || D % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled fn = encode_tiled();
  if (!fn) return ENCODE_FAILED + static_cast<int>(CUDA_ERROR_NOT_FOUND);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(D) * 2};
  const cuuint32_t box[2] = {KC, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
         dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_FAILED + static_cast<int>(r);
}

// the query tile width for Q queries
inline int query_tile(int Q) { return Q <= QN_NARROW ? QN_NARROW : QN_WIDE; }

// one persistent block per SM of the current device, at most one per item
inline int grid_for(long long n_work) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return static_cast<int>(n_work < sms ? n_work : sms);
}

}  // namespace sm90
