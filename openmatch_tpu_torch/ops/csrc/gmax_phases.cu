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
//            for a query-major store. Here it is K2's epilogue
//            (plain_gmax.cu with emit_l1 = 0): the same mainloop, query
//            tile and shuffle reduction, so the values are bit-equal to
//            fused_plain_gmax's.
//   a3notr   the same maxima stored doc-major                    [NB, Q]
//            On the TPU this skipped the transpose. Here too the wgmma
//            accumulator is doc-major (corpus rows on M), so the maxima are
//            parked doc-major ([block][query] staging) and each block's QN
//            queries are stored as one contiguous run of its output row.
//   a3mxutr  a3base's values                                     [Q, NB]
//            The TPU moved the transpose onto the matrix unit, as a product
//            with an identity. Here the staged [QN][blocks] maxima pass
//            through the tensor cores as tf32 mma.sync m16n8k8 products
//            with an 8 x 8 identity, in place, before the query-major
//            store. tf32 keeps 10 mantissa bits, so each maximum is split
//            into three tf32 parts (hi + mid + lo == g exactly: 11 + 11 + 2
//            significant bits) and the three products accumulate in fp32 on
//            the identity's diagonal; every partial sum is representable,
//            so the result equals a3base for normal values (the check
//            allows 2^-22 * |g| all the same, and counts the entries that
//            are not bit-equal).
//   a3nomax  g[q, b] = <q, plain[8b]>: member 0 only, no max     [Q, NB]
//            Read straight from the lanes that hold each block's first row
//            (accumulator row bits 2-4 zero), no shuffles: the same
//            products as scores.cu (K8), so bit-equal to its every 8th
//            score.
//
// What bounds it on an H100: at the script's Q = 512 every corpus byte feeds
// 512 multiply-adds, above the ~295 FLOP/byte ridge of bf16 tensor cores,
// so the bound is the tensor cores: 2 * Q * NB*8 * D operations (1.74
// TFLOP at 512 x 2,211,840 x 768, 1.76 ms at 989 TFLOP/s), against 1.18 ms
// to move 3.40 GB of corpus and 0.57 GB of maxima at 3.35 TB/s.
//
// What the design does about it: score_tile_sm90.cuh's mainloop, the one
// K1/K2 run (persistent blocks, one TMA producer thread, two wgmma
// consumer warpgroups, QN = 256 queries per tile at Q > 64 so the corpus
// is read twice at Q = 512, the query tile resident at Q <= 64). Each
// consumer parks its tile's values in a staging buffer sized as K2's and
// goes on to the next tile; the other three warps of the producer
// warpgroup run the phase's store (and a3mxutr's identity products) from
// it, under the next tile's loads. Q is any size and the body any multiple
// of 8 rows: rows past NB*8 are zero-filled by TMA and not stored, nor are
// query rows past Q.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "score_tile_sm90.cuh"

namespace {

using namespace sm90;

constexpr int GROUP = 8;                // docs per block
constexpr int NBT = TILE_ROWS / GROUP;  // blocks per tile (16)

enum Phase { kBase = 0, kNoTranspose = 1, kMxuTranspose = 2, kNoMax = 3 };

// K2's run of neighbouring tiles per block (plain_gmax.cu kRunTiles): 16 at
// QN = 64, one at QN = 256
template <int QN>
constexpr int kRunTiles = QN == QN_NARROW ? 16 : 1;

template <int QN>
constexpr int kRunBlocks = kRunTiles<QN> * NBT;

// staging rows: query-major [QN][kLdg] as K2's, or doc-major
// [kRunBlocks][kLdt] (a3notr); both fit in K2's staging bytes, so the
// shared-memory layout (and the ring's stage count) is K2's
template <int QN>
constexpr int kLdg = kRunBlocks<QN> + 4;
template <int QN>
constexpr int kLdt = QN + 1;
template <int QN>
constexpr int kStagingFloats = QN * kLdg<QN>;
static_assert(kRunBlocks<QN_NARROW> * kLdt<QN_NARROW> <=
                      kStagingFloats<QN_NARROW> &&
                  kRunBlocks<QN_WIDE> * kLdt<QN_WIDE> <=
                      kStagingFloats<QN_WIDE>,
              "the doc-major staging must fit in K2's");

// consumers -> storers, as in plain_gmax.cu
struct Handoff {
  uint64_t staged;  // the consumers' 8 warps wrote the run's values
  uint64_t freed;   // the 3 storer warps have stored them
};

constexpr int STORER_THREADS = 96;  // warps 1-3 of the producer warpgroup
constexpr int STORER_BARRIER = 1;   // named barrier of the storer warps

template <int QN>
constexpr int kEpiBytes =
    kStagingFloats<QN> * 4 + static_cast<int>(sizeof(Handoff));

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// d = a * b + d for one m16n8k8 tile: a row-major 16 x 8, b column-major
// 8 x 8, both tf32, d fp32
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a3mxutr: every 16-query x 8-block tile of the query-major staging
// becomes (tile x identity) on the tensor cores, in place; storer warp sw
// takes tiles sw, sw + 3, ... Lane (g, t) = (lane / 4, lane % 4) holds A at
// rows g, g + 8 and columns t, t + 4, the identity's column g at rows t and
// t + 4, and the product at rows g, g + 8 and columns 2t, 2t + 1. A warp's
// loads feed its mma.sync before any lane stores, so in place is safe.
template <int QN>
__device__ __forceinline__ void identity_products(float* gs, int st) {
  constexpr int LDG = kLdg<QN>;
  constexpr int BT = kRunBlocks<QN> / 8;  // 8-block tiles across
  const int lane = st % 32;
  const int g = lane / 4, t = lane % 4;
  const uint32_t one = __float_as_uint(1.0f);
  const uint32_t b0 = t == g ? one : 0u, b1 = t + 4 == g ? one : 0u;
  for (int tile = st / 32; tile < QN / 16 * BT; tile += STORER_THREADS / 32) {
    float* const x = gs + (tile / BT) * 16 * LDG + (tile % BT) * 8;
    const float a[4] = {x[g * LDG + t], x[(g + 8) * LDG + t],
                        x[g * LDG + t + 4], x[(g + 8) * LDG + t + 4]};
    uint32_t hi[4], mid[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      hi[e] = to_tf32(a[e]);
      const float r = a[e] - __uint_as_float(hi[e]);  // exact
      mid[e] = to_tf32(r);
      lo[e] = to_tf32(r - __uint_as_float(mid[e]));  // exact, 2 bits
    }
    float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    mma_tf32(d, hi, b0, b1);
    mma_tf32(d, mid, b0, b1);
    mma_tf32(d, lo, b0, b1);
    *reinterpret_cast<float2*>(x + g * LDG + 2 * t) = make_float2(d[0], d[1]);
    *reinterpret_cast<float2*>(x + (g + 8) * LDG + 2 * t) =
        make_float2(d[2], d[3]);
  }
}

template <int QN, int kPhase>
__global__ void __launch_bounds__(THREADS, 1)
gmax_phase_kernel(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap cmap,
                  float* __restrict__ out, int Q, long long NB, int n_qt,
                  const Layout L) {
  constexpr int RUN = kRunTiles<QN>;
  constexpr int W = kRunBlocks<QN>;
  constexpr int LDG = kLdg<QN>;
  constexpr int LDT = kLdt<QN>;
  constexpr bool kDocMajor = kPhase == kNoTranspose;
  uint8_t* sm = aligned_smem();
  float* const staging = reinterpret_cast<float*>(sm + L.off_epi);
  Handoff& hand =
      *reinterpret_cast<Handoff*>(staging + kStagingFloats<QN>);
  if (threadIdx.x == 0) {
    mbar_init(&hand.staged, RUN * CONSUMER_THREADS / 32);
    mbar_init(&hand.freed, STORER_THREADS / 32);
  }
  Barriers& bar = init_barriers(sm, L);  // also fences and syncs these
  const long long n_work = (NB + NBT - 1) / NBT * n_qt;

  if (threadIdx.x >= CONSUMER_THREADS) {
    reg_dealloc<PRODUCER_REGS>();
    const int t = threadIdx.x - CONSUMER_THREADS;
    if (t == 0) {
      produce<QN>(&qmap, L, sm, bar, n_work, n_qt, RUN,
                  [&](long long tile, const CUtensorMap*& map, int& row0) {
                    map = &cmap;
                    row0 = static_cast<int>(tile * TILE_ROWS);
                  });
    } else if (t >= 32) {
      // the storers: each run's staged values to out
      const int st = t - 32;
      int i = 0;
      for_each_item(n_work, RUN, [&](long long wk, int j, int n) {
        if (j + 1 < n) return;  // the run's last item: its values are staged
        const long long r0 = wk - j;
        const long long b0 = r0 / n_qt * NBT;  // the run's first block
        const int q0 = static_cast<int>(r0 % n_qt) * QN;
        const int nb_here = static_cast<int>(
            NB - b0 < static_cast<long long>(n) * NBT ? NB - b0 : n * NBT);
        float* const gs = staging;
        mbar_wait(&hand.staged, i & 1);
        if (kPhase == kMxuTranspose) {
          identity_products<QN>(gs, st);
          named_sync(STORER_BARRIER, STORER_THREADS);
        }
        if (kDocMajor) {  // each block's queries: one run of its out row
          for (int v = st; v < W * QN; v += STORER_THREADS) {
            const int b = v / QN;
            const int q = v % QN;
            if (b < nb_here && q0 + q < Q)
              out[static_cast<size_t>(b0 + b) * Q + q0 + q] = gs[b * LDT + q];
          }
        } else if (NB % 4 == 0) {  // query rows start on the 16-byte grid
          for (int v = st; v < QN * (W / 4); v += STORER_THREADS) {
            const int q = v / (W / 4);
            const int c = (v % (W / 4)) * 4;
            if (q0 + q >= Q || c >= nb_here) continue;
            float* const dst = out + static_cast<size_t>(q0 + q) * NB + b0 + c;
            if (c + 4 <= nb_here)
              *reinterpret_cast<float4*>(dst) =
                  *reinterpret_cast<const float4*>(gs + q * LDG + c);
            else
              for (int e = 0; c + e < nb_here; ++e)
                dst[e] = gs[q * LDG + c + e];
          }
        } else {  // consecutive threads on consecutive blocks of a row
          for (int v = st; v < QN * W; v += STORER_THREADS) {
            const int q = v / W;
            const int b = v % W;
            if (q0 + q < Q && b < nb_here)
              out[static_cast<size_t>(q0 + q) * NB + b0 + b] = gs[q * LDG + b];
          }
        }
        __syncwarp();
        if (st % 32 == 0) mbar_arrive(&hand.freed);
        ++i;
      });
    }
  } else {
    // the consumers: each tile's products, then the phase's values into
    // the run's staging buffer; the storers take it from there
    reg_alloc<CONSUMER_REGS>();
    const int g = threadIdx.x / 128;       // consumer warpgroup: rows 64 g ..
    const int w = (threadIdx.x / 32) % 4;  // warp: blocks 2w, 2w + 1 of those
    const int lane = threadIdx.x % 32;
    if (L.resident) mbar_wait(&bar.q, 0);
    Ring r;
    float acc[QN / 2];
    int i = 0;  // runs done
    for_each_item(n_work, RUN, [&](long long, int j, int n) {
      mma_tile<QN>(acc, L, sm, bar, r, g);
      const int bj = j * NBT + g * 8 + 2 * w;  // this warp's first block
      if (j == 0) mbar_wait(&hand.freed, (i & 1) ^ 1);
      if (kPhase == kNoMax) {
        // lanes 0-3 hold row 0 of blocks bj (acc[4c], acc[4c + 1]) and
        // bj + 1 (acc[4c + 2], acc[4c + 3]), queries 8c + 2 lane + e
        if (lane < 4) {
#pragma unroll
          for (int c = 0; c < QN / 8; ++c)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              staging[(8 * c + 2 * lane + (e & 1)) * LDG + bj + (e >> 1)] =
                  acc[4 * c + e];
        }
      } else {
        block_maxima<QN>(acc, lane, [&](int q, int half, float m) {
          staging[kDocMajor ? (bj + half) * LDT + q : q * LDG + bj + half] =
              m;
        });
      }
      __syncwarp();
      // a short last run arrives for the tiles it lacks
      if (lane == 0) mbar_arrive(&hand.staged, j + 1 < n ? 1 : 1 + RUN - n);
      if (j + 1 == n) ++i;
    });
  }
}

template <int QN, int kPhase>
int run(const CUtensorMap& qmap, const CUtensorMap& cmap, void* out, int Q,
        int D, long long NB, void* stream) {
  const Layout L = make_layout(QN, D, kEpiBytes<QN>);
  if (L.stages < 2) return static_cast<int>(cudaErrorInvalidValue);
  const int n_qt = (Q + QN - 1) / QN;
  const auto kernel = gmax_phase_kernel<QN, kPhase>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid_for((NB + NBT - 1) / NBT * n_qt), THREADS, L.bytes,
           static_cast<cudaStream_t>(stream)>>>(
      qmap, cmap, static_cast<float*>(out), Q, NB, n_qt, L);
  return static_cast<int>(cudaGetLastError());
}

template <int QN>
int launch(const CUtensorMap& qmap, const CUtensorMap& cmap, void* out,
           int Q, int D, long long NB, int phase, void* stream) {
  switch (phase) {
    case kBase:
      return run<QN, kBase>(qmap, cmap, out, Q, D, NB, stream);
    case kNoTranspose:
      return run<QN, kNoTranspose>(qmap, cmap, out, Q, D, NB, stream);
    case kMxuTranspose:
      return run<QN, kMxuTranspose>(qmap, cmap, out, Q, D, NB, stream);
    case kNoMax:
      return run<QN, kNoMax>(qmap, cmap, out, Q, D, NB, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// K11: `phase` 0 a3base, 1 a3notr, 2 a3mxutr, 3 a3nomax. out is [Q, NB]
// fp32, or [NB, Q] for a3notr. Q, NB >= 1, D % 8 == 0, pointers 16-byte
// aligned. Launches on `stream` and returns cudaGetLastError() or a failed
// tensor-map encode's code (score_tile_sm90.cuh).
extern "C" int gmax_phase_launch(const void* q, const void* plain, void* out,
                                 int Q, int D, long long NB, int phase,
                                 void* stream) {
  if (phase < kBase || phase > kNoMax)
    return static_cast<int>(cudaErrorInvalidValue);
  const int QN = query_tile(Q);
  CUtensorMap qmap, cmap;
  int rc = encode_rows(&qmap, q, Q, D, QN);
  if (!rc) rc = encode_rows(&cmap, plain, NB * GROUP, D, TILE_ROWS);
  if (rc) return rc;
  return QN == QN_NARROW
             ? launch<QN_NARROW>(qmap, cmap, out, Q, D, NB, phase, stream)
             : launch<QN_WIDE>(qmap, cmap, out, Q, D, NB, phase, stream);
}
