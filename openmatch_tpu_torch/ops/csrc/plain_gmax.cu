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
// [NB*8, D], the same bytes, so K7 is the single-buffer instantiation with
// no level 1 and no masking, behind its own entry point `block_gmax_launch`.
//
// What it computes, for queries q [Q, D] bf16 and the body [NB*8, D] bf16
// held as one or more segments, over the window of global blocks
// [blk_lo, blk_lo + n_blk):
//   gmax[q, b] = max_{m<8} <q, body[(blk_lo + b)*8 + m]>      (fp32)
//   gmax[q, b] = -FLT_MAX  where blk_lo + b >= nb_valid
//   l1[q, i]   = max_{b in [i*f, i*f+f) and b < n_blk} gmax[q, b]   (f > 0)
// Both outputs are query-major. -FLT_MAX is finfo(float32).min, the value
// the TPU kernel masks with; it is finite on purpose.
//
// What bounds it on an H100: at the serving batch (Q = 64) every corpus
// byte feeds 64 multiply-adds, below the ~295 FLOP/byte ridge of bf16
// tensor cores, so the kernel is bound by reading the corpus once from HBM
// (12.65 GiB at 8.84M x 768); at Q = 512, by the tensor cores.
//
// What the design does about it: score_tile_sm90.cuh's mainloop (persistent
// blocks, a TMA producer, wgmma with the corpus rows on the M side and up
// to 256 queries on the N side, the query tile resident at Q <= 64). A tile
// is 128 doc rows = 16 blocks; each consumer warpgroup reduces the 8 rows
// of its 8 blocks in registers with three warp shuffles, masks them, parks
// them in a [QN][run] staging tile and goes on to the next tile. The other
// three warps of the producer warpgroup store the staging tile once a run
// of neighbouring tiles is in it (16 tiles at QN = 64), each query's block
// maxima as 16-byte stores when n_blk % 4 == 0 puts rows on the 16-byte
// grid (else as 4-byte stores, consecutive threads on consecutive blocks),
// and take its level-1 maxima from it. The pattern of these writes is
// what the epilogue costs: one tile's 64-byte pieces of 64 query rows per
// store cost the stream far more than runs of 1 KB per row (measured
// against shorter runs, and against the kernel without stores or without
// any epilogue). The [Q, NB] maxima are 1/8 of the score bytes. All
// offsets into the outputs are 64-bit: at 8.84M x 768 they pass 2^32.
//
// Segments and windows: one tensor map per segment, passed by value as a
// __grid_constant__ parameter (64 maps are 8 KB; CUDA >= 12.1 allows
// 32,764 bytes of parameters). A map's extent ends at the segment's or the
// window's end, whichever comes first, so rows past the window are
// zero-filled by TMA and never read; blocks past the window are neither
// stored nor taken into l1. Every tile lies inside one segment (the
// caller cuts segments at multiples of 16 blocks after blk_lo), so a tile
// resolves its segment once; output columns and nb_valid stay global. One
// launch covers all segments, where the TPU needed one `pallas_call` per
// segment with aliased, windowed outputs. The segmented kernel is its own
// instantiation (kSegmented), so the single buffer never searches a table.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>
#include <string.h>

#include "score_tile_sm90.cuh"
#include "segments.cuh"

namespace {

using namespace sm90;

constexpr int GROUP = 8;                // docs per block
constexpr int NBT = TILE_ROWS / GROUP;  // blocks per tile

// The corpus as tensor maps: segment s holds global blocks
// [blk0[s], blk0[s + 1]) in map[s]. Maps of segments outside the window
// are zero and never used.
template <int kMaxSegs>
struct SegMaps {
  CUtensorMap map[kMaxSegs];
  long long blk0[kMaxSegs + 1];
  int n;
};

// Tiles per run of neighbouring tiles one block takes (for_each_item): at
// QN = 64 a run of 16 tiles gives each query 256 neighbouring block maxima,
// 1 KB written contiguously (shorter runs measured slower); at QN = 256
// one tile's staging takes 20 KB, so a run is one item
template <int QN>
constexpr int kRunTiles = QN == QN_NARROW ? 16 : 1;

// a staging row: one query's maxima of a run, padded
template <int QN>
constexpr int kLdg = kRunTiles<QN> * NBT + 4;

// The epilogue's hand-off in shared memory, after the staging buffer
// ([QN][kLdg] block maxima of one run). One buffer: the consumers wait for
// it only at a run's first tile, and a pause of theirs costs little while
// the loads of the ring are in flight.
struct Handoff {
  uint64_t staged;  // the consumers' 8 warps wrote the run's maxima
  uint64_t freed;   // the 3 storer warps have stored them
};

constexpr int STORER_THREADS = 96;  // warps 1-3 of the producer warpgroup

template <int QN>
constexpr int kEpiBytes =
    QN * kLdg<QN> * 4 + static_cast<int>(sizeof(Handoff));

template <int QN, bool kSegmented>
__global__ void __launch_bounds__(THREADS, 1)
plain_gmax_kernel(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ SegMaps<kSegmented ? MAX_SEGS : 1>
                      segs,
                  float* __restrict__ gmax, float* __restrict__ l1, int Q,
                  long long blk_lo, long long n_blk, long long nb_valid,
                  int f, int n_qt, const Layout L) {
  constexpr int RUN = kRunTiles<QN>;
  constexpr int LDG = kLdg<QN>;
  uint8_t* sm = aligned_smem();
  float* const staging = reinterpret_cast<float*>(sm + L.off_epi);
  Handoff& hand = *reinterpret_cast<Handoff*>(staging + QN * LDG);
  if (threadIdx.x == 0) {
    mbar_init(&hand.staged, RUN * CONSUMER_THREADS / 32);
    mbar_init(&hand.freed, STORER_THREADS / 32);
  }
  Barriers& bar = init_barriers(sm, L);  // also fences and syncs these
  const long long n_work = (n_blk + NBT - 1) / NBT * n_qt;

  if (threadIdx.x >= CONSUMER_THREADS) {
    reg_dealloc<PRODUCER_REGS>();
    const int t = threadIdx.x - CONSUMER_THREADS;
    if (t == 0) {
      produce<QN>(&qmap, L, sm, bar, n_work, n_qt, RUN,
                  [&](long long tile, const CUtensorMap*& map, int& row0) {
                    const long long gb0 = blk_lo + tile * NBT;
                    const int s = kSegmented ? seg_of(segs, gb0) : 0;
                    map = &segs.map[s];
                    row0 = static_cast<int>((gb0 - segs.blk0[s]) * GROUP);
                  });
    } else if (t >= 32) {
      // the storers: each run's staged maxima to gmax and l1. A run of
      // n > 1 items is n tiles of one query tile (RUN > 1 only at QN = 64,
      // where Q <= 64 makes n_qt 1)
      const int st = t - 32;
      const long long n_l1 = f > 0 ? (n_blk + f - 1) / f : 0;
      constexpr int W = RUN * NBT;  // blocks a run can hold
      int i = 0;
      for_each_item(n_work, RUN, [&](long long wk, int j, int n) {
        if (j + 1 < n) return;  // the run's last item: its maxima are staged
        const long long r0 = wk - j;
        const long long b0 = r0 / n_qt * NBT;  // the run's first block
        const int q0 = static_cast<int>(r0 % n_qt) * QN;
        const int nb_here = static_cast<int>(
            n_blk - b0 < static_cast<long long>(n) * NBT ? n_blk - b0
                                                         : n * NBT);
        const float* const gs = staging;
        mbar_wait(&hand.staged, i & 1);
        if (n_blk % 4 == 0) {  // rows start on the 16-byte grid
          for (int v = st; v < QN * (W / 4); v += STORER_THREADS) {
            const int q = v / (W / 4);
            const int c = (v % (W / 4)) * 4;
            if (q0 + q >= Q || c >= nb_here) continue;
            float* const dst =
                gmax + static_cast<size_t>(q0 + q) * n_blk + b0 + c;
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
              gmax[static_cast<size_t>(q0 + q) * n_blk + b0 + b] =
                  gs[q * LDG + b];
          }
        }
        if (f > 0) {
          const int per = W / f;
          for (int v = st; v < QN * per; v += STORER_THREADS) {
            const int q = v / per;
            const int k = v % per;
            float m = -FLT_MAX;
            for (int u = 0; u < f; ++u)
              if (k * f + u < nb_here) m = fmaxf(m, gs[q * LDG + k * f + u]);
            const long long li = b0 / f + k;
            if (q0 + q < Q && li < n_l1)
              l1[static_cast<size_t>(q0 + q) * n_l1 + li] = m;
          }
        }
        __syncwarp();
        if (st % 32 == 0) mbar_arrive(&hand.freed);
        ++i;
      });
    }
  } else {
    // the consumers: each tile's products, then its masked block maxima
    // into the run's staging buffer; the storers take it from there
    reg_alloc<CONSUMER_REGS>();
    const int g = threadIdx.x / 128;       // consumer warpgroup: rows 64 g ..
    const int w = (threadIdx.x / 32) % 4;  // warp: blocks 2w, 2w + 1 of those
    const int lane = threadIdx.x % 32;
    if (L.resident) mbar_wait(&bar.q, 0);
    Ring r;
    float acc[QN / 2];
    int i = 0;  // runs done
    for_each_item(n_work, RUN, [&](long long wk, int j, int n) {
      const long long b0 = wk / n_qt * NBT;
      mma_tile<QN>(acc, L, sm, bar, r, g);
      float* const gs = staging + j * NBT;
      if (j == 0) mbar_wait(&hand.freed, (i & 1) ^ 1);
      block_maxima<QN>(acc, lane, [&](int q, int half, float m) {
        const int b = g * 8 + 2 * w + half;
        gs[q * LDG + b] = blk_lo + b0 + b >= nb_valid ? -FLT_MAX : m;
      });
      __syncwarp();
      // a short last run arrives for the tiles it lacks
      if (lane == 0) mbar_arrive(&hand.staged, j + 1 < n ? 1 : 1 + RUN - n);
      if (j + 1 == n) ++i;
    });
  }
}

template <int QN, int kMaxSegs>
int run(const CUtensorMap& qmap, const SegMaps<kMaxSegs>& segs, void* gmax,
        void* l1, int Q, int D, long long blk_lo, long long n_blk,
        long long nb_valid, int f, void* stream) {
  const Layout L = make_layout(QN, D, kEpiBytes<QN>);
  if (L.stages < 2) return static_cast<int>(cudaErrorInvalidValue);
  const int n_qt = (Q + QN - 1) / QN;
  const auto kernel = plain_gmax_kernel<QN, (kMaxSegs > 1)>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid_for((n_blk + NBT - 1) / NBT * n_qt), THREADS, L.bytes,
           static_cast<cudaStream_t>(stream)>>>(
      qmap, segs, static_cast<float*>(gmax), static_cast<float*>(l1), Q,
      blk_lo, n_blk, nb_valid, f, n_qt, L);
  return static_cast<int>(cudaGetLastError());
}

// the tensor maps of the segments the window reaches, then the launch
template <int kMaxSegs>
int launch_gmax(const void* q, const void* const* seg_base,
                const long long* seg_blk0, int n_segs, void* gmax, void* l1,
                int Q, int D, long long blk_lo, long long n_blk,
                long long nb_valid, int f, void* stream) {
  if (n_segs < 1 || n_segs > kMaxSegs)
    return static_cast<int>(cudaErrorInvalidValue);
  SegMaps<kMaxSegs> segs;  // copied into the launch's parameters
  memset(&segs, 0, sizeof(segs));
  segs.n = n_segs;
  const long long hi = blk_lo + n_blk;
  for (int s = 0; s < n_segs; ++s) {
    if (seg_blk0[s + 1] < seg_blk0[s])
      return static_cast<int>(cudaErrorInvalidValue);
    segs.blk0[s] = seg_blk0[s];
    const long long end = seg_blk0[s + 1] < hi ? seg_blk0[s + 1] : hi;
    if (end <= seg_blk0[s] || seg_blk0[s + 1] <= blk_lo) continue;
    const int rc = encode_rows(&segs.map[s], seg_base[s],
                               (end - seg_blk0[s]) * GROUP, D, TILE_ROWS);
    if (rc) return rc;
  }
  segs.blk0[n_segs] = seg_blk0[n_segs];
  const int QN = query_tile(Q);
  CUtensorMap qmap;
  const int rc = encode_rows(&qmap, q, Q, D, QN);
  if (rc) return rc;
  return QN == QN_NARROW
             ? run<QN_NARROW>(qmap, segs, gmax, l1, Q, D, blk_lo, n_blk,
                              nb_valid, f, stream)
             : run<QN_WIDE>(qmap, segs, gmax, l1, Q, D, blk_lo, n_blk,
                            nb_valid, f, stream);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(), or the code of a
// failed tensor-map encode (score_tile_sm90.cuh). The corpus is the n_segs
// segments at seg_base (host array), segment s holding global blocks
// [seg_blk0[s], seg_blk0[s + 1]) (host array of n_segs + 1); every cut
// inside the window must sit a multiple of 16 blocks after blk_lo. `l1`
// may be null when f == 0; f must divide 16 (the blocks of one tile).
// nb_valid masks global block ids >= nb_valid (pass a value >= blk_lo +
// n_blk for none). Q, n_blk >= 1, D % 8 == 0, pointers 16-byte aligned.
extern "C" int plain_gmax_launch(const void* q, const void* const* seg_base,
                                 const long long* seg_blk0, int n_segs,
                                 void* gmax, void* l1, int Q, int D,
                                 long long blk_lo, long long n_blk,
                                 long long nb_valid, int f, void* stream) {
  if (n_segs == 1)
    return launch_gmax<1>(q, seg_base, seg_blk0, 1, gmax, l1, Q, D, blk_lo,
                          n_blk, nb_valid, f, stream);
  return launch_gmax<MAX_SEGS>(q, seg_base, seg_blk0, n_segs, gmax, l1, Q, D,
                               blk_lo, n_blk, nb_valid, f, stream);
}

// K7: gmax [Q, NB] fp32 from the block rows cb [NB, 8*D] bf16, read as the
// doc-major [NB*8, D] rows they are. Launches on `stream` and returns
// cudaGetLastError() or a failed encode's code.
extern "C" int block_gmax_launch(const void* q, const void* cb, void* gmax,
                                 int Q, int D, long long NB, void* stream) {
  const long long blk0[2] = {0, NB};
  return launch_gmax<1>(q, &cb, blk0, 1, gmax, nullptr, Q, D, 0, NB, NB, 0,
                        stream);
}
