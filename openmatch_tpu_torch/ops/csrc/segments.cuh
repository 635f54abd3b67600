// The segment table: a doc-major corpus held as several separate device
// allocations ("segments"), addressed by GLOBAL 8-doc block ids.
//
// Segment s holds global blocks [blk0[s], blk0[s + 1]) starting at base[s].
// The table is passed to a kernel BY VALUE as a __grid_constant__
// parameter (about 1 KB of the 4 KB parameter space): no device-side table,
// no host-to-device copy per call, and every thread reads it from the
// constant bank. The single-buffer corpus is the one-segment table.
//
// Replaces the TPU's per-segment `pallas_call`s with aliased, windowed
// outputs (openmatch_tpu/ops/pallas_mips.py `fused_plain_gmax_segs`) and
// its binary tree of scalar `pl.when` guards per copy
// (`_make_gather_rescore_seg_kernel`): a CUDA thread resolves a block's
// segment with a few integer compares.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

constexpr int MAX_SEGS = 64;

struct SegTable {
  const __nv_bfloat16* base[MAX_SEGS];
  long long blk0[MAX_SEGS + 1];  // blk0[n] = total blocks
  int n;
};

// the segment holding global block b (0 <= b < blk0[n]): the last s with
// blk0[s] <= b, in any table with the fields blk0 and n (SegTable here,
// plain_gmax.cu's table of tensor maps)
template <class Table>
__device__ __forceinline__ int seg_of(const Table& t, long long b) {
  int lo = 0, hi = t.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.blk0[mid] <= b)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// Fills `t` from host arrays; false when n is outside [1, MAX_SEGS] or the
// cuts do not ascend.
inline bool make_seg_table(SegTable* t, const void* const* base,
                           const long long* blk0, int n) {
  if (n < 1 || n > MAX_SEGS) return false;
  t->n = n;
  for (int s = 0; s < n; ++s) {
    t->base[s] = static_cast<const __nv_bfloat16*>(base[s]);
    t->blk0[s] = blk0[s];
    if (blk0[s + 1] < blk0[s]) return false;
  }
  t->blk0[n] = blk0[n];
  return true;
}
