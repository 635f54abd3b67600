// gather_rescore_pipelined: exact scores of the 8 docs of each selected
// block, with the next block's rows copied while this block's are reduced.
//
// Replaces openmatch_tpu/ops/pallas_mips.py
// `_gather_rescore_kernel_pipelined` (K6, reached through
// `pallas_gather_rescore(pipeline=True)`).
//
// What it computes is what gather_rescore.cu computes, for queries q [Q, D]
// bf16, the doc-major body [NB*8, D] bf16 and block ids bids [Q, k] int32:
//   out[q, j*8 + m] = <q[q], body[bids[q, j]*8 + m]>      (fp32)
// exactly [Q, k*8], no k padding; ids outside [0, NB) are clamped.
//
// What bounds it on an H100: memory, as K3: one contiguous 8 x D bf16 slab
// (12 KB at D = 768) per (query, selected block) and 2*8*D flops with it.
//
// What the design does about it: the TPU kernel double-buffered its DMA
// scratch so that the next grid step's copies ran under this step's dots.
// Here one CUDA block owns one query and 64 of its selected blocks and
// walks them in order through a 2-slot ring of slabs in shared memory:
// while the 8 warps reduce slab t (warp w takes row w, 16-byte shared
// loads, shuffle reduction), cp.async copies of slab t+1 are in flight.
// The query row is staged once, as bf16, with the first slab. Several
// blocks share an SM (34*D bytes of shared memory each), so their rings
// keep many slabs in flight per SM. Offsets are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GROUP = 8;
constexpr int THREADS = 256;        // 8 warps: warp w reduces row w
constexpr int BIDS_PER_BLOCK = 64;  // selected blocks per CUDA block
constexpr int VEC = 8;              // bf16 per 16-byte copy
constexpr int SLOTS = 2;            // slabs in the ring
static_assert(THREADS / 32 == GROUP, "one warp per row of a block");

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__global__ void __launch_bounds__(THREADS)
gather_rescore_pipelined_kernel(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ body,
                                const int32_t* __restrict__ bids,
                                float* __restrict__ out, int D, int k,
                                long long nb, int n_chunks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* qs = ring + static_cast<size_t>(SLOTS) * GROUP * D;  // [D]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long qi = blockIdx.x / n_chunks;
  const int j0 = static_cast<int>(blockIdx.x % n_chunks) * BIDS_PER_BLOCK;
  const int n = min(k - j0, BIDS_PER_BLOCK);
  const int slab_vecs = GROUP * D / VEC;
  const int32_t* my_bids = bids + static_cast<size_t>(qi) * k + j0;

  // start the copies of step t's slab into slot t % SLOTS
  auto start_copies = [&](int t) {
    long long b = my_bids[t];
    b = b < 0 ? 0 : (b >= nb ? nb - 1 : b);
    const __nv_bfloat16* src = body + static_cast<size_t>(b) * GROUP * D;
    __nv_bfloat16* dst = ring + static_cast<size_t>(t % SLOTS) * GROUP * D;
    for (int v = tid; v < slab_vecs; v += THREADS)
      cp_async16(dst + v * VEC, src + v * VEC);
  };

  const __nv_bfloat16* qrow = q + static_cast<size_t>(qi) * D;
  for (int v = tid; v < D / VEC; v += THREADS)
    cp_async16(qs + v * VEC, qrow + v * VEC);
  start_copies(0);
  cp_async_commit();
  for (int t = 0; t < n; ++t) {
    // slot (t+1) % SLOTS was last read at step t-1, which every warp left
    // through the barrier at the end of that step
    if (t + 1 < n) start_copies(t + 1);
    cp_async_commit();  // possibly empty: keeps one group per step
    cp_async_wait<1>();  // step t's copies (this thread's) have landed
    __syncthreads();     // ... everyone's
    const __nv_bfloat16* row =
        ring + static_cast<size_t>(t % SLOTS) * GROUP * D +
        static_cast<size_t>(warp) * D;
    float acc = 0.0f;
    for (int c = lane * VEC; c < D; c += 32 * VEC) {
      const uint4 xv = *reinterpret_cast<const uint4*>(row + c);
      const uint4 qv = *reinterpret_cast<const uint4*>(qs + c);
      const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&xv);
      const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&qv);
#pragma unroll
      for (int h = 0; h < VEC / 2; ++h) {
        const float2 a = __bfloat1622float2(x[h]);
        const float2 b = __bfloat1622float2(y[h]);
        acc = fmaf(a.x, b.x, acc);
        acc = fmaf(a.y, b.y, acc);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0)
      out[(static_cast<size_t>(qi) * k + j0 + t) * GROUP + warp] = acc;
    __syncthreads();  // slot t % SLOTS is free for step t + SLOTS
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(). D must be a multiple
// of 8 with 34*D bytes of shared memory available (D <= 6144), every
// pointer 16-byte aligned.
extern "C" int gather_rescore_pipelined_launch(const void* q, const void* body,
                                               const void* bids, void* out,
                                               int Q, int D, int k,
                                               long long nb, void* stream) {
  const int n_chunks = (k + BIDS_PER_BLOCK - 1) / BIDS_PER_BLOCK;
  const dim3 grid(static_cast<unsigned>(static_cast<long long>(Q) * n_chunks));
  const size_t smem =
      static_cast<size_t>(SLOTS * GROUP + 1) * D * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      gather_rescore_pipelined_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_rescore_pipelined_kernel<<<grid, THREADS, smem,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(body),
      static_cast<const int32_t*>(bids), static_cast<float*>(out), D, k, nb,
      n_chunks);
  return static_cast<int>(cudaGetLastError());
}
