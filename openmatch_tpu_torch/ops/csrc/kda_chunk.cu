// kda_chunk: K13, the chunked forward of Kimi Delta Attention (KDA) over a
// packed stream of documents, each with its short causal convolution.
//
// Replaces no TPU kernel: the JAX package has no linear attention. It was
// added for the Kimi-Linear backbone (models/kimi_linear.py), whose KDA
// layers are 20 of its 27 token mixers. What it computes (ops/kda.py's
// docstring has the algebra of the chunked form), per head h and token t of
// a document, with q, k and v SiLU(causal_conv(W x)) (zero history at the
// document's first token), q and k L2-normalised and q scaled by D^-1/2:
//   S_t = (I - beta_t k_t k_t^T) Diag(exp(g_t)) S_{t-1} + beta_t k_t v_t^T
//   o_t = S_t^T q_t
// with the state S [D, D] zero at each document's start. Inputs: qkv
// [T, 3 x H x D] bf16 (rows strided by qkv_stride), conv_w [3 x H x D, 4]
// bf16, g [T, H x D] fp32 (the log decay, <= 0), beta [T, H] fp32, cu
// [B + 1] int64 (the documents' first slots and the end of the last) and cc
// [B + 1] int64 (the documents' first chunks). Output: out [T, H, D] bf16,
// written at the documents' slots only.
//
// What bounds it on an H100: its bytes, in the least time. q, k, v, g and
// beta in and o out are 0.27 ms a layer at 18,100 tokens (48 documents),
// against 0.06 ms of the state's products on the tensor cores. The
// recurrence runs in order over a document's chunks, and the products are
// kept in fp32, so in practice the fp32 cores (about 1 ms of multiply-adds
// a layer there) and the latency of a document's chain of chunks bound it.
//
// What the design does about it: two kernels.
// - kda_chunk_prep_kernel, one block a chunk and head, all at once: what
//   the chunk computes without the state (the convolution, SiLU, the norms,
//   the chunk's cumulative decay G, A and P, (I + beta A)^-1 by forward
//   substitution), handed on in fp32 scratch of the stream's shape: q e^G,
//   k e^(G_C - G), (I + beta A)^-1 beta k e^G, (I + beta A)^-1 beta v, P and
//   e^(G_C). Its cross-thread sums (the norms, A and P) run where thousands
//   of blocks hide their latency, off the state's chain: A and P a thread a
//   pair of tokens, G in log2 units so each factor is one ex2.
// - kda_chunk_kernel, one block a document and head, a warp 16 of the
//   head's value columns: the state [D, D] in registers, the document's
//   chunks in order, each chunk's scratch loaded by cp.async into one half
//   of a double buffer while the other half is computed. A chunk is three
//   products with the state (U = U0 - Wk S, o = Qg S + P U, S = e^(G_C) S +
//   Kd^T U); each lane holds two columns of the state, so each float4 read
//   of the chunk feeds 8 multiply-adds, and a warp's sums stay inside it
//   (shuffles), so a chunk takes one barrier.
// Every product and sum is fp32 on the CUDA cores, in a fixed order: no
// TF32, and the same bits run to run (a CUDA graph equals eager). The fp32
// scratch moves about four times the bound's bytes; keeping it is the price
// of fp32 between the two kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int C = 16;  // tokens a chunk: ops/kda.py's CHUNK
constexpr int TAPS = 4;  // the convolution's width
constexpr int PREP_THREADS = 128;
constexpr int WARPS = PREP_THREADS / 32;
constexpr float LOG2E = 1.4426950408889634f;  // G is kept in log2 units

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// 2^x in one instruction (relative error about 2^-22; flushes to 0 below
// 2^-126)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float silu(float x) {
  return __fdividef(x, 1.f + ex2(-LOG2E * x));
}

// The document of chunk p: cc[b] <= p < cc[b + 1], with cc[0] = 0 <= p
// < cc[n_docs]; empty documents (cc[b] == cc[b + 1]) are passed over.
__device__ __forceinline__ int doc_of(const long long* cc, int n_docs,
                                      long long p) {
  int lo = 0, hi = n_docs;
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (cc[mid] <= p) lo = mid; else hi = mid;
  }
  return lo;
}

template <int D>
__global__ void __launch_bounds__(PREP_THREADS, 4) kda_chunk_prep_kernel(
    const __nv_bfloat16* __restrict__ qkv, long long qkv_stride,
    const __nv_bfloat16* __restrict__ conv_w, const float* __restrict__ g,
    const float* __restrict__ beta, const long long* __restrict__ cu,
    const long long* __restrict__ cc, int n_docs, int H, float scale,
    float eps, float* __restrict__ qg, float* __restrict__ kd,
    float* __restrict__ wk, float* __restrict__ u0, float* __restrict__ pm,
    float* __restrict__ decay) {
  __shared__ __align__(16) float q_s[C][D], k_s[C][D], v_s[C][D], G_s[C][D];
  __shared__ float A_s[C][C], P_s[C][C], b_s[C];
  __shared__ __align__(16) float T_s[C][C];
  const long long p = blockIdx.x;
  const int h = blockIdx.y;
  if (p >= cc[n_docs]) return;
  const int b = doc_of(cc, n_docs, p);
  const long long start = cu[b], length = cu[b + 1] - start;
  const long long c0 = (p - cc[b]) * C;  // the chunk's first position
  const int n = static_cast<int>(min(static_cast<long long>(C), length - c0));
  const long long t0 = start + c0, HD = static_cast<long long>(H) * D;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // a thread a channel: G, then SiLU of the convolution of q, k and v, each
  // tap's source inside the document; rows past the document are zero. The
  // loads' rows are clamped into the document and the values masked after,
  // so each batch of loads is issued at once.
  for (int c = tid; c < D; c += PREP_THREADS) {
    float gv[C];
#pragma unroll
    for (int r = 0; r < C; ++r)
      gv[r] = g[(t0 + min(r, n - 1)) * HD + h * D + c];
    float run = 0.f;
#pragma unroll
    for (int r = 0; r < C; ++r) {
      if (r < n) run += gv[r];
      G_s[r][c] = run * LOG2E;
    }
#pragma unroll 1
    for (int part = 0; part < 3; ++part) {
      const long long col = part * HD + h * D + c;
      float w[TAPS];  // w[i] weighs the input i tokens back
#pragma unroll
      for (int i = 0; i < TAPS; ++i)
        w[i] = __bfloat162float(conv_w[col * TAPS + TAPS - 1 - i]);
      float x_in[C + TAPS - 1];  // the inputs at positions c0 - 3 .. c0 + 15
#pragma unroll
      for (int r = 0; r < C + TAPS - 1; ++r) {
        const long long pos = c0 + r - (TAPS - 1);
        const long long at = start + min(max(pos, 0ll), length - 1);
        const float x = __bfloat162float(qkv[at * qkv_stride + col]);
        x_in[r] = pos >= 0 && pos < length ? x : 0.f;
      }
      float(*dst)[D] = part == 0 ? q_s : part == 1 ? k_s : v_s;
#pragma unroll
      for (int r = 0; r < C; ++r) {
        float x = 0.f;
#pragma unroll
        for (int i = 0; i < TAPS; ++i) x += x_in[r + TAPS - 1 - i] * w[i];
        dst[r][c] = r < n ? silu(x) : 0.f;
      }
    }
  }
  if (tid < C) b_s[tid] = tid < n ? beta[(t0 + tid) * H + h] : 0.f;
  __syncthreads();

  // a warp a row: the L2 norms of q (times scale) and k
  for (int r = warp; r < C; r += WARPS) {
    float sq = 0.f, sk = 0.f;
    for (int c = lane; c < D; c += 32) {
      sq += q_s[r][c] * q_s[r][c];
      sk += k_s[r][c] * k_s[r][c];
    }
    const float fq = rsqrtf(warp_sum(sq) + eps) * scale;
    const float fk = rsqrtf(warp_sum(sk) + eps);
    for (int c = lane; c < D; c += 32) {
      q_s[r][c] *= fq;
      k_s[r][c] *= fk;
    }
  }
  __syncthreads();

  // a thread a pair s < t (120 of them): A[t][s] and P[t][s], each a sum
  // over the channels of k_s e^(G_t - G_s) (every exponent <= 0) times k_t
  // and q_t, four channels a load; the lanes start 4 x lane channels apart,
  // so each quarter of a warp reads 128 contiguous bytes of its rows. The
  // last 8 threads take P's diagonal, q_t k_t.
  constexpr int PAIRS = C * (C - 1) / 2;
  static_assert(PAIRS + C / 2 <= PREP_THREADS, "a pair a thread");
  for (int i = tid; i < C * C; i += PREP_THREADS)
    A_s[i / C][i % C] = P_s[i / C][i % C] = 0.f;
  __syncthreads();
  if (tid < PAIRS) {
    int t = 1;
    while (t * (t + 1) / 2 <= tid) ++t;
    const int s = tid - t * (t - 1) / 2;
    float a = 0.f, pp = 0.f;
    for (int i = 0; i < D / 4; ++i) {
      const int c = ((i + lane) * 4) & (D - 1);
      const float4 gt = *reinterpret_cast<const float4*>(&G_s[t][c]);
      const float4 gs = *reinterpret_cast<const float4*>(&G_s[s][c]);
      const float4 ks = *reinterpret_cast<const float4*>(&k_s[s][c]);
      const float4 kt = *reinterpret_cast<const float4*>(&k_s[t][c]);
      const float4 qt = *reinterpret_cast<const float4*>(&q_s[t][c]);
      const float e0 = ex2(gt.x - gs.x) * ks.x, e1 = ex2(gt.y - gs.y) * ks.y,
                  e2 = ex2(gt.z - gs.z) * ks.z, e3 = ex2(gt.w - gs.w) * ks.w;
      a += kt.x * e0 + kt.y * e1 + kt.z * e2 + kt.w * e3;
      pp += qt.x * e0 + qt.y * e1 + qt.z * e2 + qt.w * e3;
    }
    A_s[t][s] = a;
    P_s[t][s] = pp;
  } else if (tid < PAIRS + C / 2) {
    for (int t = tid - PAIRS; t < C; t += C / 2) {
      float pp = 0.f;
      for (int i = 0; i < D / 4; ++i) {
        const int c = ((i + lane) * 4) & (D - 1);
        const float4 kt = *reinterpret_cast<const float4*>(&k_s[t][c]);
        const float4 qt = *reinterpret_cast<const float4*>(&q_s[t][c]);
        pp += qt.x * kt.x + qt.y * kt.y + qt.z * kt.z + qt.w * kt.w;
      }
      P_s[t][t] = pp;
    }
  }
  __syncthreads();

  // a lane a column j: (I + Diag(beta) A)^-1 by forward substitution, the
  // column in registers (its entries above row j stay 0), then times
  // Diag(beta) on the right
  if (tid < C) {
    const int j = tid;
    float col[C];
#pragma unroll
    for (int i = 0; i < C; ++i) {
      float x = i == j ? 1.f : 0.f;
      const float bi = b_s[i];
#pragma unroll
      for (int m = 0; m < i; ++m) x -= bi * A_s[i][m] * col[m];
      col[i] = x;
    }
#pragma unroll
    for (int i = 0; i < C; ++i) T_s[i][j] = col[i] * b_s[j];
  }
  __syncthreads();

  // a thread a channel: what the state pass reads, at the chunk's rows
  // (T is lower triangular, its zeros stored)
  for (int c = tid; c < D; c += PREP_THREADS) {
    const float last = G_s[C - 1][c];  // rows past the document add 0
    float kg[C], vv[C];
#pragma unroll
    for (int r = 0; r < C; ++r) {
      const float eG = ex2(G_s[r][c]);
      kg[r] = k_s[r][c] * eG;
      vv[r] = v_s[r][c];
      if (r < n) {
        const long long at = ((t0 + r) * H + h) * D + c;
        qg[at] = q_s[r][c] * eG;
        kd[at] = k_s[r][c] * ex2(last - G_s[r][c]);
      }
    }
#pragma unroll 1
    for (int r = 0; r < n; ++r) {
      float w = 0.f, u = 0.f;
#pragma unroll
      for (int j = 0; j < C; j += 4) {
        const float4 tr = *reinterpret_cast<const float4*>(&T_s[r][j]);
        w += tr.x * kg[j] + tr.y * kg[j + 1] + tr.z * kg[j + 2] +
             tr.w * kg[j + 3];
        u += tr.x * vv[j] + tr.y * vv[j + 1] + tr.z * vv[j + 2] +
             tr.w * vv[j + 3];
      }
      const long long at = ((t0 + r) * H + h) * D + c;
      wk[at] = w;
      u0[at] = u;
    }
    decay[(p * H + h) * D + c] = ex2(last);
  }
  for (int i = tid; i < n * C; i += PREP_THREADS)
    pm[((t0 + i / C) * H + h) * C + i % C] = P_s[i / C][i % C];
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = pred ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes));
}

// One half of the state pass's double buffer: a chunk's scratch (P's rows
// padded to C + 4, so the four quarters of a warp read them in distinct
// banks).
template <int D>
struct Stage {
  float qg[C][D], wk[C][D], kd[C][D], u0[C][D], pm[C][C + 4], eL[D];
};

// Issue the cp.async loads of the chunk of n rows at slot t0 (rows at or
// past n zero-filled); `chunk` is its index in the decay's rows.
template <int D>
__device__ __forceinline__ void load_stage(
    Stage<D>& st, const float* qg, const float* wk, const float* kd,
    const float* u0, const float* pm, const float* decay, long long t0,
    int n, long long chunk, int H, int h, int tid, int NT) {
  constexpr int RQ = D / 4, RP = C / 4;
  for (int i = tid; i < C * RQ; i += NT) {
    const int r = i / RQ, c = (i % RQ) * 4;
    const bool ok = r < n;
    const long long at = ((t0 + (ok ? r : 0)) * H + h) * D + c;
    cp_async16(&st.qg[r][c], qg + at, ok);
    cp_async16(&st.wk[r][c], wk + at, ok);
    cp_async16(&st.kd[r][c], kd + at, ok);
    cp_async16(&st.u0[r][c], u0 + at, ok);
  }
  for (int i = tid; i < C * RP; i += NT) {
    const int r = i / RP, c = (i % RP) * 4;
    const bool ok = r < n;
    cp_async16(&st.pm[r][c], pm + ((t0 + (ok ? r : 0)) * H + h) * C + c,
               ok);
  }
  for (int i = tid; i < RQ; i += NT)
    cp_async16(&st.eL[i * 4], decay + (chunk * H + h) * D + i * 4, true);
  asm volatile("cp.async.commit_group;\n" ::);
}

// The state pass: a block a document and head, a warp 16 of its value
// columns (D / 16 warps).
template <int D>
struct StateSmem {
  static constexpr int WS = D / 16;
  Stage<D> stage[2];
  float2 U[WS][C][8];  // each warp's U: [t][cl] holds columns cl and cl + 8
};

// Lane (q, cl) of a warp holds the state at its columns j = 16 w + cl and
// j + 8, rows 16 m + 4 q .. 16 m + 4 q + 3 for every m: each float4 read of
// a chunk's row feeds 8 multiply-adds. A product with the state sums each
// lane's rows for 8 of the chunk's tokens at a time, then the four
// quarters' sums by two shuffles, which leave lane (q, cl) the tokens
// 8 half + 2 q and 8 half + 2 q + 1: no sum crosses a warp, so a chunk
// takes one barrier, for its loads.
template <int D>
__global__ void __launch_bounds__(32 * (D / 16), 2)
    kda_chunk_kernel(const float* __restrict__ qg,
                     const float* __restrict__ kd,
                     const float* __restrict__ wk,
                     const float* __restrict__ u0,
                     const float* __restrict__ pm,
                     const float* __restrict__ decay,
                     const long long* __restrict__ cu,
                     const long long* __restrict__ cc, int H,
                     __nv_bfloat16* __restrict__ out) {
  using Smem = StateSmem<D>;
  constexpr int NT = 32 * Smem::WS, M = D / 16;
  extern __shared__ float4 smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int h = blockIdx.y, b = blockIdx.z;
  const long long start = cu[b], length = cu[b + 1] - start;
  const long long first = cc[b];
  const int chunks = static_cast<int>((length + C - 1) / C);
  if (chunks <= 0) return;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int cl = lane % 8, q = lane / 8, j = warp * 16 + cl;
  const bool hi = q >= 2, lo = q & 1;
  float S[M][4][2];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) S[m][e][0] = S[m][e][1] = 0.f;
  load_stage<D>(sm.stage[0], qg, wk, kd, u0, pm, decay, start,
                static_cast<int>(min(static_cast<long long>(C), length)),
                first, H, h, tid, NT);
  for (int ci = 0; ci < chunks; ++ci) {
    const long long t0 = start + static_cast<long long>(ci) * C;
    const int n = static_cast<int>(min(static_cast<long long>(C),
                                       start + length - t0));
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();  // this chunk is in; the other half is free
    if (ci + 1 < chunks)
      load_stage<D>(sm.stage[(ci + 1) & 1], qg, wk, kd, u0, pm, decay,
                    t0 + C,
                    static_cast<int>(min(static_cast<long long>(C),
                                         start + length - t0 - C)),
                    first + ci + 1, H, h, tid, NT);
    const Stage<D>& st = sm.stage[ci & 1];
    // red[which][half][i][c]: (Wk S, Qg S) at token 8 half + 2 q + i and
    // column c of the lane's two
    float red[2][2][2][2];
#pragma unroll
    for (int which = 0; which < 2; ++which) {
      const float(*A)[D] = which == 0 ? st.wk : st.qg;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float part[8][2];
#pragma unroll
        for (int t = 0; t < 8; ++t) part[t][0] = part[t][1] = 0.f;
#pragma unroll
        for (int m = 0; m < M; ++m)
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            const float4 a = *reinterpret_cast<const float4*>(
                &A[8 * half + t][16 * m + 4 * q]);
#pragma unroll
            for (int c = 0; c < 2; ++c)
              part[t][c] += a.x * S[m][0][c] + a.y * S[m][1][c] +
                            a.z * S[m][2][c] + a.w * S[m][3][c];
          }
        float r1[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float send = hi ? part[i][c] : part[i + 4][c];
            const float keep = hi ? part[i + 4][c] : part[i][c];
            r1[i][c] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
          }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float send = lo ? r1[i][c] : r1[i + 2][c];
            const float keep = lo ? r1[i + 2][c] : r1[i][c];
            red[which][half][i][c] =
                keep + __shfl_xor_sync(0xffffffffu, send, 8);
          }
      }
      if (which == 0) {
        // U = U0 - Wk S at the lane's tokens, shared with the warp
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int t = 8 * half + 2 * q + i;
            sm.U[warp][t][cl] =
                make_float2(st.u0[t][j] - red[0][half][i][0],
                            st.u0[t][j + 8] - red[0][half][i][1]);
          }
      }
    }
    __syncwarp();
    // o = Qg S + P U at the lane's tokens
#pragma unroll
    for (int s = 0; s < C; ++s) {
      const float2 u = sm.U[warp][s][cl];
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float p = st.pm[8 * half + 2 * q + i][s];
          red[1][half][i][0] += p * u.x;
          red[1][half][i][1] += p * u.y;
        }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int t = 8 * half + 2 * q + i;
        if (t < n) {
          __nv_bfloat16* row = out + ((t0 + t) * H + h) * D;
          row[j] = __float2bfloat16(red[1][half][i][0]);
          row[j + 8] = __float2bfloat16(red[1][half][i][1]);
        }
      }
    // S = Diag(e^(G_C)) S + Kd^T U, eight tokens at a time
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const float4 e =
          *reinterpret_cast<const float4*>(&st.eL[16 * m + 4 * q]);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        S[m][0][c] *= e.x;
        S[m][1][c] *= e.y;
        S[m][2][c] *= e.z;
        S[m][3][c] *= e.w;
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float2 u[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) u[t] = sm.U[warp][8 * half + t][cl];
#pragma unroll
      for (int m = 0; m < M; ++m)
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const float4 d = *reinterpret_cast<const float4*>(
              &st.kd[8 * half + t][16 * m + 4 * q]);
          S[m][0][0] += d.x * u[t].x;
          S[m][1][0] += d.y * u[t].x;
          S[m][2][0] += d.z * u[t].x;
          S[m][3][0] += d.w * u[t].x;
          S[m][0][1] += d.x * u[t].y;
          S[m][1][1] += d.y * u[t].y;
          S[m][2][1] += d.z * u[t].y;
          S[m][3][1] += d.w * u[t].y;
        }
    }
  }
}

template <int D>
int run(const void* qkv, long long qkv_stride, const void* conv_w,
        const void* g, const void* beta, const void* cu, const void* cc,
        int n_docs, long long n_chunks, int heads, float scale, float eps,
        void* qg, void* kd, void* wk, void* u0, void* pm, void* decay,
        void* out, cudaStream_t stream) {
  kda_chunk_prep_kernel<D><<<dim3(static_cast<unsigned>(n_chunks), heads),
                             PREP_THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), qkv_stride,
      static_cast<const __nv_bfloat16*>(conv_w),
      static_cast<const float*>(g), static_cast<const float*>(beta),
      static_cast<const long long*>(cu), static_cast<const long long*>(cc),
      n_docs, heads, scale, eps, static_cast<float*>(qg),
      static_cast<float*>(kd), static_cast<float*>(wk),
      static_cast<float*>(u0), static_cast<float*>(pm),
      static_cast<float*>(decay));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  using Smem = StateSmem<D>;
  const auto kernel = kda_chunk_kernel<D>;
  const int bytes = static_cast<int>(sizeof(Smem));
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(1, heads, n_docs), 32 * Smem::WS, bytes, stream>>>(
      static_cast<const float*>(qg), static_cast<const float*>(kd),
      static_cast<const float*>(wk), static_cast<const float*>(u0),
      static_cast<const float*>(pm), static_cast<const float*>(decay),
      static_cast<const long long*>(cu), static_cast<const long long*>(cc),
      heads, static_cast<__nv_bfloat16*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches both kernels on `stream` and returns cudaGetLastError(). qkv
// [T, 3 x heads x head_dim] bf16 with rows qkv_stride elements apart,
// conv_w [3 x heads x head_dim, 4] bf16, g [T, heads x head_dim] and beta
// [T, heads] fp32, cu and cc [n_docs + 1] int64 on the card (cc the
// prefix sum of each document's ceil(length / 16) chunks), n_chunks at
// least cc[n_docs]; scratch qg, kd, wk, u0 [T, heads, head_dim], pm [T,
// heads, 16] and decay [n_chunks, heads, head_dim] fp32; out [T, heads,
// head_dim] bf16. head_dim is 128 (Kimi-Linear's) or 16 (the tests' tiny
// model); the convolution's width 4.
extern "C" int kda_chunk_launch(const void* qkv, long long qkv_stride,
                                const void* conv_w, const void* g,
                                const void* beta, const void* cu,
                                const void* cc, int n_docs,
                                long long n_chunks, int heads, int head_dim,
                                int taps, float scale, float eps, void* qg,
                                void* kd, void* wk, void* u0, void* pm,
                                void* decay, void* out, void* stream) {
  if (n_docs < 1 || n_chunks < 1 || heads < 1 || taps != TAPS ||
      n_chunks >= (1ll << 31) || n_docs > 65535 || heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
#define KDA_RUN(d)                                                          \
  run<d>(qkv, qkv_stride, conv_w, g, beta, cu, cc, n_docs, n_chunks, heads, \
         scale, eps, qg, kd, wk, u0, pm, decay, out, s)
  switch (head_dim) {
    case 16: return KDA_RUN(16);
    case 128: return KDA_RUN(128);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef KDA_RUN
}
