// Forward attention with an online softmax for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention` (`_kernel`) of
// src/repro/kernels/flash_attention.py:
//   q (BH, S, D), k (BH / G, S, D), v (BH / G, S, Dv), f32 or bf16,
//   D and Dv <= 256 -> o (BH, S, Dv) in q's dtype,
// with causal, `local` (sliding window) and `chunked` (aligned chunks of
// `window` keys) masks and an optional tanh softcap on the scores.  Query
// row bh reads kv row bh / G, so MQA and GQA need no repeat of k and v.
// v may be narrower than q and k (MLA: D = 192, Dv = 128); the scale is
// 1/sqrt(D) either way.
//
// Arithmetic, as the Pallas kernel does it: q and k are read as f32 and
// their products summed in f32; s = (q.k) * (1/sqrt(D)); softcap
// s = tanh(s / c) * c; masked scores take the finite value -2.3819763e38;
// the running (m, l, acc) are f32; p = exp(s - m) is rounded to v's dtype
// before P.V, which accumulates in f32; o = acc / max(l, 1e-30) is written
// in q's dtype.
//
// What bounds it on this card.  At the serving shapes (D = 256, a local
// window of 2,048, S up to 3,000) the work is 4*D flops per unmasked
// query-key pair against 2*D bytes of q, k, v and o per query row, so the
// bytes bound is far below the operations bound: it is compute-bound.
// This first kernel does its products on the CUDA cores in f32 (67
// TFLOP/s at most), not on the tensor cores.  It now serves only the
// head dims that the tensor-core kernels do not take (D not 64, 128 or
// 256: flash_attention_wgmma.cu has bf16 there, flash_attention_tf32.cu
// f32; at D = 192, Dv = 128 it serves f32 only), and stays callable at
// every shape as their yardstick.
//
// What the design does:
//   * one block of 256 threads per (bh, tile of 64 query rows); the block
//     walks the kv tiles of 64 keys that its rows can see, staged in
//     dynamic shared memory as f32 (q and k rows padded to D + 1 floats,
//     so the score loop reads them without bank conflicts);
//   * kv tiles that the mask hides from every row of the tile (above the
//     diagonal, below the local window, outside the chunk) are skipped:
//     for a local window of 2,048 at S = 3,000 that is a third of them.
//     Every row sees at least its own key, so a skipped tile would only
//     have been wiped by alpha = 0, and the function is unchanged;
//   * each thread owns a 4 x 4 block of the 64 x 64 score tile and a
//     4 x 16 block of the 64 x Dv accumulator, in registers;
//   * a ragged last tile is masked (keys at or past S give p = 0, query
//     rows past S are not written), so any S works with one tile size.
// At D = 256 the tiles take 214 KB of shared memory, above the default 48
// KB, set per launch with cudaFuncSetAttribute.
//
// Interface: plain C, bound from Python with ctypes.  The entry point
// launches on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per kv tile
constexpr int kThreads = 256;
constexpr int kMaxD = 256;
constexpr int kDefaultSmemLimit = 48 * 1024;
constexpr float kNegInf = -2.3819763e38f;

enum Kind { kGlobal = 0, kLocal = 1, kChunked = 2 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

size_t smem_bytes(int d, int dv) {
  const size_t ds = d + 1;
  return sizeof(float) * (kBQ * ds + kBK * ds + (size_t)kBK * dv +
                          kBQ * (kBK + 1) + 2 * kBQ);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int D, int Dv,
                 int group, float scale, int causal, int kind, int window,
                 float softcap) {
  extern __shared__ float smem[];
  const int ds = D + 1;
  float* qs = smem;                    // kBQ x ds
  float* ks = qs + kBQ * ds;           // kBK x ds
  float* vs = ks + kBK * ds;           // kBK x Dv
  float* ps = vs + kBK * Dv;           // kBQ x (kBK + 1): scores, then p
  float* row_alpha = ps + kBQ * (kBK + 1);
  float* row_l = row_alpha + kBQ;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const long long plane = (long long)S * D, vplane = (long long)S * Dv;
  const T* qb = q + bh * plane;
  const T* kb = k + (bh / group) * plane;
  const T* vb = v + (bh / group) * vplane;
  T* ob = o + bh * vplane;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    qs[r * ds + c] = q0 + r < S ? to_f(qb[(long long)(q0 + r) * D + c]) : 0.0f;
  }

  // the keys any row of this tile may see: [lo, hi)
  const int q_last = min(q0 + kBQ, S) - 1;
  int lo = 0, hi = S;
  if (causal) hi = q_last + 1;
  if (kind == kLocal) {
    lo = max(0, q0 - window + 1);
  } else if (kind == kChunked) {
    lo = (q0 / window) * window;
    hi = min(hi, (q_last / window + 1) * window);
  }

  // softmax state of row tid / 4, held alike by its four threads
  float m_row = kNegInf, l_row = 0.0f;
  float acc[4][16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[i][j] = 0.0f;

  for (int k0 = (lo / kBK) * kBK; k0 < hi; k0 += kBK) {
    __syncthreads();  // the previous tile's k, v and p are no longer read
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      ks[r * ds + c] = k0 + r < S ? to_f(kb[(long long)(k0 + r) * D + c]) : 0.0f;
    }
    for (int i = tid; i < kBK * Dv; i += kThreads) {
      const int r = i / Dv, c = i % Dv;
      vs[r * Dv + c] = k0 + r < S ? to_f(vb[(long long)(k0 + r) * Dv + c]) : 0.0f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * ds + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * ds + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const int qp = q0 + r, kp = k0 + c;
        float s = sc[i][j] * scale;
        if (softcap > 0.0f) s = tanhf(s / softcap) * softcap;
        bool valid = true;
        if (causal) valid &= qp >= kp;
        if (kind == kLocal) valid &= (qp - kp) < window;
        else if (kind == kChunked) valid &= (qp / window) == (kp / window);
        if (!valid) s = kNegInf;
        if (kp >= S) s = -INFINITY;  // past the sequence: p = 0 exactly
        ps[r * (kBK + 1) + c] = s;
      }
    }
    __syncthreads();

    {  // online softmax, four threads per row
      const int r = tid / 4, part = tid % 4;
      float* prow = ps + r * (kBK + 1);
      float mx = -INFINITY;
      for (int c = part; c < kBK; c += 4) mx = fmaxf(mx, prow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_row, mx);
      const float alpha = expf(m_row - m_new);
      float sum = 0.0f;
      for (int c = part; c < kBK; c += 4) {
        const float p = expf(prow[c] - m_new);
        sum += p;
        prow[c] = to_f(from_f<T>(p));  // p.astype(v.dtype)
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_row = l_row * alpha + sum;
      m_row = m_new;
      if (part == 0) row_alpha[r] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = row_alpha[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[i][j] *= al;
    }
    for (int c = 0; c < kBK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * (kBK + 1) + c];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int d = tx + 16 * j;
        if (d < Dv) {
          const float vv = vs[c * Dv + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

  if (tid % 4 == 0) row_l[tid / 4] = l_row;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= S) continue;
    const float l = fmaxf(row_l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int d = tx + 16 * j;
      if (d < Dv) ob[(long long)(q0 + r) * Dv + d] = from_f<T>(acc[i][j] / l);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int bh, int s,
                   int d, int dv, int group, int causal, int kind, int window,
                   float softcap, cudaStream_t stream) {
  const size_t smem = smem_bytes(d, dv);
  if (smem > (size_t)kDefaultSmemLimit) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const float scale = (float)(1.0 / sqrt((double)d));
  const dim3 grid((s + kBQ - 1) / kBQ, bh);
  flash_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), s, d, dv, group, scale, causal, kind, window, softcap);
  return cudaGetLastError();
}

}  // namespace

// q: (bh, s, d); k: (bh / group, s, d); v: (bh / group, s, dv); o: (bh,
// s, dv); all f32 (is_bf16 = 0) or all bf16 (is_bf16 = 1), contiguous,
// on the current device.  kind: 0 global, 1 local, 2 chunked.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int bh, int s, int d, int dv, int group, int is_bf16,
                                   int causal, int kind, int window, double softcap,
                                   void* stream) {
  if (bh <= 0 || s <= 0) return (int)cudaSuccess;
  if (d <= 0 || d > kMaxD || dv <= 0 || dv > kMaxD || group <= 0 || bh % group)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(q, k, v, o, bh, s, d, dv, group, causal, kind,
                                      window, (float)softcap, st)
              : launch<float>(q, k, v, o, bh, s, d, dv, group, causal, kind, window,
                              (float)softcap, st);
  return (int)err;
}
