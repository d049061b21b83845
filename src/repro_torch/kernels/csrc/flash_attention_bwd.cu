// Attention backward for Hopper (sm_90a): the gradient of the forward of
// flash_attention_{wgmma,tf32,}.cu.
//
// The Pallas TPU kernel `flash_attention` (src/repro/kernels/
// flash_attention.py:77) has no backward: the reference trains through
// `blockwise_attention` (src/repro/models/attention.py:118), which XLA
// differentiates.  The port's train step runs the hand-written forward,
// so its gradient is this kernel:
//   q (BH, S, D), k (BH / G, S, D), v (BH / G, S, Dv), o, dO (BH, S, Dv),
//   f32 or bf16, D and Dv <= 256
//   -> dq (BH, S, D), dk (BH / G, S, D), dv (BH / G, S, Dv) in the
//   inputs' dtype,
// with the forward's masks (causal, `local` within `window`, `chunked`)
// and its tanh softcap.  Query row bh reads kv row bh / G.  v may be
// narrower than q and k (MLA: D 192, Dv 128), as in the CUDA-core
// forward; the scale is 1/sqrt(D).
//
// Arithmetic (FA2's backward, all in f32): with s the scaled, softcapped
// (t = tanh(s / c), s = t c) and masked scores, lse the row's
// log-sum-exp, p = exp(s - lse) and D_i = rowsum(dO * O),
//   dv_j = sum_i p_ij dO_i          dp_ij = dO_i . v_j
//   ds_ij = p_ij (dp_ij - D_i) (1 - t_ij^2 with a softcap)
//   dq_i = sum_j ds_ij k_j / sqrt(D)   dk_j = sum_i ds_ij q_i / sqrt(D)
// Masked pairs, keys past S and query rows past S give p = 0 and ds = 0.
//
// What bounds it on this card: operations.  The least work is five
// products per kept pair (s, dq, dk of 2*D flops, dp, dv of 2*Dv: 6*D +
// 4*Dv, 10*D when Dv = D), against
// q, k, v, o, dO read and dq, dk, dv written once; at the serving shapes
// (D = 256, local window 2,048) that is far above the bytes.  This first
// design runs on the CUDA cores in f32 and recomputes s twice more (the
// row statistics and the dQ pass: 18*D flops a pair), so it is slow
// beside the tensor cores' bound; it is simple, deterministic and exact
// in its order of summation.
//
// Three launches, one stream, no atomics (two runs give bitwise the same
// gradients):
//   1. stats: one block per (bh, tile of 32 query rows) walks the key
//      tiles its rows see, recomputes the scores and writes each row's
//      lse (the online max and sum of the forward, in f32) and D_i;
//   2. dQ: one block per (bh, tile of 32 query rows) walks the same key
//      tiles, recomputes p and dp, and sums ds k into dq in registers;
//   3. dK/dV: one block per (kv row, tile of 32 keys) walks the G query
//      heads of its group and, for each, the query tiles that can see
//      its keys, summing p^T dO and ds^T q into dv and dk in registers.
// Tiles that the mask hides from every pair are skipped, as the forward
// skips them (for a local window of 2,048 at S = 3,000, a third).  Every
// row sees its own key under these masks, so no row is wholly masked.
// Tiles are staged in shared memory as f32 rows padded to D + 1 (q, k)
// or Dv + 1 (v, o, dO) floats (the dot products read a row a lane without
// bank conflicts); 256 threads, warp w owning rows w, w + 8, w + 16, w + 24
// of a 32 x 32 score tile, lane l its column l, and 4 x (D / 32) of each
// 32 x D accumulator (4 x (Dv / 32) of dv's).
// At D = 256 the dK/dV block takes 137 KB of shared memory, opted in per
// call with cudaFuncSetAttribute.
//
// Interface: plain C, bound from Python with ctypes.  The entry point
// launches on the caller's stream, allocates nothing (the caller passes
// the (BH, S) f32 lse and D_i scratch), does not synchronise, and returns
// cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kB = 32;         // query rows and keys per tile
constexpr int kThreads = 256;  // eight warps
constexpr int kRows = 4;       // score rows a thread owns (kB / 8)
constexpr int kMaxD = 256;
constexpr int kCols = kMaxD / 32;  // accumulator columns a thread owns
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

struct Mask {
  int S, causal, kind, window;
  float scale, softcap;

  __device__ __forceinline__ bool visible(int qp, int kp) const {
    bool v = qp < S && kp < S;
    if (causal) v &= qp >= kp;
    if (kind == kLocal) v &= (qp - kp) < window;
    else if (kind == kChunked) v &= (qp / window) == (kp / window);
    return v;
  }

  // the keys any query row of [q0, q0 + kB) may see: [lo, hi)
  __device__ __forceinline__ void key_range(int q0, int& lo, int& hi) const {
    const int q_last = min(q0 + kB, S) - 1;
    lo = 0;
    hi = S;
    if (causal) hi = q_last + 1;
    if (kind == kLocal) {
      lo = max(0, q0 - window + 1);
    } else if (kind == kChunked) {
      lo = (q0 / window) * window;
      hi = min(hi, (q_last / window + 1) * window);
    }
  }

  // the query rows that may see any key of [k0, k0 + kB): [lo, hi)
  __device__ __forceinline__ void query_range(int k0, int& lo, int& hi) const {
    const int k_last = min(k0 + kB, S) - 1;
    lo = 0;
    hi = S;
    if (causal) lo = k0;
    if (kind == kLocal) {
      hi = min(S, k_last + window);
    } else if (kind == kChunked) {
      lo = max(lo, (k0 / window) * window);
      hi = min(hi, (k_last / window + 1) * window);
    }
  }

  // the scaled, softcapped score of a dot product; t is tanh(s / c)
  __device__ __forceinline__ float score(float dot, float& t) const {
    float s = dot * scale;
    t = 0.0f;
    if (softcap > 0.0f) {
      t = tanhf(s / softcap);
      s = t * softcap;
    }
    return s;
  }
};

// rows [r0, r0 + kB) of a (S, D) plane into shared memory as f32, stride
// D + 1; rows past S read as zeros
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src, int r0, int S, int D) {
  const int ds = D + 1;
  for (int i = threadIdx.x; i < kB * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dst[r * ds + c] = r0 + r < S ? to_f(src[(long long)(r0 + r) * D + c]) : 0.0f;
  }
}

size_t tile_bytes(int d) { return sizeof(float) * (size_t)kB * (d + 1); }

// ---------------------------------------------------------------------------
// 1. row statistics: lse and D_i = rowsum(dO * O)
// ---------------------------------------------------------------------------

size_t stats_smem(int d) { return 2 * tile_bytes(d); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_stats_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ o, const T* __restrict__ dout,
                      float* __restrict__ lse, float* __restrict__ delta, int D, int Dv,
                      int group, Mask mask) {
  extern __shared__ float smem[];
  const int S = mask.S, ds = D + 1;
  float* qs = smem;          // kB x ds
  float* ks = qs + kB * ds;  // kB x ds
  const int bh = blockIdx.y, q0 = blockIdx.x * kB;
  const long long plane = (long long)S * D, vplane = (long long)S * Dv;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;

  // D_i, a warp per row: lanes stride over v's head dim
  const T* ob = o + bh * vplane;
  const T* dob = dout + bh * vplane;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = q0 + w + 8 * i;
    if (r >= S) continue;
    float acc = 0.0f;
    for (int c = lane; c < Dv; c += 32)
      acc = fmaf(to_f(dob[(long long)r * Dv + c]), to_f(ob[(long long)r * Dv + c]), acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) delta[(long long)bh * S + r] = acc;
  }

  stage(qs, q + bh * plane, q0, S, D);
  const T* kb = k + (bh / group) * plane;
  int lo, hi;
  mask.key_range(q0, lo, hi);
  float m_row[kRows], l_row[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m_row[i] = -INFINITY;
    l_row[i] = 0.0f;
  }
  for (int k0 = (lo / kB) * kB; k0 < hi; k0 += kB) {
    __syncthreads();  // the previous tile is no longer read
    stage(ks, kb, k0, S, D);
    __syncthreads();
    float dot[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) dot[i] = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float kv = ks[lane * ds + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i) dot[i] = fmaf(qs[(w + 8 * i) * ds + d], kv, dot[i]);
    }
    const int kp = k0 + lane;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qp = q0 + w + 8 * i;
      float t;
      float s = mask.score(dot[i], t);
      if (!mask.visible(qp, kp)) s = kNegInf;
      // keys past the sequence take no part; every tile has a key inside
      float mx = kp < S ? s : -INFINITY;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_row[i], mx);
      float e = kp < S ? expf(s - m_new) : 0.0f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) e += __shfl_xor_sync(0xffffffffu, e, off);
      l_row[i] = l_row[i] * expf(m_row[i] - m_new) + e;
      m_row[i] = m_new;
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qp = q0 + w + 8 * i;
      if (qp < S) lse[(long long)bh * S + qp] = m_row[i] + logf(l_row[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// 2. dQ: one block per (bh, query tile)
// ---------------------------------------------------------------------------

size_t dq_smem(int d, int dv) {
  return 2 * tile_bytes(d) + 2 * tile_bytes(dv) + sizeof(float) * (kB * (kB + 1) + 2 * kB);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ dout, const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dq, int D, int Dv,
                   int group, Mask mask) {
  extern __shared__ float smem[];
  const int S = mask.S, ds = D + 1, dvs = Dv + 1;
  float* qs = smem;                 // kB x ds
  float* ks = qs + kB * ds;         // kB x ds
  float* dos = ks + kB * ds;        // kB x dvs
  float* vs = dos + kB * dvs;       // kB x dvs
  float* dss = vs + kB * dvs;       // kB x (kB + 1): ds of row r, key j
  float* lse_s = dss + kB * (kB + 1);
  float* delta_s = lse_s + kB;
  const int bh = blockIdx.y, q0 = blockIdx.x * kB;
  const long long plane = (long long)S * D, vplane = (long long)S * Dv;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  stage(qs, q + bh * plane, q0, S, D);
  stage(dos, dout + bh * vplane, q0, S, Dv);
  if (threadIdx.x < kB) {
    const int r = q0 + threadIdx.x;
    lse_s[threadIdx.x] = r < S ? lse[(long long)bh * S + r] : 0.0f;
    delta_s[threadIdx.x] = r < S ? delta[(long long)bh * S + r] : 0.0f;
  }
  const T* kb = k + (bh / group) * plane;
  const T* vb = v + (bh / group) * vplane;
  float acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.0f;

  int lo, hi;
  mask.key_range(q0, lo, hi);
  for (int k0 = (lo / kB) * kB; k0 < hi; k0 += kB) {
    __syncthreads();  // the previous tile's k, v and ds are no longer read
    stage(ks, kb, k0, S, D);
    stage(vs, vb, k0, S, Dv);
    __syncthreads();
    float sdot[kRows], pdot[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) sdot[i] = pdot[i] = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float kv = ks[lane * ds + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i) sdot[i] = fmaf(qs[(w + 8 * i) * ds + d], kv, sdot[i]);
    }
    for (int d = 0; d < Dv; ++d) {
      const float vv = vs[lane * dvs + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pdot[i] = fmaf(dos[(w + 8 * i) * dvs + d], vv, pdot[i]);
    }
    const int kp = k0 + lane;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = w + 8 * i;
      float t;
      const float s = mask.score(sdot[i], t);
      float dsv = 0.0f;
      if (mask.visible(q0 + r, kp)) {
        const float p = expf(s - lse_s[r]);
        dsv = p * (pdot[i] - delta_s[r]);
        if (mask.softcap > 0.0f) dsv *= 1.0f - t * t;
      }
      dss[r * (kB + 1) + lane] = dsv;
    }
    __syncthreads();
    for (int j = 0; j < kB; ++j) {
      float dv_[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) dv_[i] = dss[(w + 8 * i) * (kB + 1) + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int d = lane + 32 * c;
        if (d < D) {
          const float kv = ks[j * ds + d];
#pragma unroll
          for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(dv_[i], kv, acc[i][c]);
        }
      }
    }
  }
  T* dqb = dq + bh * plane;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = q0 + w + 8 * i;
    if (r >= S) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = lane + 32 * c;
      if (d < D) dqb[(long long)r * D + d] = from_f<T>(acc[i][c] * mask.scale);
    }
  }
}

// ---------------------------------------------------------------------------
// 3. dK and dV: one block per (kv row, key tile), the group's query heads
//    summed in registers
// ---------------------------------------------------------------------------

size_t dkdv_smem(int d, int dv) {
  return 2 * tile_bytes(d) + 2 * tile_bytes(dv) + sizeof(float) * (2 * kB * (kB + 1) + 2 * kB);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int D, int Dv, int group, Mask mask) {
  extern __shared__ float smem[];
  const int S = mask.S, ds = D + 1, dvs = Dv + 1;
  float* ks = smem;                  // kB x ds
  float* qs = ks + kB * ds;          // kB x ds
  float* vs = qs + kB * ds;          // kB x dvs
  float* dos = vs + kB * dvs;        // kB x dvs
  float* pts = dos + kB * dvs;       // kB x (kB + 1): p of key j, query row i
  float* dsts = pts + kB * (kB + 1); // kB x (kB + 1): ds of key j, query row i
  float* lse_s = dsts + kB * (kB + 1);
  float* delta_s = lse_s + kB;
  const int bkv = blockIdx.y, k0 = blockIdx.x * kB;
  const long long plane = (long long)S * D, vplane = (long long)S * Dv;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  stage(ks, k + bkv * plane, k0, S, D);
  stage(vs, v + bkv * vplane, k0, S, Dv);
  float acc_k[kRows][kCols], acc_v[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc_k[i][j] = acc_v[i][j] = 0.0f;

  int lo, hi;
  mask.query_range(k0, lo, hi);
  for (int g = 0; g < group; ++g) {
    const int bh = bkv * group + g;
    const T* qb = q + bh * plane;
    const T* dob = dout + bh * vplane;
    for (int q0 = (lo / kB) * kB; q0 < hi; q0 += kB) {
      __syncthreads();  // the previous tile's q, dO, p and ds are no longer read
      stage(qs, qb, q0, S, D);
      stage(dos, dob, q0, S, Dv);
      if (threadIdx.x < kB) {
        const int r = q0 + threadIdx.x;
        lse_s[threadIdx.x] = r < S ? lse[(long long)bh * S + r] : 0.0f;
        delta_s[threadIdx.x] = r < S ? delta[(long long)bh * S + r] : 0.0f;
      }
      __syncthreads();
      // pairs (key w + 8i, query row `lane`)
      float sdot[kRows], pdot[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) sdot[i] = pdot[i] = 0.0f;
      for (int d = 0; d < D; ++d) {
        const float qv = qs[lane * ds + d];
#pragma unroll
        for (int i = 0; i < kRows; ++i) sdot[i] = fmaf(qv, ks[(w + 8 * i) * ds + d], sdot[i]);
      }
      for (int d = 0; d < Dv; ++d) {
        const float dov = dos[lane * dvs + d];
#pragma unroll
        for (int i = 0; i < kRows; ++i) pdot[i] = fmaf(dov, vs[(w + 8 * i) * dvs + d], pdot[i]);
      }
      const int qp = q0 + lane;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int j = w + 8 * i;
        float t;
        const float s = mask.score(sdot[i], t);
        float p = 0.0f, dsv = 0.0f;
        if (mask.visible(qp, k0 + j)) {
          p = expf(s - lse_s[lane]);
          dsv = p * (pdot[i] - delta_s[lane]);
          if (mask.softcap > 0.0f) dsv *= 1.0f - t * t;
        }
        pts[j * (kB + 1) + lane] = p;
        dsts[j * (kB + 1) + lane] = dsv;
      }
      __syncthreads();
      for (int r = 0; r < kB; ++r) {
        float pv[kRows], dsv[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          pv[i] = pts[(w + 8 * i) * (kB + 1) + r];
          dsv[i] = dsts[(w + 8 * i) * (kB + 1) + r];
        }
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int d = lane + 32 * c;
          if (d < Dv) {
            const float dov = dos[r * dvs + d];
#pragma unroll
            for (int i = 0; i < kRows; ++i) acc_v[i][c] = fmaf(pv[i], dov, acc_v[i][c]);
          }
          if (d < D) {
            const float qv = qs[r * ds + d];
#pragma unroll
            for (int i = 0; i < kRows; ++i) acc_k[i][c] = fmaf(dsv[i], qv, acc_k[i][c]);
          }
        }
      }
    }
  }
  T* dkb = dk + bkv * plane;
  T* dvb = dv + bkv * vplane;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = k0 + w + 8 * i;
    if (r >= S) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = lane + 32 * c;
      if (d < D) dkb[(long long)r * D + d] = from_f<T>(acc_k[i][c] * mask.scale);
      if (d < Dv) dvb[(long long)r * Dv + d] = from_f<T>(acc_v[i][c]);
    }
  }
}

template <typename K>
cudaError_t opt_in(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   void* dq, void* dk, void* dv, float* lse, float* delta, int bh, int s, int d,
                   int d_v, int group, int causal, int kind, int window, float softcap,
                   cudaStream_t stream) {
  const Mask mask{s, causal, kind, window, (float)(1.0 / sqrt((double)d)), softcap};
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const int tiles = (s + kB - 1) / kB;
  cudaError_t err = opt_in(attn_bwd_stats_kernel<T>, stats_smem(d));
  if (err != cudaSuccess) return err;
  attn_bwd_stats_kernel<T><<<dim3(tiles, bh), kThreads, stats_smem(d), stream>>>(
      qt, kt, static_cast<const T*>(o), dot, lse, delta, d, d_v, group, mask);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = opt_in(attn_bwd_dq_kernel<T>, dq_smem(d, d_v))) != cudaSuccess) return err;
  attn_bwd_dq_kernel<T><<<dim3(tiles, bh), kThreads, dq_smem(d, d_v), stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), d, d_v, group, mask);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = opt_in(attn_bwd_dkdv_kernel<T>, dkdv_smem(d, d_v))) != cudaSuccess) return err;
  attn_bwd_dkdv_kernel<T><<<dim3(tiles, bh / group), kThreads, dkdv_smem(d, d_v), stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), d, d_v, group,
      mask);
  return cudaGetLastError();
}

}  // namespace

// q, dq: (bh, s, d); o, dout: (bh, s, d_v); k, dk: (bh / group, s, d); v,
// dv: (bh / group, s, d_v); all f32 (is_bf16 = 0) or all bf16 (is_bf16 =
// 1), contiguous, on the current device; lse, delta: (bh, s) f32
// scratch.  kind: 0 global, 1 local, 2 chunked.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, void* dq, void* dk, void* dv, float* lse,
                                   float* delta, int bh, int s, int d, int d_v, int group,
                                   int is_bf16, int causal, int kind, int window,
                                   double softcap, void* stream) {
  if (bh <= 0 || s <= 0) return (int)cudaSuccess;
  if (d <= 0 || d > kMaxD || d_v <= 0 || d_v > kMaxD || group <= 0 || bh % group)
    return (int)cudaErrorInvalidValue;
  if (kind != kGlobal && window < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(is_bf16 ? launch<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, lse, delta, bh, s,
                                               d, d_v, group, causal, kind, window,
                                               (float)softcap, st)
                       : launch<float>(q, k, v, o, dout, dq, dk, dv, lse, delta, bh, s, d, d_v,
                                       group, causal, kind, window, (float)softcap, st));
}
