// The train step's AdamW update and global gradient norm for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel: the reference jits its whole train step
// (src/repro/distributed/steps.py:249-257), so XLA fuses `adamw.update`'s
// per-leaf chain (src/repro/optim/adamw.py:80-89) into one loop a leaf
// and `global_norm` (:58-61) into one reduction.  Run eagerly, the same
// chain is some 17 launches a leaf (`_update_leaf` in
// src/repro_torch/optim/adamw.py) and moves about 160 bytes a parameter
// in f32 state; these kernels are the port's counterpart of that fusion.
//
// adamw_update: one leaf's update in place.
//   p (n) f32 or bf16, g (n) f32 or bf16, m, v (n) f32, bf16 or f16 (one
//   dtype)
//   gs = g * scale
//   m  = m * b1 + gs * (1 - b1)
//   v  = v * b2 + (gs * (1 - b2)) * gs
//   u  = (m / b1c) / (sqrt(v / b2c) + eps)      [+ wd * p where decayed]
//   p  = p - lr * u
//   held = bf16(p)                              [where asked: P f32]
// in f32, every operation rounded on its own in the order the eager
// chain takes them (the __f*_rn intrinsics: nvcc would otherwise contract
// a product and a sum into one fused multiply-add), and stored with
// round-to-nearest-even where p, m or v is bf16 or f16, as `copy_`
// stores: the result is bitwise the plain version's.  f16 reaches f32
// exactly, so its moments read back as the eager chain reads them.  scale, lr, b1c and b2c are
// read from 0-d f32 tensors on the card, so a step never waits for the
// host; (1 - b1), (1 - b2), eps and wd are the caller's doubles rounded
// to f32, as PyTorch rounds a Python scalar.
//
// grad_norm: the global L2 norm of a list of leaves, each read once in
// its own dtype (f32, bf16 or f16).  grad_sumsq_partials writes one f32 partial sum of
// squares a block of a leaf (a block covers kChunk elements); after all
// leaves, grad_sumsq_finish sums every partial in f64, in a fixed order,
// in one block, and writes the sum (f64) and its square root (f32).  No
// atomics: two calls are bitwise equal.
//
// held: the f32 weights' bf16 working copy, which the one-card train step
// reads at every use in place of a cast (models/layers.py `cast`).  Where
// the caller passes one, the same launch stores round-to-nearest-even of
// the new weight there, bitwise what `p.to(torch.bfloat16)` gives: one
// 16-byte store of 8 bf16 a vector, the head and tail element by element.
//
// What bounds both on this card: bytes.  The update does 17 operations
// an element (with the decay) and moves 28 bytes of it in f32 state (p,
// g, m and v read, p, m and v written), 30 with a held copy, 14 with bf16
// weights, gradients and moments; the norm reads each gradient once (4 or 2 bytes).  At
// recurrentgemma-2b's 2.68e9 f32 parameters the update's bound is 2.68e9
// x 28 B over 3.35 TB/s = 22.4 ms.  The design streams: each thread
// takes 8 consecutive elements at a time with 16-byte loads and stores
// (two a f32 array, one a bf16 array), enough bytes in flight to reach
// the card's rate.  A leaf's element h is the first at which every
// array is 16-byte aligned (its head, fewer than 8 elements, and its
// tail go element by element); where no such element exists (arrays of
// different dtypes offset differently) the wrapper passes head = n and
// the whole leaf goes element by element.
//
// Interface: plain C, bound from Python with ctypes.  Each entry point
// launches on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;                      // elements a thread step
constexpr int kChunkVecs = 4 * kThreads;     // vectors a norm block
constexpr long long kChunk = (long long)kChunkVecs * kVec;
constexpr int kFinishThreads = 1024;
constexpr long long kMaxBlocks = 1 << 20;

// dtype codes of the arrays: 0 f32, 1 bf16, 2 f16
enum Dtype { kF32 = 0, kBF16 = 1, kF16 = 2 };

struct Consts {
  float b1, omb1, b2, omb2, eps, wd;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void store(__half* p, float x) {
  *p = __float2half_rn(x);
}

// 8 consecutive elements from / to a 16-byte aligned address
__device__ __forceinline__ void load8(const float* p, float (&x)[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&x)[kVec]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load8(const __half* p, float (&x)[kVec]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* p, const float (&x)[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
}
__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(x));
}
__device__ __forceinline__ void store8(__nv_bfloat16* p,
                                       const float (&x)[kVec]) {
  uint4 u;
  u.x = bf16_bits(x[0]) | (bf16_bits(x[1]) << 16);
  u.y = bf16_bits(x[2]) | (bf16_bits(x[3]) << 16);
  u.z = bf16_bits(x[4]) | (bf16_bits(x[5]) << 16);
  u.w = bf16_bits(x[6]) | (bf16_bits(x[7]) << 16);
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void store8(__half* p, const float (&x)[kVec]) {
  uint4 u;
  __half2* h = reinterpret_cast<__half2*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2half2_rn(x[2 * i], x[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// one element's update, each operation rounded as the eager op rounds it
__device__ __forceinline__ void adamw_element(
    float g, float& p, float& m, float& v, float scale, float lr, float b1c,
    float b2c, const Consts& c, bool decay) {
  const float gs = __fmul_rn(g, scale);
  m = __fadd_rn(__fmul_rn(m, c.b1), __fmul_rn(gs, c.omb1));
  v = __fadd_rn(__fmul_rn(v, c.b2), __fmul_rn(__fmul_rn(gs, c.omb2), gs));
  float u = __fdiv_rn(__fdiv_rn(m, b1c),
                      __fadd_rn(__fsqrt_rn(__fdiv_rn(v, b2c)), c.eps));
  if (decay) u = __fadd_rn(u, __fmul_rn(c.wd, p));
  p = __fsub_rn(p, __fmul_rn(lr, u));
}

// Elements [head, head + 8 nvec) in vectors of 8, the rest (head and
// tail, `head + n - (head + 8 nvec)` of them) one at a time.
// `held` (null: none) takes the new weights in bf16.
template <typename P, typename G, typename M>
__global__ void __launch_bounds__(kThreads)
adamw_kernel(P* __restrict__ p, const G* __restrict__ g, M* __restrict__ m,
             M* __restrict__ v, __nv_bfloat16* __restrict__ held, long long n,
             long long head, long long nvec,
             const float* __restrict__ scale_p, const float* __restrict__ lr_p,
             const float* __restrict__ b1c_p, const float* __restrict__ b2c_p,
             Consts c, int decay) {
  const float scale = __ldg(scale_p), lr = __ldg(lr_p);
  const float b1c = __ldg(b1c_p), b2c = __ldg(b2c_p);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long i = first; i < nvec; i += stride) {
    const long long e = head + i * kVec;
    float pv[kVec], gv[kVec], mv[kVec], vv[kVec];
    load8(g + e, gv);
    load8(m + e, mv);
    load8(v + e, vv);
    load8(p + e, pv);
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      adamw_element(gv[k], pv[k], mv[k], vv[k], scale, lr, b1c, b2c, c,
                    decay != 0);
    store8(p + e, pv);
    store8(m + e, mv);
    store8(v + e, vv);
    if (held) store8(held + e, pv);
  }
  const long long body_end = head + nvec * kVec;
  const long long rest = head + (n - body_end);
  for (long long i = first; i < rest; i += stride) {
    const long long e = i < head ? i : body_end + (i - head);
    float pe = to_f32(p[e]), me = to_f32(m[e]), ve = to_f32(v[e]);
    adamw_element(to_f32(g[e]), pe, me, ve, scale, lr, b1c, b2c, c,
                  decay != 0);
    store(p + e, pe);
    store(m + e, me);
    store(v + e, ve);
    if (held) store(held + e, pe);
  }
}

// block-wide sum in a fixed order: each warp's by shuffles, then the
// warps' in warp 0
template <typename T, int THREADS>
__device__ __forceinline__ T block_sum(T x) {
  __shared__ T warp_sums[THREADS / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_down_sync(0xffffffffu, x, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = x;
  __syncthreads();
  x = threadIdx.x < THREADS / 32 ? warp_sums[threadIdx.x] : T(0);
  if (warp == 0) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_down_sync(0xffffffffu, x, off);
  }
  return x;
}

// block b: the vectors [b kChunkVecs, (b + 1) kChunkVecs) of the body;
// block 0 also the head and tail elements
template <typename T>
__global__ void __launch_bounds__(kThreads)
sumsq_partials_kernel(const T* __restrict__ x, long long n, long long head,
                      long long nvec, float* __restrict__ partials) {
  float acc = 0.f;
  const long long v0 = (long long)blockIdx.x * kChunkVecs;
#pragma unroll
  for (int j = 0; j < kChunkVecs / kThreads; ++j) {
    const long long i = v0 + j * kThreads + threadIdx.x;
    if (i < nvec) {
      float xv[kVec];
      load8(x + head + i * kVec, xv);
#pragma unroll
      for (int k = 0; k < kVec; ++k) acc = __fmaf_rn(xv[k], xv[k], acc);
    }
  }
  if (blockIdx.x == 0) {
    const long long body_end = head + nvec * kVec;
    const long long rest = head + (n - body_end);
    for (long long i = threadIdx.x; i < rest; i += kThreads) {
      const float e = to_f32(x[i < head ? i : body_end + (i - head)]);
      acc = __fmaf_rn(e, e, acc);
    }
  }
  acc = block_sum<float, kThreads>(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

__global__ void __launch_bounds__(kFinishThreads)
sumsq_finish_kernel(const float* __restrict__ partials, long long count,
                    double* __restrict__ sumsq, float* __restrict__ norm) {
  double acc = 0.0;
  for (long long i = threadIdx.x; i < count; i += kFinishThreads)
    acc += (double)partials[i];
  acc = block_sum<double, kFinishThreads>(acc);
  if (threadIdx.x == 0) {
    if (sumsq) *sumsq = acc;
    if (norm) *norm = (float)sqrt(acc);
  }
}

template <typename P, typename G, typename M>
void launch_update(void* p, const void* g, void* m, void* v, void* held,
                   long long n, long long head, long long nvec,
                   const float* scale, const float* lr, const float* b1c,
                   const float* b2c, const Consts& c, int decay,
                   cudaStream_t stream) {
  const long long rest = head + (n - head - nvec * kVec);
  const long long work = nvec > rest ? nvec : rest;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  adamw_kernel<P, G, M><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<P*>(p), static_cast<const G*>(g), static_cast<M*>(m),
      static_cast<M*>(v), static_cast<__nv_bfloat16*>(held), n, head, nvec,
      scale, lr, b1c, b2c, c, decay);
}

}  // namespace

extern "C" {

// blocks (and so partials) grad_sumsq_partials writes for a leaf of
// `nvec` vectors in its body
long long grad_sumsq_blocks(long long nvec) {
  const long long b = (nvec + kChunkVecs - 1) / kChunkVecs;
  return b < 1 ? 1 : b;
}

// p, g, m, v: the leaf's arrays; held: p's bf16 working copy, or null
// (p must be kF32 where it is given); p_dtype, g_dtype: kF32 or kBF16,
// m_dtype (m and v share one dtype): kF32, kBF16 or kF16; n elements; the
// body
// starts at element `head` and holds `nvec` vectors of 8 (head = n, nvec =
// 0: element by element); scale, lr, b1c, b2c: 0-d f32 tensors on the
// card.  Another pairing returns cudaErrorInvalidValue and launches
// nothing.
int adamw_update(void* p, const void* g, void* m, void* v, void* held,
                 int p_dtype,
                 int g_dtype, int m_dtype, long long n, long long head,
                 long long nvec, const void* scale, const void* lr,
                 const void* b1c, const void* b2c, double b1, double omb1,
                 double b2, double omb2, double eps, double wd, int decay,
                 void* stream) {
  if (p_dtype < kF32 || p_dtype > kBF16 || g_dtype < kF32 || g_dtype > kBF16 ||
      m_dtype < kF32 || m_dtype > kF16 || (held && p_dtype != kF32))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  const Consts c{(float)b1, (float)omb1, (float)b2, (float)omb2, (float)eps,
                 (float)wd};
  const auto* s = static_cast<const float*>(scale);
  const auto* l = static_cast<const float*>(lr);
  const auto* c1 = static_cast<const float*>(b1c);
  const auto* c2 = static_cast<const float*>(b2c);
  auto st = static_cast<cudaStream_t>(stream);
  using F = float;
  using B = __nv_bfloat16;
  using H = __half;
  switch (3 * (2 * p_dtype + g_dtype) + m_dtype) {
    case 0: launch_update<F, F, F>(p, g, m, v, held, n, head, nvec, s, l, c1, c2, c, decay, st); break;
    case 1: launch_update<F, F, B>(p, g, m, v, held, n, head, nvec, s, l, c1, c2, c, decay, st); break;
    case 2: launch_update<F, F, H>(p, g, m, v, held, n, head, nvec, s, l, c1, c2, c, decay, st); break;
    case 3: launch_update<F, B, F>(p, g, m, v, held, n, head, nvec, s, l, c1, c2, c, decay, st); break;
    case 4: launch_update<F, B, B>(p, g, m, v, held, n, head, nvec, s, l, c1, c2, c, decay, st); break;
    case 5: launch_update<F, B, H>(p, g, m, v, held, n, head, nvec, s, l, c1, c2, c, decay, st); break;
    case 6: launch_update<B, F, F>(p, g, m, v, held, n, head, nvec, s, l, c1, c2, c, decay, st); break;
    case 7: launch_update<B, F, B>(p, g, m, v, held, n, head, nvec, s, l, c1, c2, c, decay, st); break;
    case 8: launch_update<B, F, H>(p, g, m, v, held, n, head, nvec, s, l, c1, c2, c, decay, st); break;
    case 9: launch_update<B, B, F>(p, g, m, v, held, n, head, nvec, s, l, c1, c2, c, decay, st); break;
    case 10: launch_update<B, B, B>(p, g, m, v, held, n, head, nvec, s, l, c1, c2, c, decay, st); break;
    default: launch_update<B, B, H>(p, g, m, v, held, n, head, nvec, s, l, c1, c2, c, decay, st); break;
  }
  return (int)cudaGetLastError();
}

// x: a leaf of n elements of dtype code `dtype` (kF32, kBF16 or kF16),
// its body from element `head`, `nvec` vectors of 8; writes
// grad_sumsq_blocks(nvec) partials
int grad_sumsq_partials(const void* x, int dtype, long long n,
                        long long head, long long nvec, void* partials,
                        void* stream) {
  if (dtype < kF32 || dtype > kF16) return (int)cudaErrorInvalidValue;
  const long long blocks = grad_sumsq_blocks(nvec);
  auto st = static_cast<cudaStream_t>(stream);
  auto* out = static_cast<float*>(partials);
  if (dtype == kBF16)
    sumsq_partials_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), n, head, nvec, out);
  else if (dtype == kF16)
    sumsq_partials_kernel<__half><<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const __half*>(x), n, head, nvec, out);
  else
    sumsq_partials_kernel<float><<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const float*>(x), n, head, nvec, out);
  return (int)cudaGetLastError();
}

// the sum of `count` partials in f64 into *sumsq and its square root in
// f32 into *norm (either may be null)
int grad_sumsq_finish(const void* partials, long long count, void* sumsq,
                      void* norm, void* stream) {
  sumsq_finish_kernel<<<1, kFinishThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partials), count,
      static_cast<double*>(sumsq), static_cast<float*>(norm));
  return (int)cudaGetLastError();
}

}  // extern "C"
