// Mamba-2 SSD chunked scan, backward, for Hopper (sm_90a): a first design
// on the CUDA cores in f32.
//
// The Pallas TPU kernel `ssd_scan` (src/repro/kernels/ssd_scan.py:65) has
// no backward: the reference trains through `ssd_chunked`
// (src/repro/models/ssd.py:63), which XLA differentiates.  This kernel is
// the gradient of ssd_scan.cu and ssd_scan_wgmma.cu (the same function):
//   x, dy (B, H, S, P), dA and dt (B, H, S) f32, Bm and Cm (B, G, S, N)
//   with G dividing H, h0 and dh (B, H, P, N) f32 or none (zeros)
//   -> dx (B, H, S, P), ddA, ddt (B, H, S) f32, dB and dC (B, G, S, N),
//      dh0 (B, H, P, N) f32,
// x, dy, Bm, Cm, dx, dB and dC all f32 or all bf16, read as f32; every
// product is summed in f32.
//
// Arithmetic (the state-passing form, chunks of 64 rows as the forward
// kernels take).  Per chunk, with cum the within-chunk cumulative sum of
// dA, L its last row, h_in the state entering the chunk and g the
// gradient by the state leaving it:
//   g_{c-1} = e^{cum_L} g_c + sum_i e^{cum_i} dy_i C_i^T,  dh0 = g_{-1}
//   W_ij = (C_i . B_j) e^{cum_i - cum_j} dt_j,  R_ij = (dy_i . x_j) e^{..} dt_j
//   (i >= j, else 0);  w_j = e^{cum_L - cum_j} dt_j
//   dx_j = sum_i W_ij dy_i + w_j g B_j
//   dC_i = sum_j R_ij B_j + e^{cum_i} h_in^T dy_i
//   dB_j = sum_i R_ij C_i + w_j g^T x_j
//   ddt_j = sum_i (dy_i . x_j)(C_i . B_j) e^{cum_i - cum_j} + e^{cum_L - cum_j} u_j,
//           u_j = x_j . g B_j
//   dcum_i = sum_{j<i} Q_ij - sum_{k>i} Q_ki + e^{cum_i} C_i . h_in^T dy_i
//            - w_i u_i,  Q_ij = (dy_i . x_j)(C_i . B_j) e^{cum_i - cum_j} dt_j,
//   dcum_L += sum_j w_j u_j + e^{cum_L} <g, h_in>,  ddA_k = sum_{i >= k} dcum_i
// and dB, dC summed over the heads of each group (ref.ssd_scan_bwd_ref
// writes the same in PyTorch).
//
// What bounds it on this card.  At mamba2-2.7b's training shape (H = 80,
// P = 64, N = 128, one group, S = 3,000) a chunk's ten products of 64 x
// 64 x 64-128 (two for its state terms, eight for its gradients) are
// some 9.4 MFLOP a head, 35 GFLOP in all: 0.07 ms at the TF32 tensor-core
// rate, 0.04 ms at bf16's, above the inputs' and outputs' bytes (about
// 0.03 ms in bf16).  This first design runs them on the CUDA cores from
// shared memory (67 TFLOP/s at most); moving the bf16 shape onto wgmma
// is later work.
//
// Four launches on the caller's stream, no atomics (two calls give bitwise
// the same gradients):
//   1. ssd_bwd_chunk_kernel, one block per (chunk, head, batch): cum, its
//      last row, and the chunk's two state terms dS_c = x^T (B w) and
//      dG_c = (dy e^cum)^T C (P x N each), written to the two state
//      buffers;
//   2. ssd_bwd_pass_kernel, one thread per (batch, head, state element):
//      the forward pass over the chunks turns the dS_c into the states
//      entering each chunk (h_c = e^{cum_L} h_{c-1} + dS_c from h0), and the
//      reverse pass turns the dG_c into the gradients by the state leaving
//      each chunk (from dh), in place; its last value is dh0.  Serial in c,
//      as the forward's pass is;
//   3. ssd_bwd_main_kernel, one block per (chunk, head, batch): the chunk's
//      rows, its h_in and g in shared memory (about 167 KB at P 64, N 128),
//      dx, ddt, ddA and the head's dB and dC partials (f32, to scratch);
//   4. ssd_bwd_group_sum_kernel: dB and dC, each group's heads' partials
//      summed in head order.
// Scratch (the wrapper's): the two state buffers, B H ceil(S/64) P N f32
// each (123 MB each at the training shape), the chunks' last cum, and the
// dB and dC partials, B H S N f32 each (123 MB each).
//
// Where trouble lies, and what the design does:
//   * exp only where i >= j: above the diagonal cum_i - cum_j may be
//     positive and overflow, and inf * 0 would be NaN;
//   * a ragged last chunk loads zeros past S: dA = 0 keeps cum at its last
//     valid row, dt = 0, x = dy = B = C = 0 give those rows no weight, and
//     rows past S are not written; dcum_L goes to the last valid row,
//     whose reverse sum is the same;
//   * ddA's reverse cumulative sum and every reduction run in a fixed
//     order (warp shuffles of a fixed tree, one thread's serial loops);
//   * each thread holds a 4 x 4 tile of dx and 4 x 8 tiles of dB and dC in
//     registers across the block's phases; the rows that are read by 16
//     lanes at once are padded to an odd stride, so they fall on distinct
//     banks.
//
// Interface: plain C, bound from Python with ctypes.  The entry point
// launches on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kC = 64;        // rows per chunk
constexpr int kMaxP = 64;     // head dim: four columns of 16 per lane
constexpr int kMaxN = 128;    // d_state: eight columns of 16 per lane
constexpr int kThreads = 256;
constexpr int kDefaultSmemLimit = 48 * 1024;

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

long long align64(long long n) { return (n + 63) / 64 * 64; }

// The scratch's regions, in floats, each a multiple of 64 (256 bytes).
struct Scratch {
  long long hin, gout, last, part_b, part_c, total;
  Scratch(int batch, int heads, int s, int p, int n) {
    const long long nc = (s + kC - 1) / kC;
    const long long bh = (long long)batch * heads;
    const long long states = align64(bh * nc * p * n);
    hin = 0;
    gout = states;
    last = 2 * states;
    part_b = last + align64(bh * nc);
    part_c = part_b + align64(bh * s * n);
    total = part_c + align64(bh * s * n);
  }
};

// A chunk's rows in shared memory, strides P + 1 and N + 1 (odd: 16 lanes
// reading one column of 16 rows fall on distinct banks).
struct Rows {
  int xp, np;  // row strides of the (kC x P) and (kC x N) tiles
  __host__ __device__ Rows(int p, int n) : xp(p + 1), np(n + 1) {}
};

// Thread 0: cum = the within-chunk cumulative sum of dA (64 adds in row
// order, the same in every kernel of this file).
__device__ __forceinline__ void chunk_cum(float* cum) {
  if (threadIdx.x == 0) {
    float run = 0.0f;
    for (int r = 0; r < kC; ++r) {
      run += cum[r];
      cum[r] = run;
    }
  }
}

// Loads the chunk's rows starting at c0 from an (S, width) matrix into a
// (kC, stride) tile as f32, zeros from row `valid` on.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int c0, int valid,
                                          int width, int stride) {
  for (int e = threadIdx.x; e < kC * width; e += kThreads) {
    const int r = e / width, c = e % width;
    dst[r * stride + c] = r < valid ? to_f(src[(long long)(c0 + r) * width + c]) : 0.0f;
  }
}

// Sum over the 16 lanes that share tid / 16 (a fixed xor tree).
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---------------------------------------------------------------------------
// 1. a chunk's state terms: dS_c = x^T (B w), dG_c = (dy e^cum)^T C
// ---------------------------------------------------------------------------

size_t chunk_smem(int p, int n) {
  const Rows rw(p, n);
  return sizeof(float) * (2 * (size_t)kC * rw.xp + 2 * (size_t)kC * rw.np + 2 * kC);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dA,
                     const float* __restrict__ dt, const T* __restrict__ Bm,
                     const T* __restrict__ Cm, const T* __restrict__ dy,
                     float* __restrict__ hin, float* __restrict__ gout,
                     float* __restrict__ last, int H, int G, int S, int P, int N) {
  extern __shared__ float smem[];
  const Rows rw(P, N);
  float* xs = smem;                 // kC x xp: x_j w_j
  float* dys = xs + kC * rw.xp;     // kC x xp: dy_i e^cum_i
  float* bs = dys + kC * rw.xp;     // kC x np
  float* cs = bs + kC * rw.np;      // kC x np
  float* cum = cs + kC * rw.np;     // kC
  float* dts = cum + kC;            // kC

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const int c0 = c * kC, valid = min(kC, S - c0);
  const long long bh = (long long)b * H + h;
  const long long bg = (long long)b * G + h / (H / G);
  const int tid = threadIdx.x;

  load_tile(xs, x + bh * S * P, c0, valid, P, rw.xp);
  load_tile(dys, dy + bh * S * P, c0, valid, P, rw.xp);
  load_tile(bs, Bm + bg * S * N, c0, valid, N, rw.np);
  load_tile(cs, Cm + bg * S * N, c0, valid, N, rw.np);
  if (tid < kC) {
    cum[tid] = tid < valid ? dA[bh * S + c0 + tid] : 0.0f;
    dts[tid] = tid < valid ? dt[bh * S + c0 + tid] : 0.0f;
  }
  __syncthreads();
  chunk_cum(cum);
  __syncthreads();
  const float cl = cum[kC - 1];
  if (tid == 0) last[bh * nc + c] = cl;
  for (int e = tid; e < kC * P; e += kThreads) {
    const int r = e / P, q = e % P;
    xs[r * rw.xp + q] *= expf(cl - cum[r]) * dts[r];
    dys[r * rw.xp + q] *= expf(cum[r]);
  }
  __syncthreads();

  // state rows p = pr + 16 a, columns n = ci + 16 b
  const int pr = tid / 16, ci = tid % 16;
  float s_acc[4][8], g_acc[4][8];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int k = 0; k < 8; ++k) s_acc[a][k] = g_acc[a][k] = 0.0f;
  for (int j = 0; j < valid; ++j) {
    float xv[4], dv[4], bv[8], cv[8];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int p = min(pr + 16 * a, P - 1);
      xv[a] = xs[j * rw.xp + p];
      dv[a] = dys[j * rw.xp + p];
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int n = min(ci + 16 * k, N - 1);
      bv[k] = bs[j * rw.np + n];
      cv[k] = cs[j * rw.np + n];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        s_acc[a][k] = fmaf(xv[a], bv[k], s_acc[a][k]);
        g_acc[a][k] = fmaf(dv[a], cv[k], g_acc[a][k]);
      }
  }
  const long long base = (bh * nc + c) * (long long)P * N;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int p = pr + 16 * a;
    if (p >= P) continue;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int n = ci + 16 * k;
      if (n < N) {
        hin[base + (long long)p * N + n] = s_acc[a][k];
        gout[base + (long long)p * N + n] = g_acc[a][k];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 2. the passes over the chunks, in place: dS_c -> h entering chunk c,
//    dG_c -> g leaving chunk c; dh0 = g entering the first chunk
// ---------------------------------------------------------------------------

constexpr int kPassGroup = 8;  // chunks whose terms a thread loads at once

// One pass over the chunks, in place: x_c <- v, v <- e^{last_c} v + x_c,
// chunk order c0, c0 + step, ... (nc chunks); returns the final v.  Each
// group's kPassGroup terms are loaded before any is overwritten, so the
// loads of a group are in flight together: the compiler may not move a
// chunk's load above the previous chunk's store, which it cannot prove
// apart, so loaded one at a time each would wait out a load's latency.
__device__ __forceinline__ float chunk_pass(float* x, const float* last, float v, int nc,
                                            int c0, int step, long long stride) {
  for (int k0 = 0; k0 < nc; k0 += kPassGroup) {
    float t[kPassGroup], d[kPassGroup];
#pragma unroll
    for (int i = 0; i < kPassGroup; ++i) {
      const int c = c0 + step * (k0 + i);
      if (k0 + i < nc) {
        t[i] = x[c * stride];
        d[i] = expf(last[c]);
      }
    }
#pragma unroll
    for (int i = 0; i < kPassGroup; ++i) {
      if (k0 + i < nc) {
        x[(c0 + step * (k0 + i)) * stride] = v;
        v = d[i] * v + t[i];
      }
    }
  }
  return v;
}

__global__ void __launch_bounds__(256)
ssd_bwd_pass_kernel(float* __restrict__ hin, float* __restrict__ gout,
                    const float* __restrict__ last, const float* __restrict__ h0,
                    const float* __restrict__ dh, float* __restrict__ dh0, int nc, int PN) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= PN) return;
  const long long bh = blockIdx.y;
  const float* lb = last + bh * nc;
  const float h = h0 != nullptr ? h0[bh * PN + e] : 0.0f;
  chunk_pass(hin + bh * nc * PN + e, lb, h, nc, 0, 1, PN);
  const float g = dh != nullptr ? dh[bh * PN + e] : 0.0f;
  const float g0 = chunk_pass(gout + bh * nc * PN + e, lb, g, nc, nc - 1, -1, PN);
  if (dh0 != nullptr) dh0[bh * PN + e] = g0;
}

// ---------------------------------------------------------------------------
// 3. a chunk's gradients
// ---------------------------------------------------------------------------

// Shared memory: x, dy (kC x xp), B, C (kC x np), then a region that holds
// h_in and g (P x np each) and afterwards the intra-chunk matrices M, R and
// G (kC x (kC + 1) each), then the rows' vectors.
__host__ __device__ inline size_t main_region(int p, int n) {
  const size_t states = 2 * (size_t)p * (n + 1);
  const size_t mats = 3 * (size_t)kC * (kC + 1);
  return states > mats ? states : mats;
}

constexpr int kVecs = 7;  // cum, dt, w, e^cum, u, v, dcum

size_t main_smem(int p, int n) {
  const Rows rw(p, n);
  return sizeof(float) * (2 * (size_t)kC * rw.xp + 2 * (size_t)kC * rw.np + main_region(p, n) +
                          kVecs * kC + kThreads / 32);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_main_kernel(const T* __restrict__ x, const float* __restrict__ dA,
                    const float* __restrict__ dt, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, const T* __restrict__ dy,
                    const float* __restrict__ hin, const float* __restrict__ gout,
                    T* __restrict__ dx, float* __restrict__ ddA, float* __restrict__ ddt,
                    float* __restrict__ part_b, float* __restrict__ part_c, int H, int G,
                    int S, int P, int N) {
  extern __shared__ float smem[];
  const Rows rw(P, N);
  constexpr int kM = kC + 1;        // stride of the intra-chunk matrices
  float* xs = smem;                 // kC x xp
  float* dys = xs + kC * rw.xp;     // kC x xp
  float* bs = dys + kC * rw.xp;     // kC x np
  float* cs = bs + kC * rw.np;      // kC x np
  float* region = cs + kC * rw.np;
  float* hs = region;               // P x np: h_in
  float* gs = hs + P * rw.np;       // P x np: g
  float* ms = region;               // kC x kM: W (after the state terms)
  float* rs = ms + kC * kM;         // kC x kM: R
  float* gm = rs + kC * kM;         // kC x kM: (dy_i . x_j)(C_i . B_j) e^{..}
  float* cum = region + main_region(P, N);
  float* dts = cum + kC;
  float* ws = dts + kC;             // e^{cum_L - cum_j} dt_j
  float* ecum = ws + kC;            // e^{cum_i}
  float* us = ecum + kC;            // u_j = x_j . g B_j
  float* vs = us + kC;              // v_i = C_i . h_in^T dy_i
  float* dcum = vs + kC;
  float* red = dcum + kC;           // a partial of <g, h_in> a warp

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const int c0 = c * kC, valid = min(kC, S - c0);
  const long long bh = (long long)b * H + h;
  const long long bg = (long long)b * G + h / (H / G);
  const int tid = threadIdx.x;
  const int ri = tid / 16, ci = tid % 16;  // rows ri + 16 a, columns ci + 16 b

  load_tile(xs, x + bh * S * P, c0, valid, P, rw.xp);
  load_tile(dys, dy + bh * S * P, c0, valid, P, rw.xp);
  load_tile(bs, Bm + bg * S * N, c0, valid, N, rw.np);
  load_tile(cs, Cm + bg * S * N, c0, valid, N, rw.np);
  const long long sbase = (bh * nc + c) * (long long)P * N;
  for (int e = tid; e < P * N; e += kThreads) {
    const int p = e / N, n = e % N;
    hs[p * rw.np + n] = hin[sbase + e];
    gs[p * rw.np + n] = gout[sbase + e];
  }
  if (tid < kC) {
    cum[tid] = tid < valid ? dA[bh * S + c0 + tid] : 0.0f;
    dts[tid] = tid < valid ? dt[bh * S + c0 + tid] : 0.0f;
  }
  __syncthreads();
  chunk_cum(cum);
  __syncthreads();
  const float cl = cum[kC - 1];
  if (tid < kC) {
    ws[tid] = expf(cl - cum[tid]) * dts[tid];
    ecum[tid] = expf(cum[tid]);
  }
  __syncthreads();

  // the state terms; dC's first holds h_in^T dy, dx's first g B
  float acc_x[4][4], acc_b[4][8], acc_c[4][8];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int k = 0; k < 4; ++k) acc_x[a][k] = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) acc_b[a][k] = acc_c[a][k] = 0.0f;
  }
  for (int p = 0; p < P; ++p) {
    float dv[4], xv[4], hv[8], gv[8];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      dv[a] = dys[(ri + 16 * a) * rw.xp + p];
      xv[a] = xs[(ri + 16 * a) * rw.xp + p];
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int n = min(ci + 16 * k, N - 1);
      hv[k] = hs[p * rw.np + n];
      gv[k] = gs[p * rw.np + n];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        acc_c[a][k] = fmaf(dv[a], hv[k], acc_c[a][k]);
        acc_b[a][k] = fmaf(xv[a], gv[k], acc_b[a][k]);
      }
  }
  for (int n = 0; n < N; ++n) {
    float bv[4], gv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) bv[a] = bs[(ri + 16 * a) * rw.np + n];
#pragma unroll
    for (int k = 0; k < 4; ++k) gv[k] = gs[min(ci + 16 * k, P - 1) * rw.np + n];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc_x[a][k] = fmaf(bv[a], gv[k], acc_x[a][k]);
  }
  // v_i = C_i . (h_in^T dy_i), u_j = x_j . (g B_j): sums over the 16 lanes
  // of a row; then the scales e^{cum_i} and w_j
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ri + 16 * a;
    float vp = 0.0f, up = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (ci + 16 * k < N) vp = fmaf(cs[r * rw.np + ci + 16 * k], acc_c[a][k], vp);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (ci + 16 * k < P) up = fmaf(xs[r * rw.xp + ci + 16 * k], acc_x[a][k], up);
    vp = sum16(vp);
    up = sum16(up);
    if (ci == 0) {
      vs[r] = vp;
      us[r] = up;
    }
    const float e = ecum[r], w = ws[r];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      acc_c[a][k] *= e;
      acc_b[a][k] *= w;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) acc_x[a][k] *= w;
  }
  // <g, h_in>: each thread's elements, then the warps' in order
  {
    float gh = 0.0f;
    for (int e = tid; e < P * N; e += kThreads) {
      const int p = e / N, n = e % N;
      gh = fmaf(gs[p * rw.np + n], hs[p * rw.np + n], gh);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) gh += __shfl_xor_sync(0xffffffffu, gh, off);
    if (tid % 32 == 0) red[tid / 32] = gh;
  }
  __syncthreads();  // h_in and g are no longer read: the region takes M, R, G

  // C B^T and dy x^T at (i, j) = (ri + 16 a, ci + 16 b), then W, R and G
  {
    float cb[4][4], dx_[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int k = 0; k < 4; ++k) cb[a][k] = dx_[a][k] = 0.0f;
    for (int n = 0; n < N; ++n) {
      float cv[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) cv[a] = cs[(ri + 16 * a) * rw.np + n];
#pragma unroll
      for (int k = 0; k < 4; ++k) bv[k] = bs[(ci + 16 * k) * rw.np + n];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int k = 0; k < 4; ++k) cb[a][k] = fmaf(cv[a], bv[k], cb[a][k]);
    }
    for (int p = 0; p < P; ++p) {
      float dv[4], xv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) dv[a] = dys[(ri + 16 * a) * rw.xp + p];
#pragma unroll
      for (int k = 0; k < 4; ++k) xv[k] = xs[(ci + 16 * k) * rw.xp + p];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int k = 0; k < 4; ++k) dx_[a][k] = fmaf(dv[a], xv[k], dx_[a][k]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = ri + 16 * a, j = ci + 16 * k;
        float m = 0.0f, r = 0.0f, gg = 0.0f;
        if (i >= j) {  // exp only on and below the diagonal
          const float l = expf(cum[i] - cum[j]);
          m = cb[a][k] * l * dts[j];
          r = dx_[a][k] * l * dts[j];
          gg = cb[a][k] * dx_[a][k] * l;
        }
        ms[i * kM + j] = m;
        rs[i * kM + j] = r;
        gm[i * kM + j] = gg;
      }
    }
  }
  __syncthreads();

  // dx_j += sum_i W_ij dy_i;  dC_i += sum_j R_ij B_j;  dB_j += sum_i R_ij C_i
  for (int i = 0; i < valid; ++i) {
    float dv[4], mv[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) dv[k] = dys[i * rw.xp + min(ci + 16 * k, P - 1)];
#pragma unroll
    for (int a = 0; a < 4; ++a) mv[a] = ms[i * kM + ri + 16 * a];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc_x[a][k] = fmaf(mv[a], dv[k], acc_x[a][k]);
  }
  for (int j = 0; j < valid; ++j) {
    float bv[8], cv[8], rij[4], rji[4];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int n = min(ci + 16 * k, N - 1);
      bv[k] = bs[j * rw.np + n];
      cv[k] = cs[j * rw.np + n];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      rij[a] = rs[(ri + 16 * a) * kM + j];  // R_{i j}, i = this thread's row
      rji[a] = rs[j * kM + ri + 16 * a];    // R_{j i}: row j of C for dB_i
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        acc_c[a][k] = fmaf(rij[a], bv[k], acc_c[a][k]);
        acc_b[a][k] = fmaf(rji[a], cv[k], acc_b[a][k]);
      }
  }

  // the rows' scalars: ddt_j and dcum_i, thread r for row r.  Q's
  // diagonal enters dcum_i twice with opposite signs, so both of its sums
  // leave it out (a row that sees only itself gets exactly its own terms)
  if (tid < kC) {
    const int r = tid;
    float col = 0.0f, row = 0.0f;
    for (int i = r + 1; i < kC; ++i) col += gm[i * kM + r];
    for (int j = 0; j < r; ++j) row = fmaf(gm[r * kM + j], dts[j], row);
    dcum[r] = row - dts[r] * col + ecum[r] * vs[r] - ws[r] * us[r];
    if (r < valid)
      ddt[bh * S + c0 + r] = (gm[r * kM + r] + col) + expf(cl - cum[r]) * us[r];
  }
  __syncthreads();
  if (tid == 0) {
    float wu = 0.0f, gh = 0.0f;
    for (int j = 0; j < kC; ++j) wu = fmaf(ws[j], us[j], wu);
    for (int k = 0; k < kThreads / 32; ++k) gh += red[k];
    dcum[valid - 1] += wu + expf(cl) * gh;
    float run = 0.0f;  // ddA_k = sum_{i >= k} dcum_i
    for (int k = valid - 1; k >= 0; --k) {
      run += dcum[k];
      ddA[bh * S + c0 + k] = run;
    }
  }

  // dx, and the head's dB and dC partials, rows below S
  T* dxb = dx + bh * S * P;
  float* pb = part_b + bh * S * N;
  float* pc = part_c + bh * S * N;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ri + 16 * a;
    if (r >= valid) continue;
    const long long row = c0 + r;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int p = ci + 16 * k;
      if (p < P) dxb[row * P + p] = from_f<T>(acc_x[a][k]);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int n = ci + 16 * k;
      if (n < N) {
        pb[row * N + n] = acc_b[a][k];
        pc[row * N + n] = acc_c[a][k];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 4. dB and dC: each group's heads' partials summed in head order
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256)
ssd_bwd_group_sum_kernel(const float* __restrict__ part_b, const float* __restrict__ part_c,
                         T* __restrict__ dB, T* __restrict__ dC, long long per_group,
                         long long total, int rep) {
  // per_group = S N elements of one (batch, group); head h of group g is
  // g rep + r, and part's (batch, head) planes follow dB's (batch, group)
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const long long bg = e / per_group, off = e % per_group;
    const long long first = bg * rep * per_group + off;
    float sb = 0.0f, sc = 0.0f;
    for (int r = 0; r < rep; ++r) {
      sb += part_b[first + r * per_group];
      sc += part_c[first + r * per_group];
    }
    dB[e] = from_f<T>(sb);
    dC[e] = from_f<T>(sc);
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= (size_t)kDefaultSmemLimit) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T>
cudaError_t launch(const void* x, const float* dA, const float* dt, const void* Bm,
                   const void* Cm, const float* h0, const void* dy, const float* dh, void* dx,
                   float* ddA, float* ddt, void* dB, void* dC, float* dh0, float* scratch,
                   int batch, int heads, int groups, int s, int p, int n,
                   cudaStream_t stream) {
  const Scratch sc(batch, heads, s, p, n);
  float* hin = scratch + sc.hin;
  float* gout = scratch + sc.gout;
  float* last = scratch + sc.last;
  float* part_b = scratch + sc.part_b;
  float* part_c = scratch + sc.part_c;
  const int nc = (s + kC - 1) / kC;
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(Bm);
  const T* ct = static_cast<const T*>(Cm);
  const T* dyt = static_cast<const T*>(dy);
  const dim3 grid(nc, heads, batch);

  const size_t smem1 = chunk_smem(p, n);
  cudaError_t err = allow_smem(ssd_bwd_chunk_kernel<T>, smem1);
  if (err != cudaSuccess) return err;
  ssd_bwd_chunk_kernel<T><<<grid, kThreads, smem1, stream>>>(xt, dA, dt, bt, ct, dyt, hin, gout,
                                                             last, heads, groups, s, p, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int pn = p * n;
  ssd_bwd_pass_kernel<<<dim3((pn + 255) / 256, batch * heads), 256, 0, stream>>>(
      hin, gout, last, h0, dh, dh0, nc, pn);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t smem3 = main_smem(p, n);
  if ((err = allow_smem(ssd_bwd_main_kernel<T>, smem3)) != cudaSuccess) return err;
  ssd_bwd_main_kernel<T><<<grid, kThreads, smem3, stream>>>(
      xt, dA, dt, bt, ct, dyt, hin, gout, static_cast<T*>(dx), ddA, ddt, part_b, part_c, heads,
      groups, s, p, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const long long per_group = (long long)s * n;
  const long long total = (long long)batch * groups * per_group;
  const long long blocks = (total + 255) / 256;
  ssd_bwd_group_sum_kernel<T><<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(
      part_b, part_c, static_cast<T*>(dB), static_cast<T*>(dC), per_group, total,
      heads / groups);
  return cudaGetLastError();
}

}  // namespace

// Bytes of scratch ssd_scan_bwd needs for this shape.
extern "C" long long ssd_scan_bwd_scratch_bytes(int batch, int heads, int s, int p, int n) {
  if (batch <= 0 || heads <= 0 || s <= 0 || p <= 0 || n <= 0) return 0;
  return Scratch(batch, heads, s, p, n).total * (long long)sizeof(float);
}

// x, dy, dx: (batch, heads, s, p); dA, dt, ddA, ddt: (batch, heads, s) f32;
// Bm, Cm, dB, dC: (batch, groups, s, n); h0, dh (or null), dh0 (or null):
// (batch, heads, p, n) f32; scratch: ssd_scan_bwd_scratch_bytes of f32.
// x, dy, dx, Bm, Cm, dB and dC all f32 (is_bf16 = 0) or all bf16 (is_bf16 =
// 1); all contiguous, on the current device; p <= 64, n <= 128, groups
// dividing heads.
extern "C" int ssd_scan_bwd(const void* x, const float* dA, const float* dt, const void* Bm,
                            const void* Cm, const float* h0, const void* dy, const float* dh,
                            void* dx, float* ddA, float* ddt, void* dB, void* dC, float* dh0,
                            float* scratch, int batch, int heads, int groups, int s, int p,
                            int n, int is_bf16, void* stream) {
  if (batch <= 0 || heads <= 0 || s <= 0) return (int)cudaSuccess;
  if (p <= 0 || p > kMaxP || n <= 0 || n > kMaxN || groups <= 0 || heads % groups)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(x, dA, dt, Bm, Cm, h0, dy, dh, dx, ddA, ddt, dB, dC, dh0,
                                      scratch, batch, heads, groups, s, p, n, st)
              : launch<float>(x, dA, dt, Bm, Cm, h0, dy, dh, dx, ddA, ddt, dB, dC, dh0, scratch,
                              batch, heads, groups, s, p, n, st);
  return (int)err;
}
