// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `ssd_scan` (`_kernel`) of
// src/repro/kernels/ssd_scan.py:
//   x (B, H, S, P), dA and dt (B, H, S) f32, Bm and Cm (B, G, S, N) with G
//   dividing H (head h reads group h / (H / G)), h0 (B, H, P, N) f32 or
//   none -> y (B, H, S, P) in x's dtype, final state (B, H, P, N) f32.
// x, Bm and Cm are all f32 or all bf16; they are read as f32 and every
// product is summed in f32, as the Pallas kernel's `.astype(f32)` does.
// Per chunk of rows, with cum the within-chunk cumulative sum of dA:
//   y = ((C B^T) * L * dt) x + exp(cum) * (C h^T),
//       L[i, j] = exp(cum_i - cum_j) for i >= j, else 0
//   h <- h * exp(cum_last) + x^T (B * w),  w = exp(cum_last - cum) * dt
// The SSD is the same function for any chunking; only rounding moves.
//
// What bounds it on this card.  At mamba2-2.7b's serving shapes (H = 80,
// P = 64, N = 128, one group, bf16, S up to 3,001) a chunk of c rows does
// about c^2/2 * 2(N + P) + 4 c N P operations per head against some
// 2 c P bf16 bytes of x and y, so the bytes bound (x and y read and
// written once, about 67 MB at S = 3,001) and the operations bound are of
// one size, some 0.01-0.02 ms each.  This first kernel does its products
// on the CUDA cores in f32 from shared memory (67 TFLOP/s at most, and
// shared-memory loads before that), not on the tensor cores.  It now
// serves f32 and the shapes other than P = 64, N = 128 (bf16 there runs
// on ssd_scan_wgmma.cu), and stays callable at every shape as that
// kernel's yardstick.
//
// What the design does:
//   * one block of 256 threads per (batch, head, tile of 32 state rows
//     p): 160 blocks at the serving shapes where a block per head would
//     give 80 on 132 SMs.  The state rows are independent given B, C and
//     dt, so each block recomputes C B^T for its tile;
//   * chunks of 64 rows, walked in order inside the block; the tile of
//     the state (32 x N f32) stays in shared memory across chunks.  The
//     TPU kernel's chunk of 256 rows would need 256 KB for C B^T alone;
//     64 rows take about 106 KB of dynamic shared memory at N = 128
//     (above the default 48 KB, set per launch with cudaFuncSetAttribute),
//     two blocks per SM;
//   * exp is taken only where i >= j: above the diagonal cum_i - cum_j may
//     be positive and overflow, and inf * 0 would be NaN;
//   * a ragged last chunk loads zeros past S: dA = 0 leaves cum at its
//     last valid row, dt = 0 gives those rows no weight in y or h, and
//     rows past S are not written, so any S works with one chunk size;
//   * each thread keeps a 4 x 4 tile of C B^T, a 4 x 2 tile of y and a
//     4 x 4 tile of the state update in registers; rows of B, C and the
//     state are padded to N + 1 floats, so the column reads of a warp fall
//     on distinct banks.
//
// Interface: plain C, bound from Python with ctypes.  The entry point
// launches on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kC = 64;        // rows per chunk
constexpr int kPT = 32;       // state rows (head_dim) per block
constexpr int kThreads = 256;
constexpr int kMaxN = 128;    // d_state: four columns of 32 per lane
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

size_t smem_bytes(int n) {
  const size_t ns = n + 1;
  return sizeof(float) * (2 * kC * ns          // C, B (B later scaled by w)
                          + kC * kPT            // x
                          + kC * (kC + 1)       // M = (C B^T) * L * dt
                          + kPT * ns            // the state tile
                          + 4 * kC);            // cum, dt, w, exp(cum)
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dA,
                const float* __restrict__ dt, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ h0,
                T* __restrict__ y, float* __restrict__ hout, int H, int G, int S,
                int P, int N) {
  extern __shared__ float smem[];
  const int ns = N + 1;
  float* cs = smem;                   // kC x ns
  float* bs = cs + kC * ns;           // kC x ns
  float* xs = bs + kC * ns;           // kC x kPT
  float* ms = xs + kC * kPT;          // kC x (kC + 1)
  float* hs = ms + kC * (kC + 1);     // kPT x ns
  float* cum = hs + kPT * ns;         // kC
  float* dts = cum + kC;              // kC
  float* ws = dts + kC;               // kC
  float* ecum = ws + kC;              // kC

  const int p0 = blockIdx.x * kPT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int pn = min(kPT, P - p0);    // state rows of this tile
  const long long bh = (long long)b * H + h;
  const long long bg = (long long)b * G + h / (H / G);
  const T* xb = x + bh * S * P;
  T* yb = y + bh * S * P;
  const float* dAb = dA + bh * S;
  const float* dtb = dt + bh * S;
  const T* Bb = Bm + bg * S * N;
  const T* Cb = Cm + bg * S * N;
  const long long hrow = bh * P + p0;   // first state row of the tile

  const int tid = threadIdx.x;
  const int sy = tid / 16, sx = tid % 16;      // C B^T and y tiles
  const int warp = tid / 32, lane = tid % 32;  // state-update tile

  for (int e = tid; e < kPT * N; e += kThreads) {
    const int p = e / N, n = e % N;
    hs[p * ns + n] =
        (h0 != nullptr && p < pn) ? h0[(hrow + p) * N + n] : 0.0f;
  }

  for (int c0 = 0; c0 < S; c0 += kC) {
    const int valid = min(kC, S - c0);
    __syncthreads();  // the previous chunk is no longer read
    for (int e = tid; e < kC * N; e += kThreads) {
      const int r = e / N, n = e % N;
      const bool in = r < valid;
      const long long gi = (long long)(c0 + r) * N + n;
      cs[r * ns + n] = in ? to_f(Cb[gi]) : 0.0f;
      bs[r * ns + n] = in ? to_f(Bb[gi]) : 0.0f;
    }
    for (int e = tid; e < kC * kPT; e += kThreads) {
      const int r = e / kPT, p = e % kPT;
      xs[e] = (r < valid && p < pn) ? to_f(xb[(long long)(c0 + r) * P + p0 + p])
                                    : 0.0f;
    }
    if (tid < kC) {
      cum[tid] = tid < valid ? dAb[c0 + tid] : 0.0f;
      dts[tid] = tid < valid ? dtb[c0 + tid] : 0.0f;
    }
    __syncthreads();
    if (tid == 0) {  // 64 adds: negligible beside the chunk's products
      float run = 0.0f;
      for (int r = 0; r < kC; ++r) {
        run += cum[r];
        cum[r] = run;
      }
    }
    __syncthreads();
    const float last = cum[valid - 1];

    // M = (C B^T) * L * dt, exp only on and below the diagonal
    {
      float sc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = cs[(sy + 16 * i) * ns + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = bs[(sx + 16 * j) * ns + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(cv[i], bv[j], sc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = sy + 16 * i, c = sx + 16 * j;
          ms[r * (kC + 1) + c] =
              r >= c ? sc[i][j] * expf(cum[r] - cum[c]) * dts[c] : 0.0f;
        }
      }
      if (tid < kC) {
        ws[tid] = expf(last - cum[tid]) * dts[tid];
        ecum[tid] = expf(cum[tid]);
      }
    }
    __syncthreads();

    // B <- B * w for the state update (y does not read B)
    for (int e = tid; e < kC * N; e += kThreads) {
      const int r = e / N, n = e % N;
      bs[r * ns + n] *= ws[r];
    }
    // y = M x + exp(cum) * (C h^T): rows sy + 16 i, state rows sx, sx + 16
    {
      float acc[4][2], off[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = off[i][0] = off[i][1] = 0.0f;
      for (int j = 0; j < valid; ++j) {
        const float x0 = xs[j * kPT + sx], x1 = xs[j * kPT + sx + 16];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float m = ms[(sy + 16 * i) * (kC + 1) + j];
          acc[i][0] = fmaf(m, x0, acc[i][0]);
          acc[i][1] = fmaf(m, x1, acc[i][1]);
        }
      }
      for (int n = 0; n < N; ++n) {
        const float h0v = hs[sx * ns + n], h1v = hs[(sx + 16) * ns + n];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float c = cs[(sy + 16 * i) * ns + n];
          off[i][0] = fmaf(c, h0v, off[i][0]);
          off[i][1] = fmaf(c, h1v, off[i][1]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = sy + 16 * i;
        if (r >= valid) continue;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int p = sx + 16 * k;
          if (p < pn)
            yb[(long long)(c0 + r) * P + p0 + p] = from_f<T>(acc[i][k] + ecum[r] * off[i][k]);
        }
      }
    }
    __syncthreads();

    // h <- h * exp(cum_last) + x^T (B * w): state rows warp * 4 + i,
    // columns lane + 32 j
    {
      const float decay = expf(last);
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
      for (int r = 0; r < valid; ++r) {
        float xv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = xs[r * kPT + warp * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = lane + 32 * j;
          bv[j] = n < N ? bs[r * ns + n] : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = warp * 4 + i, n = lane + 32 * j;
          if (n < N) hs[p * ns + n] = hs[p * ns + n] * decay + acc[i][j];
        }
      }
    }
  }

  __syncthreads();
  for (int e = tid; e < pn * N; e += kThreads) {
    const int p = e / N, n = e % N;
    hout[(hrow + p) * N + n] = hs[p * ns + n];
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* dA, const float* dt, const void* Bm,
                   const void* Cm, const float* h0, void* y, float* hout, int batch,
                   int heads, int groups, int s, int p, int n, cudaStream_t stream) {
  const size_t smem = smem_bytes(n);
  if (smem > (size_t)kDefaultSmemLimit) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((p + kPT - 1) / kPT, heads, batch);
  ssd_scan_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dA, dt, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), h0, static_cast<T*>(y), hout, heads, groups, s, p, n);
  return cudaGetLastError();
}

}  // namespace

// x, y: (batch, heads, s, p); dA, dt: (batch, heads, s) f32; Bm, Cm:
// (batch, groups, s, n); h0 (or null), hout: (batch, heads, p, n) f32.
// x, y, Bm and Cm all f32 (is_bf16 = 0) or all bf16 (is_bf16 = 1); all
// contiguous, on the current device; n <= 128, groups dividing heads.
extern "C" int ssd_scan_fwd(const void* x, const float* dA, const float* dt,
                            const void* Bm, const void* Cm, const float* h0, void* y,
                            float* hout, int batch, int heads, int groups, int s, int p,
                            int n, int is_bf16, void* stream) {
  if (batch <= 0 || heads <= 0 || s <= 0 || p <= 0) return (int)cudaSuccess;
  if (n <= 0 || n > kMaxN || groups <= 0 || heads % groups) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(x, dA, dt, Bm, Cm, h0, y, hout, batch, heads, groups,
                                      s, p, n, st)
              : launch<float>(x, dA, dt, Bm, Cm, h0, y, hout, batch, heads, groups, s, p, n,
                              st);
  return (int)err;
}
