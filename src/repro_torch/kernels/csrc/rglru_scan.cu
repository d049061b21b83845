// RG-LRU linear recurrence for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `rglru_scan` (`_kernel`) of
// src/repro/kernels/rglru_scan.py:
//   a, b (B, S, W) f32, h0 (B, W) f32 or none -> h (B, S, W) f32,
//   h_t = a_t * h_{t-1} + b_t,  h_{-1} = h0 (zeros when absent).
// Each step is a multiply and then an add, each rounded to f32 (no fused
// multiply-add), so the result is bitwise the plain PyTorch loop's.
//
// What bounds it on this card: bytes.  A step does two flops per channel
// and moves 12 bytes (a and b read, h written), so the least time is
// 12*B*S*W bytes over the 3.35 TB/s of device memory.
//
// What the design does: the recurrence is serial in time and independent
// across the B*W channels, so one thread owns one channel and walks the
// sequence; neighbouring threads own neighbouring w, so each step's loads
// and stores coalesce across a warp.  The loads of U = 8 steps are issued
// before their arithmetic, so they are in flight together instead of each
// waiting behind the previous step's h.  At B = 1 and W = 2,560 that is
// only 2,560 threads, 20 blocks of 128: the card is far from full, and a
// chunked scan over time (per-chunk (prod a, partial h) then a carry pass)
// is the later work that fills it.
//
// Interface: plain C, bound from Python with ctypes.  The entry point
// launches on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ h, int S, int W,
                  long long channels) {
  const long long ch = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (ch >= channels) return;
  const long long bi = ch / W;
  const long long base = bi * S * W + ch % W;
  float hv = h0 != nullptr ? h0[ch] : 0.0f;
  for (int t0 = 0; t0 < S; t0 += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u < S) {
        const long long i = base + (long long)(t0 + u) * W;
        av[u] = a[i];
        bv[u] = b[i];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u < S) {
        hv = __fadd_rn(__fmul_rn(av[u], hv), bv[u]);
        h[base + (long long)(t0 + u) * W] = hv;
      }
    }
  }
}

}  // namespace

// a, b, h: (batch, s, w) f32 contiguous; h0: (batch, w) f32 contiguous or
// null; all on the current device.
extern "C" int rglru_scan_fwd(const float* a, const float* b, const float* h0, float* h,
                              int batch, int s, int w, void* stream) {
  const long long channels = (long long)batch * w;
  if (channels <= 0 || s <= 0) return (int)cudaSuccess;
  const long long blocks = (channels + kThreads - 1) / kThreads;
  rglru_scan_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      a, b, h0, h, s, w, channels);
  return (int)cudaGetLastError();
}
