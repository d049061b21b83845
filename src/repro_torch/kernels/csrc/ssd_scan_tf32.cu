// Mamba-2 SSD chunked scan on Hopper's tensor cores at f32 accuracy
// (sm_90a): the f32 path at head dim 64 and d_state 128, mamba2's shape.
//
// Replaces, for f32 inputs with P = 64 and N = 128, the Pallas TPU kernel
// `ssd_scan` (`_kernel`) of src/repro/kernels/ssd_scan.py:
//   x (B, H, S, P), dA and dt (B, H, S) f32, Bm and Cm (B, G, S, N) with G
//   dividing H (head h reads group h / (H / G)), h0 (B, H, P, N) f32 or
//   none -> y (B, H, S, P) f32, final state (B, H, P, N) f32.
// bf16 inputs take ssd_scan_wgmma.cu, other shapes the CUDA-core kernel
// of ssd_scan.cu; the wrapper picks the path from dtype, P and N alone.
//
// The function, in the state-passing form of ssd_scan_wgmma.cu, per chunk
// c of 64 rows with cum the within-chunk cumulative sum of dA:
//   w = exp(cum_last - cum) * dt,  dS_c = (x w)^T B              (P x N)
//   h_c = exp(cum_last) h_{c-1} + dS_c,  h_{-1} = h0             (the pass)
//   y = ((C B^T) * L * dt) x + exp(cum) * (C h_{c-1}^T),
//       L[i, j] = exp(cum_i - cum_j) for i >= j, else 0
// Every product runs on the tensor cores in 3xTF32 (ssd_scan_tf32.cuh:
// the split, and why mma.sync rather than wgmma).
//
// What bounds it on this card.  At B 1, H 80, one group, S 3,001 the
// inputs and outputs are some 130 MB in f32, 0.039 ms at 3.35 TB/s; the
// products some 18 GFLOP, 0.036 ms at TF32's 495 TFLOP/s, three times
// that in 3xTF32.  The first design (ssd_scan.cu) ran every product on
// the CUDA cores from shared memory, one block a (batch, head, 32 state
// rows) walking the chunks in order, at 2% of the bound.
//
// What the design does, in two launches on the caller's stream:
//   1. the walk (ssd_walk_tf32_kernel, ssd_scan_tf32.cuh), one block of
//      four warps per (batch, head, quarter of the state's columns): 320
//      blocks at the serving shape, two or three an SM (halves, 160
//      blocks, left one warp a scheduler and ran slower).  Its 64 x 32
//      f32 share of the state stays in registers; each chunk scales it by
//      exp(cum_last) and accumulates dS_c = (x w)^T B into it, so the
//      chunks' dS are never written; a fifth warp scans the next chunk's
//      dA meanwhile.  The state entering each chunk is written once, in
//      f32 (123 MB at S = 3,001), for launch 2.
//   2. ssd_out_tf32_kernel, one block of eight warps per (chunk, group,
//      tile of 4 heads): C B^T computed once for the tile and kept in
//      shared memory; per head, warp w takes rows 16 (w % 4) .. + 15 and
//      head dims 32 (w / 4) .. + 31 of y: exp(cum) (C h^T) first, then
//      + M x with M = (C B^T) * L * dt formed in registers from C B^T and
//      fed as the A operand.  A head's x and state arrive by cp.async
//      while the previous head computes.
//   * exp is taken only where i >= j: above the diagonal cum_i - cum_j may
//     be positive and overflow, and inf * 0 would be NaN;
//   * a ragged last chunk needs no special case: rows past S load as
//     zeros, dA = 0 and dt = 0 past S leave cum at its last valid row and
//     give those rows no weight, and rows past S are not written.
//
// Interface: plain C, bound from Python with ctypes.  The entry point
// launches on the caller's stream, allocates nothing (the wrapper passes
// the states' scratch), does not synchronise, and returns a CUDA error
// code (0 on success).

#include <math.h>

#include "ssd_scan_tf32.cuh"

namespace {

constexpr int kOutThreads = 256;  // eight warps
constexpr int kCBRow = kC + 4;    // C B^T's rows: a warp's float2 reads on distinct banks
constexpr int kHeadTile = 4;      // heads per block of the output kernel

// ssd_out_tf32_kernel's shared memory (floats): C and Bm of the chunk
// (kSkewB), C B^T, two stages of (x tile, state tile), cum and dt.
struct OutLayout {
  static constexpr int kCt = 0;
  static constexpr int kBt = kCt + kC * kN;
  static constexpr int kCB = kBt + kC * kN;
  static constexpr int kRing = kCB + kC * kCBRow;
  static constexpr int kX = 0, kH = kC * kP;       // within a stage
  static constexpr int kStage = kC * kP + kP * kN;
  static constexpr int kCum = kRing + 2 * kStage;  // float cum[kC]
  static constexpr int kDt = kCum + kC;            // float dt[kC]
  static constexpr size_t kBytes = 4 * (size_t)(kDt + kC);
};

__global__ void __launch_bounds__(kOutThreads, 1)
ssd_out_tf32_kernel(const float* __restrict__ x, const float* __restrict__ Bm,
                    const float* __restrict__ Cm, const float* __restrict__ dA,
                    const float* __restrict__ dt, const float* __restrict__ hin,
                    float* __restrict__ y, int H, int G, int S, int n_chunks,
                    int tiles_per_group) {
  using L = OutLayout;
  extern __shared__ __align__(16) float smem[];
  const float* sc = smem + L::kCt;
  const float* sb = smem + L::kBt;
  float* scb = smem + L::kCB;
  float* cum = smem + L::kCum;
  float* dts = smem + L::kDt;

  const int ci = blockIdx.x, b = blockIdx.z;
  const int grp = blockIdx.y / tiles_per_group;
  const int hpg = H / G;
  const int h_begin = grp * hpg + (blockIdx.y % tiles_per_group) * kHeadTile;
  const int nh = min(kHeadTile, (grp + 1) * hpg - h_begin);
  const int c0 = ci * kC;
  const int valid = min(kC, S - c0);
  const long long bg = (long long)b * G + grp;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int i0 = 16 * (warp & 3) + g;  // rows i0, i0 + 8
  const int p_base = 32 * (warp >> 2);  // head dims p_base + 8 nt + 2t + {0, 1}

  auto load_head = [&](int st, int tt) {
    if (tt < nh) {
      const long long bh = (long long)b * H + h_begin + tt;
      float* s = smem + L::kRing + st * L::kStage;
      load_tile<kP, kSkewB, kOutThreads>(s + L::kX, x + (bh * S + c0) * kP, kP, valid, tid);
      load_tile<kN, kSkewB, kOutThreads>(s + L::kH, hin + (bh * n_chunks + ci) * (kP * kN), kN,
                                         kC, tid);
    }
    cp_async_commit();
  };
  load_tile<kN, kSkewB, kOutThreads>(smem + L::kCt, Cm + (bg * S + c0) * kN, kN, valid, tid);
  load_tile<kN, kSkewB, kOutThreads>(smem + L::kBt, Bm + (bg * S + c0) * kN, kN, valid, tid);
  load_head(0, 0);  // one group with C and Bm
  load_head(1, 1);

  cp_async_wait<1>();
  __syncthreads();
  chunk_cbt<kCBRow, kSkewB>(sc, sb, scb, warp, lane);
  __syncthreads();
  // this warp's rows of C B^T, all 64 columns, in the accumulator layout
  float cbr[kC / 8][4];
#pragma unroll
  for (int nt = 0; nt < kC / 8; ++nt) {
    const float2 u = *reinterpret_cast<const float2*>(scb + i0 * kCBRow + 8 * nt + 2 * t);
    const float2 v = *reinterpret_cast<const float2*>(scb + (i0 + 8) * kCBRow + 8 * nt + 2 * t);
    cbr[nt][0] = u.x;
    cbr[nt][1] = u.y;
    cbr[nt][2] = v.x;
    cbr[nt][3] = v.y;
  }

  // dA and dt of the next head, held by warp 0 while this one computes
  float na0 = 0.f, na1 = 0.f, nt0 = 0.f, nt1 = 0.f;
  auto fetch = [&](int tt) {
    const long long row = ((long long)b * H + h_begin + tt) * S + c0;
    na0 = lane < valid ? dA[row + lane] : 0.f;
    nt0 = lane < valid ? dt[row + lane] : 0.f;
    na1 = 32 + lane < valid ? dA[row + 32 + lane] : 0.f;
    nt1 = 32 + lane < valid ? dt[row + 32 + lane] : 0.f;
  };
  if (warp == 0) fetch(0);

  for (int tt = 0; tt < nh; ++tt) {
    const int st = tt & 1;
    const long long bh = (long long)b * H + h_begin + tt;
    if (warp == 0) {
      float a0 = na0, a1 = na1;
      dts[lane] = nt0;
      dts[32 + lane] = nt1;
      if (tt + 1 < nh) fetch(tt + 1);
      warp_cumsum(a0, a1, lane);
      cum[lane] = a0;
      cum[32 + lane] = a1;
    }
    cp_async_wait<1>();  // this head's tiles
    __syncthreads();

    const float* sx = smem + L::kRing + st * L::kStage + L::kX;
    const float* sh = smem + L::kRing + st * L::kStage + L::kH;
    float yacc[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) yacc[nt][e] = 0.0f;

    // C h^T: A = C rows i, keys n; B (n, p) = h[p][n]
#pragma unroll 2
    for (int kk = 0; kk < kN / 8; ++kk) {
      const int k0 = 8 * kk + t, k1 = k0 + 4;
      uint32_t ahi[4], alo[4];
      split_frag(sc[at<kN, kSkewB>(i0, k0)], sc[at<kN, kSkewB>(i0 + 8, k0)],
                 sc[at<kN, kSkewB>(i0, k1)], sc[at<kN, kSkewB>(i0 + 8, k1)], ahi, alo);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int p = p_base + 8 * nt + g;
        mma_3xtf32(yacc[nt], ahi, alo, sh[at<kN, kSkewB>(p, k0)], sh[at<kN, kSkewB>(p, k1)]);
      }
    }
    const float ci0 = cum[i0], ci1 = cum[i0 + 8];
    const float e0 = expf(ci0), e1 = expf(ci1);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      yacc[nt][0] *= e0;
      yacc[nt][1] *= e0;
      yacc[nt][2] *= e1;
      yacc[nt][3] *= e1;
    }

    // + M x: A = M from C B^T (keys j paired: k = t is column 2t, k = t + 4
    // column 2t + 1), B (j, p) = x[j][p]
#pragma unroll
    for (int kk = 0; kk < kC / 8; ++kk) {
      const int j0 = 8 * kk + 2 * t, j1 = j0 + 1;
      const float cj0 = cum[j0], cj1 = cum[j1], tj0 = dts[j0], tj1 = dts[j1];
      const float m00 = i0 >= j0 ? cbr[kk][0] * expf(ci0 - cj0) * tj0 : 0.0f;
      const float m10 = i0 + 8 >= j0 ? cbr[kk][2] * expf(ci1 - cj0) * tj0 : 0.0f;
      const float m01 = i0 >= j1 ? cbr[kk][1] * expf(ci0 - cj1) * tj1 : 0.0f;
      const float m11 = i0 + 8 >= j1 ? cbr[kk][3] * expf(ci1 - cj1) * tj1 : 0.0f;
      uint32_t ahi[4], alo[4];
      split_frag(m00, m10, m01, m11, ahi, alo);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int p = p_base + 8 * nt + g;
        mma_3xtf32(yacc[nt], ahi, alo, sx[at<kP, kSkewB>(j0, p)], sx[at<kP, kSkewB>(j1, p)]);
      }
    }

    float* yb = y + (bh * S + c0) * kP;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int p = p_base + 8 * nt + 2 * t;
      if (i0 < valid)
        *reinterpret_cast<float2*>(yb + i0 * kP + p) = make_float2(yacc[nt][0], yacc[nt][1]);
      if (i0 + 8 < valid)
        *reinterpret_cast<float2*>(yb + (i0 + 8) * kP + p) =
            make_float2(yacc[nt][2], yacc[nt][3]);
    }

    __syncthreads();  // every warp is done with this stage and with cum
    load_head(st, tt + 2);
  }
}

}  // namespace

// x, y: (batch, heads, s, 64) f32; dA, dt: (batch, heads, s) f32; Bm, Cm:
// (batch, groups, s, 128) f32; h0 (or null), hout: (batch, heads, 64, 128)
// f32; hin: scratch of (batch, heads, ceil(s / 64), 64, 128) f32.  All
// contiguous, 16-byte aligned, on the current device; groups dividing
// heads.
extern "C" int ssd_scan_tf32_fwd(const float* x, const float* dA, const float* dt,
                                 const float* Bm, const float* Cm, const float* h0, float* y,
                                 float* hout, float* hin, int batch, int heads, int groups, int s,
                                 void* stream) {
  if (batch <= 0 || heads <= 0 || s <= 0) return (int)cudaSuccess;
  if (groups <= 0 || heads % groups) return (int)cudaErrorInvalidValue;
  const int n_chunks = (s + kC - 1) / kC;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = launch_walk(x, nullptr, Bm, nullptr, dA, dt, h0, nullptr, hin, nullptr,
                                hout, nullptr, batch, heads, groups, s, n_chunks, 1, st);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ssd_out_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)OutLayout::kBytes);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (heads / groups + kHeadTile - 1) / kHeadTile;
  ssd_out_tf32_kernel<<<dim3(n_chunks, groups * tiles, batch), kOutThreads, OutLayout::kBytes,
                        st>>>(x, Bm, Cm, dA, dt, hin, y, heads, groups, s, n_chunks, tiles);
  return (int)cudaGetLastError();
}
