// Mamba-2 SSD chunked scan on Hopper's tensor cores (sm_90a): the bf16
// path at head dim 64 and d_state 128.
//
// Replaces, for bf16 inputs with P = 64 and N = 128, the Pallas TPU kernel
// `ssd_scan` (`_kernel`) of src/repro/kernels/ssd_scan.py:
//   x (B, H, S, P), dA and dt (B, H, S) f32, Bm and Cm (B, G, S, N) with G
//   dividing H (head h reads group h / (H / G)), h0 (B, H, P, N) f32 or
//   none -> y (B, H, S, P) bf16, final state (B, H, P, N) f32.
// Other dtypes and shapes stay on the CUDA-core kernel of ssd_scan.cu; the
// wrapper picks the path from dtype, P and N alone.
//
// The function, in the state-passing form of the Mamba-2 paper
// (arXiv:2405.21060, section 6), per chunk c of 64 rows with cum the
// within-chunk cumulative sum of dA:
//   w = exp(cum_last - cum) * dt,  dS_c = x^T (B * w)          (P x N)
//   h_c = exp(cum_last) h_{c-1} + dS_c,  h_{-1} = h0           (the pass)
//   y = ((C B^T) * L * dt) x + exp(cum) * (C h_{c-1}^T),
//       L[i, j] = exp(cum_i - cum_j) for i >= j, else 0
// The same function as the serial scan; only rounding moves.
//
// What bounds it on this card.  At mamba2-2.7b's serving shapes (H = 80,
// one group, S up to 3,001) the inputs and outputs are some 67 MB, 0.02
// ms at 3.35 TB/s, and the products about 18 GFLOP: on bf16 tensor cores
// (989 TFLOP/s) 0.02 ms too.  The earlier kernel ran every product on
// the CUDA cores in f32 from shared memory and walked the chunks in order
// inside 160 blocks, and was some 80 times slower than these bounds.
//
// What the design does, in two launches on the caller's stream:
//   1. ssd_state_kernel, one warpgroup per (batch, head, half of the
//      state's 128 columns), walks the chunks in order: 160 blocks at the
//      serving shape where one per head would give 80 for 132 SMs.  Its
//      64 x 64 f32 share of the state h is exactly one m64n64 wgmma
//      accumulator, so it lives in the warpgroup's registers; each chunk
//      scales it by exp(cum_last) and accumulates
//      dS_c = (x w)^T B into it as wgmma steps (A = (x w)^T from
//      registers, B = the chunk of Bm, MN-major, from shared memory).  The
//      state entering each chunk is written once, as bf16 high and low
//      parts (hi + lo carries 16 bits of the f32 state), for launch 2:
//      staged in shared memory and stored by TMA, which runs on while the
//      next chunk computes.  (Stored from registers, four bytes a lane,
//      these writes took most of the kernel's time.)
//      Fusing the pass with dS writes the intermediate states once (123 MB
//      at S = 3,001) where a chunk-parallel dS, a pass and the output
//      would write dS, read it, write the states and read them (490 MB).
//      x and Bm arrive by TMA into a two-stage ring, dA and dt of the next
//      chunk are loaded while the current one computes, and the
//      cumulative sum is a warp scan.
//   2. ssd_out_kernel, one warpgroup per (chunk, group, tile of 4 heads):
//      C B^T is computed once per block on wgmma (bf16 x bf16, exact in
//      f32) and shared by the tile's heads; for each head, M = (C B^T) * L
//      * dt in registers, y = M x (M split into bf16 high and low parts,
//      A from registers, x the MN-major B) plus exp(cum) * (C h^T) (h's
//      high and low parts, K-major B), written in bf16.  A head's x and
//      states arrive by TMA while the previous head computes.
// Every product is accumulated in f32.  The values that are not bf16
// inputs (x w, M, the states) are split into two bf16 parts, so each
// product carries about 16 bits where a single bf16 rounding would carry
// 8: the SSM state check of a 64-layer prefill has little room.
//   * exp is taken only where i >= j: above the diagonal cum_i - cum_j may
//     be positive and overflow, and inf * 0 would be NaN;
//   * a ragged last chunk needs no special case: the tensor maps fill
//     rows past S with zeros, dA = 0 and dt = 0 past S leave cum at its
//     last valid row and give those rows no weight, and rows past S are
//     not written.
//
// Interface: plain C, bound from Python with ctypes.  The entry point
// launches on the caller's stream, allocates nothing (the wrapper passes
// the states' scratch), does not synchronise, and returns a CUDA error
// code (0 on success).

#include <math.h>

#include "hopper_wgmma.cuh"

namespace {

constexpr int kC = 64;         // rows per chunk: one warpgroup's M
constexpr int kP = 64;         // head dim
constexpr int kN = 128;        // d_state
constexpr int kThreads = 128;  // one warpgroup
constexpr int kNS = 64;        // state columns per block of the state kernel
constexpr int kHeadTile = 4;   // heads per block of the output kernel

// ssd_state_kernel's shared memory: two stages of (x tile, Bm tile of
// the block's state columns), two buffers of the outgoing state (hi and
// lo planes), then w and the decay of each stage, then the barriers.
struct StateLayout {
  static constexpr uint32_t kX = kC * 128;                 // 64 rows of P bf16
  static constexpr uint32_t kB = kC * 128;                 // one column block
  static constexpr uint32_t kStage = kX + kB;              // 16 KB
  static constexpr uint32_t kPlane = kP * 128;             // 64 rows of kNS bf16
  static constexpr uint32_t kOut = 2 * kStage;             // [2][hi, lo]
  static constexpr uint32_t kW = kOut + 4 * kPlane;        // float w[2][kC]
  static constexpr uint32_t kDecay = kW + 2 * kC * 4;      // float decay[2]
  static constexpr uint32_t kBar = kDecay + 16;            // two barriers
  static constexpr uint32_t kBytes = kBar + 16 + 1024;     // slack to align
};

// ssd_out_kernel's shared memory: C, then two stages of (x tile, state
// tile of 128 rows: hi then lo), Bm aliased over stage 1 until C B^T is
// done; then cum and dt of the current head, then the barriers.
struct OutLayout {
  static constexpr uint32_t kCTile = 2 * kC * 128;         // 16 KB
  static constexpr uint32_t kX = kC * 128;                 // 8 KB
  static constexpr uint32_t kH = 2 * (2 * kP) * 128;       // 32 KB
  static constexpr uint32_t kStage = kX + kH;              // 40 KB
  static constexpr uint32_t kStage0 = kCTile;
  static constexpr uint32_t kCum = kStage0 + 2 * kStage;   // float cum[kC]
  static constexpr uint32_t kDt = kCum + kC * 4;           // float dt[kC]
  static constexpr uint32_t kBar = kDt + kC * 4;           // three barriers
  static constexpr uint32_t kBytes = kBar + 24 + 1024;
};

__global__ void __launch_bounds__(kThreads, 1)
ssd_state_kernel(const __grid_constant__ CUtensorMap tx,
                 const __grid_constant__ CUtensorMap tb,
                 const __grid_constant__ CUtensorMap ths, const float* __restrict__ dA,
                 const float* __restrict__ dt, const float* __restrict__ h0,
                 float* __restrict__ hout, int H, int G, int S, int n_chunks) {
  using L = StateLayout;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - smem_u32(smem_raw));
  float* ws = reinterpret_cast<float*>(gbase + L::kW);
  float* decay = reinterpret_cast<float*>(gbase + L::kDecay);
  const uint32_t full = base + L::kBar;

  const int h = blockIdx.x, b = blockIdx.y;
  const int n_base = blockIdx.z * kNS;  // this block's state columns
  const long long bh = (long long)b * H + h;
  const int bg = b * G + h / (H / G);
  const float* dAb = dA + bh * S;
  const float* dtb = dt + bh * S;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  auto load = [&](int st, int ci) {
    const uint32_t bar = full + 8 * st;
    const uint32_t sx = base + st * L::kStage;
    mbar_expect_tx(bar, L::kStage);
    tma_load_3d(sx, &tx, bar, 0, ci * kC, (int)bh);
    tma_load_3d(sx + L::kX, &tb, bar, n_base, ci * kC, bg);
  };
  if (tid == 0) {
    mbar_init(full, 1);
    mbar_init(full + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int st = 0; st < 2 && st < n_chunks; ++st) load(st, st);
  }

  // accumulator layout: rows r0 and r0 + 8 (state rows p), columns
  // n_base + 8j + cq + {0, 1} (state columns n)
  const int r0 = 16 * warp + lane / 4;
  const int cq = 2 * (lane % 4);
  float acc[kNS / 2];
#pragma unroll
  for (int j = 0; j < kNS / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = r0 + 8 * (e >> 1), n = n_base + 8 * j + cq + (e & 1);
      acc[4 * j + e] = h0 != nullptr ? h0[(bh * kP + p) * kN + n] : 0.0f;
    }
  }

  // dA and dt of the next chunk, held by warp 0 while this one computes
  float na0 = 0.f, na1 = 0.f, nt0 = 0.f, nt1 = 0.f;
  if (warp == 0) {
    na0 = lane < S ? dAb[lane] : 0.f;
    nt0 = lane < S ? dtb[lane] : 0.f;
    na1 = 32 + lane < S ? dAb[32 + lane] : 0.f;
    nt1 = 32 + lane < S ? dtb[32 + lane] : 0.f;
  }

  for (int ci = 0; ci < n_chunks; ++ci) {
    const int st = ci & 1;
    if (warp == 0) {
      float a0 = na0, a1 = na1;
      const float t0 = nt0, t1 = nt1;
      const int n0 = (ci + 1) * kC + lane, n1 = n0 + 32;
      na0 = n0 < S ? dAb[n0] : 0.f;
      nt0 = n0 < S ? dtb[n0] : 0.f;
      na1 = n1 < S ? dAb[n1] : 0.f;
      nt1 = n1 < S ? dtb[n1] : 0.f;
      const float last = warp_cumsum(a0, a1, lane);
      ws[st * kC + lane] = expf(last - a0) * t0;
      ws[st * kC + 32 + lane] = expf(last - a1) * t1;
      if (lane == 0) decay[st] = expf(last);
    }
    __syncthreads();

    // the state entering chunk ci, as bf16 high and low planes, into the
    // out buffer of this parity (its store of chunk ci - 2 has been read)
    {
      uint8_t* hb = gbase + L::kOut + st * 2 * L::kPlane;
#pragma unroll
      for (int j = 0; j < kNS / 8; ++j) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int off = sw_off(r0 + 8 * half, 8 * j + cq);
          uint32_t hi, lo;
          split2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1], hi, lo);
          *reinterpret_cast<uint32_t*>(hb + off) = hi;
          *reinterpret_cast<uint32_t*>(hb + L::kPlane + off) = lo;
        }
      }
      fence_proxy_async();
    }
    const float dec = decay[st];
#pragma unroll
    for (int i = 0; i < kNS / 2; ++i) acc[i] *= dec;

    // A = (x w)^T: rows p = r0, r0 + 8; keys 16 kk + cq + {0, 1, 8, 9}
    const uint32_t sx = base + st * L::kStage;
    const uint8_t* gx = gbase + st * L::kStage;
    const float* w = ws + st * kC;
    mbar_wait(full + 8 * st, (ci >> 1) & 1);
    uint32_t ahi[kC / 16][4], alo[kC / 16][4];
#pragma unroll
    for (int kk = 0; kk < kC / 16; ++kk) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = r0 + 8 * (q & 1);
        const int k = 16 * kk + cq + 8 * (q >> 1);
        split2(sw_at(gx, k, p) * w[k], sw_at(gx, k + 1, p) * w[k + 1], ahi[kk][q],
               alo[kk][q]);
      }
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kC / 16; ++kk) {
      const uint64_t db = sw128_desc(sx + L::kX + kk * 16 * 128, kC * 128, 1024);
      wgmma_rs_tb<kNS>(acc, ahi[kk], db);
      wgmma_rs_tb<kNS>(acc, alo[kk], db);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(ahi);
    fence_regs(alo);

    __syncthreads();  // every warp is done with this stage and wrote h
    if (tid == 0) {
      if (ci + 2 < n_chunks) load(st, ci + 2);
      const uint32_t hb = base + L::kOut + st * 2 * L::kPlane;
      const int mat = (int)(bh * n_chunks + ci);
      tma_store_3d(&ths, hb, n_base, 0, mat);
      tma_store_3d(&ths, hb + L::kPlane, n_base, kP, mat);
      bulk_commit();
      bulk_wait_read<1>();  // the other buffer is free for chunk ci + 1
    }
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");

#pragma unroll
  for (int j = 0; j < kNS / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = r0 + 8 * (e >> 1), n = n_base + 8 * j + cq + (e & 1);
      hout[(bh * kP + p) * kN + n] = acc[4 * j + e];
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
ssd_out_kernel(const __grid_constant__ CUtensorMap tc, const __grid_constant__ CUtensorMap tb,
               const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap th,
               const float* __restrict__ dA, const float* __restrict__ dt,
               __nv_bfloat16* __restrict__ y, int H, int G, int S, int n_chunks,
               int tiles_per_group) {
  using L = OutLayout;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - smem_u32(smem_raw));
  float* cum = reinterpret_cast<float*>(gbase + L::kCum);
  float* dts = reinterpret_cast<float*>(gbase + L::kDt);
  const uint32_t sc = base;
  const uint32_t sb = base + L::kStage0 + L::kStage;  // aliased over stage 1
  const uint32_t full = base + L::kBar;               // stage st: full + 8 st
  const uint32_t cbar = full + 16;

  const int ci = blockIdx.x, b = blockIdx.z;
  const int g = blockIdx.y / tiles_per_group;
  const int hpg = H / G;
  const int h_begin = g * hpg + (blockIdx.y % tiles_per_group) * kHeadTile;
  const int nh = min(kHeadTile, (g + 1) * hpg - h_begin);
  const int c0 = ci * kC;
  const int valid = min(kC, S - c0);
  const int bg = b * G + g;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  auto load_head = [&](int st, int t) {
    const uint32_t bar = full + 8 * st;
    const uint32_t sx = base + L::kStage0 + st * L::kStage;
    const long long bh = (long long)b * H + h_begin + t;
    mbar_expect_tx(bar, L::kStage);
    tma_load_3d(sx, &tx, bar, 0, c0, (int)bh);
#pragma unroll
    for (int c = 0; c < 2; ++c)
      tma_load_3d(sx + L::kX + c * (2 * kP) * 128, &th, bar, c * kColBlock, 0,
                  (int)(bh * n_chunks + ci));
  };
  if (tid == 0) {
    mbar_init(full, 1);
    mbar_init(full + 8, 1);
    mbar_init(cbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(cbar, 2 * L::kCTile);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      tma_load_3d(sc + c * kC * 128, &tc, cbar, c * kColBlock, c0, bg);
      tma_load_3d(sb + c * kC * 128, &tb, cbar, c * kColBlock, c0, bg);
    }
    load_head(0, 0);
  }

  const int r0 = 16 * warp + lane / 4;
  const int cq = 2 * (lane % 4);

  // C B^T (64 x 64) once for the tile's heads
  float cb[kC / 2];
  mbar_wait(cbar, 0);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kN / 16; ++kk) {
    const uint32_t off = (kk / 4) * kC * 128 + (kk % 4) * 32;
    wgmma_ss<kC>(cb, sw128_desc(sc + off, 16, 1024), sw128_desc(sb + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(cb);
  __syncthreads();  // Bm's stage-1 alias is free
  if (tid == 0 && nh > 1) load_head(1, 1);

  float na0 = 0.f, na1 = 0.f, nt0 = 0.f, nt1 = 0.f;
  auto fetch = [&](int t) {
    const long long row = ((long long)b * H + h_begin + t) * S;
    const int i0 = c0 + lane, i1 = i0 + 32;
    na0 = lane < valid ? dA[row + i0] : 0.f;
    nt0 = lane < valid ? dt[row + i0] : 0.f;
    na1 = 32 + lane < valid ? dA[row + i1] : 0.f;
    nt1 = 32 + lane < valid ? dt[row + i1] : 0.f;
  };
  if (warp == 0) fetch(0);

  for (int t = 0; t < nh; ++t) {
    const int st = t & 1;
    const int h = h_begin + t;
    if (warp == 0) {
      float a0 = na0, a1 = na1;
      dts[lane] = nt0;
      dts[32 + lane] = nt1;
      if (t + 1 < nh) fetch(t + 1);
      warp_cumsum(a0, a1, lane);
      cum[lane] = a0;
      cum[32 + lane] = a1;
    }
    __syncthreads();

    // M = (C B^T) * L * dt, split into bf16 parts in the A operand's
    // register layout: keys 16 kk .. 16 kk + 15 are accumulator columns
    // of registers 8 kk .. 8 kk + 7
    uint32_t mhi[kC / 16][4], mlo[kC / 16][4];
    float ec[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) ec[e] = cum[r0 + 8 * e];
#pragma unroll
    for (int kk = 0; kk < kC / 16; ++kk) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = r0 + 8 * (q & 1);
        float m[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int j = 16 * kk + 8 * (q >> 1) + cq + u;
          const float v = cb[8 * kk + 4 * (q >> 1) + 2 * (q & 1) + u];
          m[u] = i >= j ? v * expf(ec[q & 1] - cum[j]) * dts[j] : 0.0f;
        }
        split2(m[0], m[1], mhi[kk][q], mlo[kk][q]);
      }
    }

    const uint32_t sx = base + L::kStage0 + st * L::kStage;
    const uint32_t sh = sx + L::kX;
    mbar_wait(full + 8 * st, (t >> 1) & 1);
    float yacc[kP / 2], off[kP / 2];
#pragma unroll
    for (int i = 0; i < kP / 2; ++i) yacc[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kC / 16; ++kk) {
      const uint64_t db = sw128_desc(sx + kk * 16 * 128, kC * 128, 1024);
      wgmma_rs_tb<kP>(yacc, mhi[kk], db);
      wgmma_rs_tb<kP>(yacc, mlo[kk], db);
    }
#pragma unroll
    for (int part = 0; part < 2; ++part) {
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) {
        const uint32_t o = (kk / 4) * (2 * kP) * 128 + (kk % 4) * 32;
        wgmma_ss<kP>(off, sw128_desc(sc + (kk / 4) * kC * 128 + (kk % 4) * 32, 16, 1024),
                     sw128_desc(sh + o + part * kP * 128, 16, 1024), part > 0 || kk > 0);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(yacc);
    fence_regs(off);
    fence_regs(mhi);
    fence_regs(mlo);

    const float e0 = expf(ec[0]), e1 = expf(ec[1]);
    __nv_bfloat16* yb = y + (((long long)b * H + h) * S + c0) * kP;
#pragma unroll
    for (int j = 0; j < kP / 8; ++j) {
      const int p = 8 * j + cq;
      if (r0 < valid)
        *reinterpret_cast<__nv_bfloat162*>(yb + r0 * kP + p) = __floats2bfloat162_rn(
            yacc[4 * j] + e0 * off[4 * j], yacc[4 * j + 1] + e0 * off[4 * j + 1]);
      if (r0 + 8 < valid)
        *reinterpret_cast<__nv_bfloat162*>(yb + (r0 + 8) * kP + p) = __floats2bfloat162_rn(
            yacc[4 * j + 2] + e1 * off[4 * j + 2], yacc[4 * j + 3] + e1 * off[4 * j + 3]);
    }

    __syncthreads();  // every warp is done with this stage and with cum
    if (tid == 0 && t + 2 < nh) load_head(st, t + 2);
  }
}

}  // namespace

// x, y: (batch, heads, s, 64) bf16; dA, dt: (batch, heads, s) f32; Bm, Cm:
// (batch, groups, s, 128) bf16; h0 (or null), hout: (batch, heads, 64,
// 128) f32; hin: scratch of (batch, heads, ceil(s / 64), 2, 64, 128) bf16.
// All contiguous, 16-byte aligned, on the current device; groups dividing
// heads.
extern "C" int ssd_scan_wgmma_fwd(const void* x, const float* dA, const float* dt,
                                  const void* Bm, const void* Cm, const float* h0, void* y,
                                  float* hout, void* hin, int batch, int heads, int groups,
                                  int s, void* stream) {
  if (batch <= 0 || heads <= 0 || s <= 0) return (int)cudaSuccess;
  if (groups <= 0 || heads % groups) return (int)cudaErrorInvalidValue;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const int n_chunks = (s + kC - 1) / kC;
  CUtensorMap mx, mb, mc, mh, mhs;
  if (!encode_map(enc, &mx, x, batch * heads, s, kP, kC) ||
      !encode_map(enc, &mb, Bm, batch * groups, s, kN, kC) ||
      !encode_map(enc, &mc, Cm, batch * groups, s, kN, kC) ||
      !encode_map(enc, &mh, hin, batch * heads * n_chunks, 2 * kP, kN, 2 * kP) ||
      !encode_map(enc, &mhs, hin, batch * heads * n_chunks, 2 * kP, kN, kP))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)StateLayout::kBytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ssd_out_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)OutLayout::kBytes);
  if (err != cudaSuccess) return (int)err;
  ssd_state_kernel<<<dim3(heads, batch, kN / kNS), kThreads, StateLayout::kBytes, st>>>(
      mx, mb, mhs, dA, dt, h0, hout, heads, groups, s, n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int tiles = (heads / groups + kHeadTile - 1) / kHeadTile;
  ssd_out_kernel<<<dim3(n_chunks, groups * tiles, batch), kThreads, OutLayout::kBytes, st>>>(
      mc, mb, mx, mh, dA, dt, static_cast<__nv_bfloat16*>(y), heads, groups, s, n_chunks,
      tiles);
  return (int)cudaGetLastError();
}
