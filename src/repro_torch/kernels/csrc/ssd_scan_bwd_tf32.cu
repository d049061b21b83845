// Mamba-2 SSD chunked scan, backward, on Hopper's tensor cores at f32
// accuracy (sm_90a): the f32 path at head dim 64 and d_state 128,
// mamba2's shape.
//
// The Pallas TPU kernel `ssd_scan` (src/repro/kernels/ssd_scan.py:65) has
// no backward: the reference trains through `ssd_chunked`
// (src/repro/models/ssd.py:63), which XLA differentiates.  This is the
// gradient of ssd_scan_tf32.cu (the same function as `ssd_scan`):
//   x, dy (B, H, S, 64), Bm and Cm (B, G, S, 128) f32 with G dividing H,
//   dA and dt (B, H, S) f32, h0 and dh (B, H, 64, 128) f32 or none
//   -> dx (B, H, S, 64), dB and dC (B, G, S, 128), ddA, ddt (B, H, S),
//      dh0 (B, H, 64, 128) or none, all f32.
// bf16 inputs take ssd_scan_bwd_wgmma.cu, other shapes the CUDA-core
// kernel of ssd_scan_bwd.cu (the first design); the wrapper picks the
// path from dtype and shape alone.  The arithmetic is
// ssd_scan_bwd_wgmma.cu's and ref.ssd_scan_bwd_ref's: per chunk of 64
// rows, with cum the within-chunk cumulative sum of dA, L its last row,
// h_in the state entering the chunk and g the gradient by the state
// leaving it,
//   h_c = e^{cum_L} h_{c-1} + (x w)^T B,  w_j = e^{cum_L - cum_j} dt_j
//   g_{c-1} = e^{cum_L} g_c + (dy e^{cum})^T C,  dh0 = g_{-1}
//   W_ij = (C_i . B_j) e^{cum_i - cum_j} dt_j, R_ij = (dy_i . x_j) e^{..} dt_j
//   (i >= j, else 0)
//   dx = W^T dy + w (B g^T),  dC = R B + e^{cum} (dy h_in),
//   dB = R^T C + w (x g)
// and ddt, ddA from the row and column sums of Q = R (C B^T), u =
// rowdot(B, x g), v = rowdot(C, dy h_in) and <g, h_in>.  Every product
// runs on the tensor cores in 3xTF32 (ssd_scan_tf32.cuh: the split, the
// rotated tiles, and why mma.sync rather than wgmma).
//
// What bounds it on this card.  At B 1, H 80, one group, S 3,001 the
// inputs and outputs are some 194 MB in f32 (0.058 ms at 3.35 TB/s) and
// the products the function needs some 35 GFLOP (0.07 ms at TF32's 495
// TFLOP/s), three times that in 3xTF32.  The design also writes and reads
// the two state sets (4 x 123 MB in f32) and the tiles' dB and dC partials
// (61 MB written, read once): 0.17 ms of bytes.
//
// The structure is the bf16 backward's (ssd_scan_bwd_wgmma.cu), in three
// launches on the caller's stream, no atomics (two calls give bitwise the
// same gradients):
//   1. the walks (ssd_walk_tf32_kernel, ssd_scan_tf32.cuh), one block of
//      four warps and a producer warp per (head, batch, quarter of the
//      state's columns, direction): 640 blocks at B 1, H 80.  Forward from
//      h0, writing the state entering each chunk; reverse from dh, writing
//      the gradient by the state leaving each chunk, its last value dh0;
//      both in f32.
//   2. ssd_bwd_tile_tf32_kernel, one block of sixteen warps per (chunk,
//      group, tile of 4 heads); C B^T once per block into shared memory.
//      The tile's heads share B and C, so R B and R^T C are one product
//      each per tile, on R summed over its heads: a quarter of the
//      products a per-head R would take.  Per head every warp does some
//      380 products of m16n8k8 (3 a 3xTF32 product): a 16 x 16 block of
//      P = (dy x^T) * L, whose R = P dt_j it adds into the tile's, with
//      its share of Q's row sums and of the column sums of (C B^T) * P; a
//      16 x 16 block of dx = W^T dy + w (B g^T); then warps 0-7 a 16 x 64
//      share of dC += e^{cum} (dy h_in) (v as it goes) and warps 8-15 of
//      dB += w (x g) (u as it goes).  After the heads, dC += R B and dB
//      += R^T C.  dB and dC stay in registers (32 a thread).  Warp 0 adds
//      the warps' partial sums in a fixed order and turns the rows'
//      vectors into ddt and ddA (finish_rows, hopper_wgmma.cuh).  The
//      block's shared memory (some 200 KB: C, Bm, C B^T, one head's x,
//      dy, h_in and g, and the tile's R) holds one stage, so a head's
//      tiles load while warp 0 finishes the previous head's rows.  (A
//      first version of eight warps, rows i and rows j each forming their
//      own dy x^T at 255 registers a thread, ran no faster than sixteen:
//      the operands' splits and loads, not the warps in flight, set the
//      pace; PERF.md §6.)
//   3. ssd_bwd_tile_sum_tf32_kernel: dB and dC, each group's tile partials
//      summed in tile order.
//
// exp is taken only where i >= j (above the diagonal cum_i - cum_j may
// overflow, and inf * 0 would be NaN).  A ragged last chunk needs no
// special case: rows past S load as zeros, dA = 0 and dt = 0 there leave
// cum at its last row and give those rows no weight, and rows past S are
// not written.  A head tile cut short at a group's end (heads per group
// not a multiple of 4) runs its heads and no more.
//
// Interface: plain C, bound from Python with ctypes.  The entry point
// launches on the caller's stream, allocates nothing (the wrapper passes
// the scratch), does not synchronise, and returns a CUDA error code (0
// on success).

#include <math.h>

#include "ssd_scan_tf32.cuh"

namespace {

constexpr int kHeadTile = 4;         // heads per block of the tile kernel
constexpr int kTileWarps = 16;
constexpr int kTileThreads = 32 * kTileWarps;
constexpr int kCBRow = kC + 8;       // C B^T's rows: read in pattern A and as float2s
constexpr int kBlocks = 4;           // 16-row blocks of a chunk

// Shared memory (floats): C and Bm, C B^T (rows kCBRow apart), x, dy, h_in
// and g of one head, R summed over the tile's heads, every tile in
// kSkewAB (each is read in patterns A and B); then the rows' vectors
// (Rows) and the partial sums the warps leave for warp 0 to add in a
// fixed order.
struct TileLayout {
  static constexpr int kCt = 0;
  static constexpr int kBt = kCt + kC * kN;
  static constexpr int kCB = kBt + kC * kN;
  static constexpr int kX = kCB + kC * kCBRow;
  static constexpr int kDy = kX + kC * kP;
  static constexpr int kH = kDy + kC * kP;
  static constexpr int kG = kH + kP * kN;
  static constexpr int kRs = kG + kP * kN;
  static constexpr int kVec = kRs + kC * kC;         // Rows: 9 vectors of kC, gh[4]
  static constexpr int kRowq = kVec + 9 * kC + 4;    // [kBlocks][kC], by column block
  static constexpr int kS = kRowq + kBlocks * kC;    // [kBlocks][kC], by row block
  static constexpr int kV = kS + kBlocks * kC;       // [2][kC], by column half
  static constexpr int kU = kV + 2 * kC;             // [2][kC], by column half
  static constexpr int kGh = kU + 2 * kC;            // [kTileWarps]
  static constexpr size_t kBytes = 4 * (size_t)(kGh + kTileWarps);
};

// Rows r0, r0 + 8 of a 64-column tile (kSkewAB) as an A fragment over keys
// 8 kk .. 8 kk + 7, split.
__device__ __forceinline__ void rows_frag(const float* s, int r0, int kk, int t,
                                          uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int k0 = 8 * kk + t, k1 = k0 + 4;
  split_frag(s[at<kP, kSkewAB>(r0, k0)], s[at<kP, kSkewAB>(r0 + 8, k0)],
             s[at<kP, kSkewAB>(r0, k1)], s[at<kP, kSkewAB>(r0 + 8, k1)], hi, lo);
}

// tmp (16 x 32) = A S[:, 32 quarter ..]: A rows r0, r0 + 8 of a 64-column
// tile, S a 64 x 128 state tile read K-major (pattern A).
__device__ __forceinline__ void rows_by_state(float (&tmp)[4][4], const float* sa,
                                              const float* ss, int quarter, int r0, int g,
                                              int t) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) tmp[nt][e] = 0.0f;
#pragma unroll 2
  for (int kk = 0; kk < kP / 8; ++kk) {
    uint32_t ahi[4], alo[4];
    rows_frag(sa, r0, kk, t, ahi, alo);
    const int k0 = 8 * kk + t, k1 = k0 + 4;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = 32 * quarter + 8 * nt + g;
      mma_3xtf32(tmp[nt], ahi, alo, ss[at<kN, kSkewAB>(k0, n)], ss[at<kN, kSkewAB>(k1, n)]);
    }
  }
}

// acc (16 x 64, columns 64 half ..) += R B or R^T C: the A operand read
// from R (pattern B for R's rows i, pattern A for R^T's rows j), B a 64 x
// 128 tile read K-major.
template <bool TRANSPOSED>
__device__ __forceinline__ void r_times_wide(float (&acc)[8][4], const float* rs,
                                             const float* sb, int half, int r0, int g,
                                             int t) {
#pragma unroll 2
  for (int kk = 0; kk < kC / 8; ++kk) {
    const int k0 = 8 * kk + t, k1 = k0 + 4;
    uint32_t ahi[4], alo[4];
    if (TRANSPOSED)  // R^T (j, i) = R (i, j)
      split_frag(rs[at<kC, kSkewAB>(k0, r0)], rs[at<kC, kSkewAB>(k0, r0 + 8)],
                 rs[at<kC, kSkewAB>(k1, r0)], rs[at<kC, kSkewAB>(k1, r0 + 8)], ahi, alo);
    else
      split_frag(rs[at<kC, kSkewAB>(r0, k0)], rs[at<kC, kSkewAB>(r0 + 8, k0)],
                 rs[at<kC, kSkewAB>(r0, k1)], rs[at<kC, kSkewAB>(r0 + 8, k1)], ahi, alo);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int n = 64 * half + 8 * nt + g;
      mma_3xtf32(acc[nt], ahi, alo, sb[at<kN, kSkewAB>(k0, n)], sb[at<kN, kSkewAB>(k1, n)]);
    }
  }
}

// One block of sixteen warps per (chunk, group, tile of 4 heads).  The
// heads of a tile share B and C, so their R B and R^T C terms are one
// product each with R summed over the tile's heads, after the heads.  Per
// head, between two barriers:
//   1. every warp a 16 x 16 block of P = (dy x^T) * L (rows i 16 (w % 4),
//      columns j 16 (w / 4)), R = P dt_j added into its block of the
//      tile's R, with its share of Q's row sums, of the column sums of
//      Gm = (C B^T) * P and of Gm's diagonal; and a 16 x 16 block of dx =
//      W^T dy + w (B g^T) (rows j 16 (w % 4), head dims 16 (w / 4)), W^T
//      from C B^T;
//   2. warps 0-7 rows i and half of dC's columns: dC += e^{cum} (dy
//      h_in), v as it goes; warps 8-15 rows j and half of dB's: dB += w
//      (x g), u as it goes; every warp a share of <g, h_in>;
//   3. (the next head's tiles load) warp 0 adds the partial sums in a
//      fixed order and turns the rows' vectors into ddt and ddA.
// Then dC += R B, dB += R^T C.
__global__ void __launch_bounds__(kTileThreads, 1)
ssd_bwd_tile_tf32_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                         const float* __restrict__ Bm, const float* __restrict__ Cm,
                         const float* __restrict__ dA, const float* __restrict__ dt,
                         const float* __restrict__ hin, const float* __restrict__ gout,
                         float* __restrict__ dx, float* __restrict__ ddA,
                         float* __restrict__ ddt, float* __restrict__ part_b,
                         float* __restrict__ part_c, int H, int G, int S, int n_chunks,
                         int tiles_per_group) {
  using L = TileLayout;
  extern __shared__ __align__(16) float smem[];
  const Rows rv(smem + L::kVec);
  const float* sc = smem + L::kCt;
  const float* sb = smem + L::kBt;
  const float* scb = smem + L::kCB;
  const float* sx = smem + L::kX;
  const float* sdy = smem + L::kDy;
  const float* sh = smem + L::kH;
  const float* sg = smem + L::kG;
  float* rs = smem + L::kRs;  // the tile's R, after the heads
  float* rowq_part = smem + L::kRowq;
  float* s_part = smem + L::kS;
  float* v_part = smem + L::kV;
  float* u_part = smem + L::kU;
  float* gh_part = smem + L::kGh;

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
  const int rb = warp & 3, cb = (warp >> 2) & 3;  // part 1's 16 x 16 blocks
  const int r0 = 16 * rb + g;                     // this warp's rows r0, r0 + 8
  const bool rows_j = warp >= 8;                  // part 2: rows j (dB), else rows i (dC)
  const int half = (warp >> 2) & 1;               // part 2: dB's or dC's column half

  auto load_head = [&](int tt) {
    const long long bh = (long long)b * H + h_begin + tt;
    const long long mat = (bh * n_chunks + ci) * (kP * kN);
    load_tile<kP, kSkewAB, kTileThreads>(smem + L::kX, x + (bh * S + c0) * kP, kP, valid, tid);
    load_tile<kP, kSkewAB, kTileThreads>(smem + L::kDy, dy + (bh * S + c0) * kP, kP, valid, tid);
    load_tile<kN, kSkewAB, kTileThreads>(smem + L::kH, hin + mat, kN, kC, tid);
    load_tile<kN, kSkewAB, kTileThreads>(smem + L::kG, gout + mat, kN, kC, tid);
    cp_async_commit();
  };
  load_tile<kN, kSkewAB, kTileThreads>(smem + L::kCt, Cm + (bg * S + c0) * kN, kN, valid, tid);
  load_tile<kN, kSkewAB, kTileThreads>(smem + L::kBt, Bm + (bg * S + c0) * kN, kN, valid, tid);
  load_head(0);
  cp_async_wait<0>();
  __syncthreads();
  if (warp < 8) chunk_cbt<kCBRow, kSkewAB>(sc, sb, smem + L::kCB, warp, lane);

  // dC (rows i) or dB (rows j), columns 64 half + 8 nt + 2t + {0, 1}, of
  // the tile's heads, summed in head order; this warp's 16 x 16 block of
  // R summed over the heads (rows r0, r0 + 8, columns 16 cb + 8 nt + 2t +
  // {0, 1})
  float acc[8][4], rsum[2][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) rsum[nt][e] = 0.0f;

  // warp 0: the previous head's partial sums added, then its ddt and ddA
  auto finish = [&](long long bh) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = lane + 32 * e;
      rv.rowq[r] = ((rowq_part[r] + rowq_part[kC + r]) + rowq_part[2 * kC + r]) +
                   rowq_part[3 * kC + r];
      rv.s[r] = ((s_part[r] + s_part[kC + r]) + s_part[2 * kC + r]) + s_part[3 * kC + r];
      rv.v[r] = v_part[r] + v_part[kC + r];
      rv.u[r] = u_part[r] + u_part[kC + r];
    }
    if (lane < 4)
      rv.gh[lane] = ((gh_part[4 * lane] + gh_part[4 * lane + 1]) + gh_part[4 * lane + 2]) +
                    gh_part[4 * lane + 3];
    __syncwarp();
    finish_rows(rv, ddt, ddA, bh * S + c0, valid, lane);
  };

  // dA and dt of the next head, held by warp 0 while this one computes
  float na0 = 0.f, na1 = 0.f, nt0 = 0.f, nt1 = 0.f;
  auto fetch = [&](int tt) {
    const long long row = ((long long)b * H + h_begin + tt) * S + c0;
    na0 = lane < valid ? dA[row + lane] : 0.f;
    nt0 = lane < valid ? dt[row + lane] : 0.f;
    na1 = 32 + lane < valid ? dA[row + 32 + lane] : 0.f;
    nt1 = 32 + lane < valid ? dt[row + 32 + lane] : 0.f;
  };
  if (tid < 32) fetch(0);

  for (int tt = 0; tt < nh; ++tt) {
    const long long bh = (long long)b * H + h_begin + tt;
    if (tid < 32) {
      if (tt > 0) finish(bh - 1);
      __syncwarp();
      float a0 = na0, a1 = na1;
      rv.dt[lane] = nt0;
      rv.dt[32 + lane] = nt1;
      const float t0 = nt0, t1 = nt1;
      if (tt + 1 < nh) fetch(tt + 1);
      const float last = warp_cumsum(a0, a1, lane);
      rv.cum[lane] = a0;
      rv.cum[32 + lane] = a1;
      rv.w[lane] = expf(last - a0) * t0;
      rv.w[32 + lane] = expf(last - a1) * t1;
      rv.ecum[lane] = expf(a0);
      rv.ecum[32 + lane] = expf(a1);
    }
    cp_async_wait<0>();  // this head's tiles
    __syncthreads();

    // ---- 1a. dx rows j = r0, r0 + 8, head dims 16 cb + 8 nt + 2t + {0, 1}:
    // W^T dy (keys i; W^T (j, i) = C B^T (i, j) e^{cum_i - cum_j} dt_j)
    // + w_j (B g^T) (keys n; B (n, p) = g (p, n), pattern B)
    {
      const float cj0 = rv.cum[r0], cj1 = rv.cum[r0 + 8];
      const float tj0 = rv.dt[r0], tj1 = rv.dt[r0 + 8];
      float o[2][4], bgt[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nt][e] = bgt[nt][e] = 0.0f;
#pragma unroll 2
      for (int kk = 0; kk < kC / 8; ++kk) {
        const int k0 = 8 * kk + t, k1 = k0 + 4;
        const float l0 = rv.cum[k0], l1 = rv.cum[k1];
        const float m00 = k0 >= r0 ? scb[k0 * kCBRow + r0] * expf(l0 - cj0) * tj0 : 0.0f;
        const float m10 = k0 >= r0 + 8 ? scb[k0 * kCBRow + r0 + 8] * expf(l0 - cj1) * tj1 : 0.0f;
        const float m01 = k1 >= r0 ? scb[k1 * kCBRow + r0] * expf(l1 - cj0) * tj0 : 0.0f;
        const float m11 = k1 >= r0 + 8 ? scb[k1 * kCBRow + r0 + 8] * expf(l1 - cj1) * tj1 : 0.0f;
        uint32_t ahi[4], alo[4];
        split_frag(m00, m10, m01, m11, ahi, alo);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int p = 16 * cb + 8 * nt + g;
          mma_3xtf32(o[nt], ahi, alo, sdy[at<kP, kSkewAB>(k0, p)], sdy[at<kP, kSkewAB>(k1, p)]);
        }
      }
#pragma unroll 2
      for (int kk = 0; kk < kN / 8; ++kk) {
        const int k0 = 8 * kk + t, k1 = k0 + 4;
        uint32_t ahi[4], alo[4];
        split_frag(sb[at<kN, kSkewAB>(r0, k0)], sb[at<kN, kSkewAB>(r0 + 8, k0)],
                   sb[at<kN, kSkewAB>(r0, k1)], sb[at<kN, kSkewAB>(r0 + 8, k1)], ahi, alo);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int p = 16 * cb + 8 * nt + g;
          mma_3xtf32(bgt[nt], ahi, alo, sg[at<kN, kSkewAB>(p, k0)], sg[at<kN, kSkewAB>(p, k1)]);
        }
      }
      const float w0 = rv.w[r0], w1 = rv.w[r0 + 8];
      float* dxb = dx + (bh * S + c0) * kP;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int p = 16 * cb + 8 * nt + 2 * t;
        if (r0 < valid)
          *reinterpret_cast<float2*>(dxb + r0 * kP + p) =
              make_float2(fmaf(w0, bgt[nt][0], o[nt][0]), fmaf(w0, bgt[nt][1], o[nt][1]));
        if (r0 + 8 < valid)
          *reinterpret_cast<float2*>(dxb + (r0 + 8) * kP + p) =
              make_float2(fmaf(w1, bgt[nt][2], o[nt][2]), fmaf(w1, bgt[nt][3], o[nt][3]));
      }
    }

    // ---- 1b. P rows i = r0, r0 + 8, columns j = 16 cb + 8 nt + 2t + {0, 1}
    {
      float d[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[nt][e] = 0.0f;
#pragma unroll 2
      for (int kk = 0; kk < kP / 8; ++kk) {
        uint32_t ahi[4], alo[4];
        rows_frag(sdy, r0, kk, t, ahi, alo);
        const int k0 = 8 * kk + t, k1 = k0 + 4;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int j = 16 * cb + 8 * nt + g;
          mma_3xtf32(d[nt], ahi, alo, sx[at<kP, kSkewAB>(j, k0)], sx[at<kP, kSkewAB>(j, k1)]);
        }
      }
      const float ci0 = rv.cum[r0], ci1 = rv.cum[r0 + 8];
      float q[2] = {0.0f, 0.0f}, colsum[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hr = e >> 1;
          const int i = r0 + 8 * hr, j = 16 * cb + 8 * nt + 2 * t + (e & 1);
          if (i >= j) {  // exp only on and below the diagonal
            const float pv = d[nt][e] * expf((hr ? ci1 : ci0) - rv.cum[j]);
            const float gm = scb[i * kCBRow + j] * pv;
            if (j < i) {
              q[hr] = fmaf(gm, rv.dt[j], q[hr]);
              colsum[nt][e & 1] += gm;
            } else {
              rv.diag[j] = gm;
            }
            rsum[nt][e] += pv * rv.dt[j];
          }
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) q[e] = quad_sum(q[e]);
      if (t == 0) {
        rowq_part[cb * kC + r0] = q[0];
        rowq_part[cb * kC + r0 + 8] = q[1];
      }
      // the columns' sums over this warp's 16 rows: lanes of one t hold
      // the same columns
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          float v = colsum[nt][u];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          colsum[nt][u] = v;
        }
      if (g == 0) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int j = 16 * cb + 8 * nt + 2 * t;
          s_part[rb * kC + j] = colsum[nt][0];
          s_part[rb * kC + j + 1] = colsum[nt][1];
        }
      }
    }
    // ---- 2. dC (rows i) or dB (rows j), columns 64 half ..: the state terms
    {
      const float* rowdot = rows_j ? sb : sc;  // u: B . (x g); v: C . (dy h_in)
      const float* scale = rows_j ? rv.w : rv.ecum;
      const float s0 = scale[r0], s1 = scale[r0 + 8];
      float dot[2] = {0.0f, 0.0f};
#pragma unroll
      for (int qh = 0; qh < 2; ++qh) {  // the half's two quarters
        float tmp[4][4];
        rows_by_state(tmp, rows_j ? sx : sdy, rows_j ? sg : sh, 2 * half + qh, r0, g, t);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int hr = e >> 1;
            const int n = 64 * half + 32 * qh + 8 * nt + 2 * t + (e & 1);
            dot[hr] = fmaf(rowdot[at<kN, kSkewAB>(r0 + 8 * hr, n)], tmp[nt][e], dot[hr]);
            acc[4 * qh + nt][e] = fmaf(hr ? s1 : s0, tmp[nt][e], acc[4 * qh + nt][e]);
          }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) dot[e] = quad_sum(dot[e]);
      if (t == 0) {
        float* part = (rows_j ? u_part : v_part) + half * kC;
        part[r0] = dot[0];
        part[r0 + 8] = dot[1];
      }
      // <g, h_in>: the two states share one layout, so element k of one
      // pairs with element k of the other
      float ghp = 0.0f;
#pragma unroll
      for (int k = 4 * tid; k < kP * kN; k += 4 * kTileThreads) {
        const float4 hv = *reinterpret_cast<const float4*>(sh + k);
        const float4 gv = *reinterpret_cast<const float4*>(sg + k);
        ghp = fmaf(hv.x, gv.x, ghp);
        ghp = fmaf(hv.y, gv.y, ghp);
        ghp = fmaf(hv.z, gv.z, ghp);
        ghp = fmaf(hv.w, gv.w, ghp);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ghp += __shfl_xor_sync(0xffffffffu, ghp, off);
      if (lane == 0) gh_part[warp] = ghp;
    }

    __syncthreads();  // every read of this head's tiles and sums is done
    if (tt + 1 < nh) load_head(tt + 1);
  }
  if (tid < 32) finish((long long)b * H + h_begin + nh - 1);

  // ---- dC += R B, dB += R^T C, R summed over the tile's heads
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int j = 16 * cb + 8 * nt + 2 * t;
    *reinterpret_cast<float2*>(rs + at<kC, kSkewAB>(r0, j)) = make_float2(rsum[nt][0], rsum[nt][1]);
    *reinterpret_cast<float2*>(rs + at<kC, kSkewAB>(r0 + 8, j)) =
        make_float2(rsum[nt][2], rsum[nt][3]);
  }
  __syncthreads();
  if (!rows_j) r_times_wide<false>(acc, rs, sb, half, r0, g, t);
  else r_times_wide<true>(acc, rs, sc, half, r0, g, t);

  // this tile's dC (rows i) or dB (rows j) partial, rows below S
  float* part = (rows_j ? part_b : part_c) +
                ((bg * tiles_per_group + blockIdx.y % tiles_per_group) * S + c0) * kN;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int n = 64 * half + 8 * nt + 2 * t;
    if (r0 < valid)
      *reinterpret_cast<float2*>(part + (long long)r0 * kN + n) =
          make_float2(acc[nt][0], acc[nt][1]);
    if (r0 + 8 < valid)
      *reinterpret_cast<float2*>(part + (long long)(r0 + 8) * kN + n) =
          make_float2(acc[nt][2], acc[nt][3]);
  }
}

// dB and dC: each group's tile partials summed in tile order.
__global__ void __launch_bounds__(256)
ssd_bwd_tile_sum_tf32_kernel(const float4* __restrict__ part_b, const float4* __restrict__ part_c,
                             float4* __restrict__ dB, float4* __restrict__ dC,
                             long long per_group, long long total, int tiles) {
  // in units of four floats: per_group = S N / 4 of one (batch, group);
  // tile r of group bg is plane bg tiles + r
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const long long bg = e / per_group, off = e % per_group;
    const long long first = bg * tiles * per_group + off;
    float4 sb = make_float4(0.f, 0.f, 0.f, 0.f), sc = sb;
    for (int r = 0; r < tiles; ++r) {
      const float4 a = part_b[first + r * per_group], c = part_c[first + r * per_group];
      sb.x += a.x, sb.y += a.y, sb.z += a.z, sb.w += a.w;
      sc.x += c.x, sc.y += c.y, sc.z += c.z, sc.w += c.w;
    }
    dB[e] = sb;
    dC[e] = sc;
  }
}

long long align256(long long n) { return (n + 255) / 256 * 256; }

// The scratch's regions, in bytes, each 256-byte aligned: the states
// entering each chunk and the gradients by the states leaving each chunk
// ((batch, heads, chunks, 64, 128) f32 each), and the tiles' dB and dC
// partials ((batch, groups, tiles, s, 128) f32 each).
struct Scratch {
  long long hin, gout, part_b, part_c, total;
  int tiles;
  Scratch(int batch, int heads, int groups, int s) {
    const long long nc = (s + kC - 1) / kC;
    tiles = (heads / groups + kHeadTile - 1) / kHeadTile;
    const long long states = align256((long long)batch * heads * nc * kP * kN * 4);
    const long long parts = align256((long long)batch * groups * tiles * s * kN * 4);
    hin = 0;
    gout = states;
    part_b = 2 * states;
    part_c = part_b + parts;
    total = part_c + parts;
  }
};

}  // namespace

// Bytes of scratch ssd_scan_bwd_tf32 needs for this shape.
extern "C" long long ssd_scan_bwd_tf32_scratch_bytes(int batch, int heads, int groups, int s) {
  if (batch <= 0 || heads <= 0 || groups <= 0 || s <= 0 || heads % groups) return 0;
  return Scratch(batch, heads, groups, s).total;
}

// x, dy, dx: (batch, heads, s, 64) f32; dA, dt, ddA, ddt: (batch, heads, s)
// f32; Bm, Cm, dB, dC: (batch, groups, s, 128) f32; h0, dh (or null), dh0
// (or null): (batch, heads, 64, 128) f32; scratch:
// ssd_scan_bwd_tf32_scratch_bytes.  All contiguous, on the current device;
// x, dy, Bm, Cm and the scratch 16-byte aligned; groups dividing heads.
extern "C" int ssd_scan_bwd_tf32(const float* x, const float* dA, const float* dt,
                                 const float* Bm, const float* Cm, const float* h0,
                                 const float* dy, const float* dh, float* dx, float* ddA,
                                 float* ddt, float* dB, float* dC, float* dh0, void* scratch,
                                 int batch, int heads, int groups, int s, void* stream) {
  if (batch <= 0 || heads <= 0 || s <= 0) return (int)cudaSuccess;
  if (groups <= 0 || heads % groups) return (int)cudaErrorInvalidValue;
  const Scratch sc(batch, heads, groups, s);
  uint8_t* buf = static_cast<uint8_t*>(scratch);
  float* hin = reinterpret_cast<float*>(buf + sc.hin);
  float* gout = reinterpret_cast<float*>(buf + sc.gout);
  float* part_b = reinterpret_cast<float*>(buf + sc.part_b);
  float* part_c = reinterpret_cast<float*>(buf + sc.part_c);
  const int n_chunks = (s + kC - 1) / kC;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = launch_walk(x, dy, Bm, Cm, dA, dt, h0, dh, hin, gout, nullptr, dh0, batch,
                                heads, groups, s, n_chunks, 2, st);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ssd_bwd_tile_tf32_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)TileLayout::kBytes);
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_tile_tf32_kernel<<<dim3(n_chunks, groups * sc.tiles, batch), kTileThreads,
                             TileLayout::kBytes, st>>>(x, dy, Bm, Cm, dA, dt, hin, gout, dx, ddA,
                                                       ddt, part_b, part_c, heads, groups, s,
                                                       n_chunks, sc.tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long per_group = (long long)s * kN / 4;
  const long long total = (long long)batch * groups * per_group;
  const long long blocks = (total + 255) / 256;
  ssd_bwd_tile_sum_tf32_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, st>>>(
      reinterpret_cast<const float4*>(part_b), reinterpret_cast<const float4*>(part_c),
      reinterpret_cast<float4*>(dB), reinterpret_cast<float4*>(dC), per_group, total, sc.tiles);
  return (int)cudaGetLastError();
}
