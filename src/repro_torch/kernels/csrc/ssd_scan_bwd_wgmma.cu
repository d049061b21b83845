// Mamba-2 SSD chunked scan, backward, on Hopper's tensor cores (sm_90a):
// the bf16 path at head dim 64 and d_state 128, mamba2-2.7b's shape.
//
// The Pallas TPU kernel `ssd_scan` (src/repro/kernels/ssd_scan.py:65) has
// no backward: the reference trains through `ssd_chunked`
// (src/repro/models/ssd.py:63), which XLA differentiates.  This is the
// gradient of ssd_scan_wgmma.cu (the same function as `ssd_scan`):
//   x, dy (B, H, S, 64), Bm and Cm (B, G, S, 128) bf16 with G dividing H,
//   dA and dt (B, H, S) f32, h0 and dh (B, H, 64, 128) f32 or none
//   -> dx (B, H, S, 64), dB and dC (B, G, S, 128) bf16, ddA, ddt (B, H,
//      S) f32, dh0 (B, H, 64, 128) f32 or none.
// f32 inputs and every other shape stay on ssd_scan_bwd.cu (the first
// design, on the CUDA cores); the wrapper picks the path from dtype and
// shape alone.  The arithmetic is that file's header, and
// ref.ssd_scan_bwd_ref's: per chunk of 64 rows, with cum the within-chunk
// cumulative sum of dA, L its last row, h_in the state entering the chunk
// and g the gradient by the state leaving it,
//   h_c = e^{cum_L} h_{c-1} + (x w)^T B,  w_j = e^{cum_L - cum_j} dt_j
//   g_{c-1} = e^{cum_L} g_c + (dy e^{cum})^T C,  dh0 = g_{-1}
//   W_ij = (C_i . B_j) e^{cum_i - cum_j} dt_j, R_ij = (dy_i . x_j) e^{..} dt_j
//   (i >= j, else 0)
//   dx = W^T dy + w (B g^T),  dC = R B + e^{cum} (dy h_in),
//   dB = R^T C + w (x g)
// and ddt, ddA from the row and column sums of Q = R (C B^T), u = rowdot(x,
// B g^T) (taken as rowdot(B, x g)), v = rowdot(C, dy h_in) and <g, h_in>.
//
// What bounds it on this card.  At B 1, H 80, one group, S 3,001 the
// inputs and outputs are 99 MB (0.030 ms at 3.35 TB/s) and the products
// the function needs some 28 GFLOP (0.028 ms at bf16's 989 TFLOP/s): the
// two bounds are about equal.  This design does about 50 GFLOP on the
// tensor cores (the hi + lo splits double the products that take an f32
// value, and the chunk walks' and the transposed products are extra), and
// moves about 0.55 GB: the two state sets written once and read once in
// bf16 hi + lo (4 x 123 MB) and the tile partials of dB and dC (61 MB
// written, read once).  Those scratch bytes, 0.17 ms, are its own floor.
//
// The first design's four problems, and what this one does about each:
//   1. every product on the CUDA cores in f32 (67 TFLOP/s): here every
//      product is a warpgroup MMA (wgmma), bf16 operands fed by TMA in the
//      128-byte swizzle, summed in f32;
//   2. 1.5 GB of f32 scratch a call (the chunks' state terms written, the
//      passes' read and rewrite, the main kernel's read, per-head
//      partials): here one launch walks the chunks both ways and writes
//      each state set once, as bf16 hi + lo, and the chunk kernel reads
//      each once;
//   3. the passes were one thread per state element, serial over the
//      chunks with a load's latency each step: here the walk keeps a 64 x
//      64 share of the state in a warpgroup's wgmma accumulator, the
//      chunks' tiles arrive by TMA into a two-stage ring, and the next
//      chunk's dA and dt are loaded while this one computes;
//   4. dB and dC were written once per head (80 planes at H 80, G 1) and
//      summed in a fourth launch: here a block sums the partials of its
//      tile of 4 heads in registers, in head order, so 20 planes are
//      written and summed.
//
// Three launches on the caller's stream, no atomics (two calls give
// bitwise the same gradients):
//   1. ssd_bwd_walk_kernel, one warpgroup per (head, batch, half of the
//      state's 128 columns, direction): 320 blocks at B 1, H 80.  Forward:
//      h <- e^{cum_L} h + (x w)^T B from h0, writing the state entering
//      each chunk.  Reverse: g <- e^{cum_L} g + (dy e^{cum})^T C from dh,
//      writing the gradient by the state leaving each chunk; its last
//      value is dh0 (f32).  As ssd_state_kernel of ssd_scan_wgmma.cu: A =
//      (x w)^T or (dy e^{cum})^T split into hi + lo from registers, B or C
//      the MN-major B operand; each state staged in shared memory as bf16
//      hi + lo planes and stored by TMA while the next chunk computes.
//   2. ssd_bwd_tile_kernel, one block per (chunk, group, tile of 4
//      heads), two warpgroups.  Once per block C B^T (warpgroup 0) and
//      B C^T (warpgroup 1), exact in f32 from bf16, kept in registers.  Per
//      head: warpgroup 0 takes the row layout (rows i): dy x^T, R and Q's
//      row sums, dC += R B and e^{cum} (dy h_in), v and <g, h_in>;
//      warpgroup 1 the transposed layout (rows j): x dy^T, R^T and the
//      column sums of Q (ddt), dB += R^T C and w (x g), u, then W^T from
//      B C^T and dx = W^T dy + w (B g^T).  Warp 0 turns the rows' sums into ddt and ddA (a
//      fixed-order warp scan) while the next head loads.  A head's x, dy
//      and both states arrive by TMA while the previous head computes.
//   3. ssd_bwd_tile_sum_kernel: dB and dC, each group's tile partials
//      summed in tile order and rounded to bf16.
//
// Registers: dB and dC for the 4 heads of a tile are two 64 x 128 f32
// accumulators, 128 registers a thread in one warpgroup.  They are split
// over the two consumer warpgroups, dC in warpgroup 0 and dB in warpgroup
// 1, each beside its 64 x 64 C B^T or B C^T (32 registers); a head's
// products run one commit group at a time, each group with at most one
// 64 x 128 and two 64 x 64 temporaries beside them.  One block of 256
// threads an SM (its shared memory, some 195 KB, allows no second), at
// the 255-register ceiling with a few hundred bytes spilled: folding each
// 64 x 128 product into the accumulator before the 64 x 64 products
// start spilled as much and ran slower, its commit groups serialised.
//
// Numerics: every product sums in f32; the values that are not bf16
// inputs (x w, dy e^{cum}, R, R^T, W^T, the states) go in as bf16 hi + lo
// (split2), which carries about 16 bits where one bf16 rounding would
// carry 8 (ref.ssd_scan_bwd_ref(..., split=True) models this rounding).
// exp is taken only where i >= j (above the diagonal cum_i - cum_j may
// overflow, and inf * 0 would be NaN).  A ragged last chunk needs no
// special case: the tensor maps fill rows past S with zeros, dA = 0 and
// dt = 0 there leave cum at its last row and give those rows no weight,
// and rows past S are not written.  A head tile cut short at a group's
// end (heads per group not a multiple of 4) runs its heads and no more.
//
// Interface: plain C, bound from Python with ctypes.  The entry point
// launches on the caller's stream, allocates nothing (the wrapper passes
// the scratch), does not synchronise, and returns a CUDA error code (0
// on success).

#include <math.h>

#include "hopper_wgmma.cuh"

namespace {

constexpr int kC = 64;        // rows per chunk: one warpgroup's M
constexpr int kP = 64;        // head dim
constexpr int kN = 128;       // d_state
constexpr int kNS = 64;       // state columns per walk block
constexpr int kHeadTile = 4;  // heads per block of the tile kernel
constexpr int kWalkThreads = 128;
constexpr int kTileThreads = 256;  // two warpgroups

// D (64 x 128) = A (64 x 16, shared, K-major) B (16 x 128, shared,
// MN-major: the transpose bit), accumulated into d unless scale_d is 0.
__device__ __forceinline__ void wgmma_ss_tb128(float (&d)[64], uint64_t da, uint64_t db,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Element (row r, column c < 128) of a 64 x 128 bf16 tile stored as two
// swizzled column blocks of 64 rows each.
__device__ __forceinline__ float wide_at(const uint8_t* tile, int r, int c) {
  return sw_at(tile + (c / kColBlock) * kC * 128, r, c % kColBlock);
}

// A 64 x 64 f32 accumulator as bf16 high and low parts in the A operand's
// register layout: k-step kk (16 columns) is registers 8kk .. 8kk+7.
__device__ __forceinline__ void split_tile(const float (&a)[kC / 2], uint32_t (&hi)[kC / 16][4],
                                           uint32_t (&lo)[kC / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kC / 16; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      split2(a[8 * kk + 2 * q], a[8 * kk + 2 * q + 1], hi[kk][q], lo[kk][q]);
}

// Accumulator element idx of a 64 x (2 X) tile: row r0 + 8 ((idx / 2) % 2),
// column 8 (idx / 4) + cq + idx % 2.
__device__ __forceinline__ int acc_row(int idx, int r0) { return r0 + 8 * ((idx >> 1) & 1); }
__device__ __forceinline__ int acc_col(int idx, int cq) { return 8 * (idx >> 2) + cq + (idx & 1); }

// ---------------------------------------------------------------------------
// 1. the chunk walks: the states entering each chunk and the gradients by
//    the states leaving each chunk, both as bf16 hi + lo
// ---------------------------------------------------------------------------

// Shared memory: two stages of (x or dy tile, Bm or Cm column block), two
// buffers of the outgoing state (hi and lo planes), then the row weights
// and the decay of each stage, then the barriers.
struct WalkLayout {
  static constexpr uint32_t kA = kC * 128;             // 64 rows of P bf16
  static constexpr uint32_t kB = kC * 128;             // one column block
  static constexpr uint32_t kStage = kA + kB;          // 16 KB
  static constexpr uint32_t kPlane = kP * 128;         // 64 rows of kNS bf16
  static constexpr uint32_t kOut = 2 * kStage;         // [2][hi, lo]
  static constexpr uint32_t kW = kOut + 4 * kPlane;    // float w[2][kC]
  static constexpr uint32_t kDecay = kW + 2 * kC * 4;  // float decay[2]
  static constexpr uint32_t kBar = kDecay + 16;        // two barriers
  static constexpr uint32_t kBytes = kBar + 16 + 1024; // slack to align
};

__global__ void __launch_bounds__(kWalkThreads, 3)
ssd_bwd_walk_kernel(const __grid_constant__ CUtensorMap tx,
                    const __grid_constant__ CUtensorMap tdy,
                    const __grid_constant__ CUtensorMap tb,
                    const __grid_constant__ CUtensorMap tc,
                    const __grid_constant__ CUtensorMap th_store,
                    const __grid_constant__ CUtensorMap tg_store, const float* __restrict__ dA,
                    const float* __restrict__ dt, const float* __restrict__ h0,
                    const float* __restrict__ dh, float* __restrict__ dh0, int H, int G, int S,
                    int n_chunks) {
  using L = WalkLayout;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - smem_u32(smem_raw));
  float* ws = reinterpret_cast<float*>(gbase + L::kW);
  float* decay = reinterpret_cast<float*>(gbase + L::kDecay);
  const uint32_t full = base + L::kBar;

  const int h = blockIdx.x, b = blockIdx.y;
  const int n_base = (blockIdx.z & 1) * kNS;  // this block's state columns
  const bool reverse = blockIdx.z >= 2;       // g from dh, else h from h0
  const CUtensorMap* ta = reverse ? &tdy : &tx;
  const CUtensorMap* tm = reverse ? &tc : &tb;
  const CUtensorMap* ts = reverse ? &tg_store : &th_store;
  const float* init = reverse ? dh : h0;
  const long long bh = (long long)b * H + h;
  const int bg = b * G + h / (H / G);
  const float* dAb = dA + bh * S;
  const float* dtb = dt + bh * S;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // step `it` of the walk takes chunk it, or n_chunks - 1 - it in reverse
  auto chunk_of = [&](int it) { return reverse ? n_chunks - 1 - it : it; };
  auto load = [&](int st, int it) {
    const uint32_t bar = full + 8 * st;
    const uint32_t sa = base + st * L::kStage;
    const int ci = chunk_of(it);
    mbar_expect_tx(bar, L::kStage);
    tma_load_3d(sa, ta, bar, 0, ci * kC, (int)bh);
    tma_load_3d(sa + L::kA, tm, bar, n_base, ci * kC, bg);
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
  for (int i = 0; i < kNS / 2; ++i) {
    const int p = acc_row(i, r0), n = n_base + acc_col(i, cq);
    acc[i] = init != nullptr ? init[(bh * kP + p) * kN + n] : 0.0f;
  }

  // dA and dt of the next chunk, held by warp 0 while this one computes
  float na0 = 0.f, na1 = 0.f, nt0 = 0.f, nt1 = 0.f;
  auto fetch = [&](int it) {
    if (it >= n_chunks) return;
    const int i0 = chunk_of(it) * kC + lane, i1 = i0 + 32;
    na0 = i0 < S ? dAb[i0] : 0.f;
    nt0 = i0 < S ? dtb[i0] : 0.f;
    na1 = i1 < S ? dAb[i1] : 0.f;
    nt1 = i1 < S ? dtb[i1] : 0.f;
  };
  if (warp == 0) fetch(0);

  for (int it = 0; it < n_chunks; ++it) {
    const int st = it & 1;
    const int ci = chunk_of(it);
    if (warp == 0) {
      float a0 = na0, a1 = na1;
      const float t0 = nt0, t1 = nt1;
      fetch(it + 1);
      const float last = warp_cumsum(a0, a1, lane);
      // forward: w = e^{cum_L - cum} dt; reverse: e^{cum}
      ws[st * kC + lane] = reverse ? expf(a0) : expf(last - a0) * t0;
      ws[st * kC + 32 + lane] = reverse ? expf(a1) : expf(last - a1) * t1;
      if (lane == 0) decay[st] = expf(last);
    }
    __syncthreads();

    // the state at this chunk's boundary, as bf16 high and low planes,
    // into the out buffer of this parity (its store of step it - 2 has
    // been read)
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

    // A = (x w)^T or (dy e^cum)^T: rows p = r0, r0 + 8; keys 16 kk + cq +
    // {0, 1, 8, 9}
    const uint32_t sa = base + st * L::kStage;
    const uint8_t* ga = gbase + st * L::kStage;
    const float* w = ws + st * kC;
    mbar_wait(full + 8 * st, (it >> 1) & 1);
    uint32_t ahi[kC / 16][4], alo[kC / 16][4];
#pragma unroll
    for (int kk = 0; kk < kC / 16; ++kk) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = r0 + 8 * (q & 1);
        const int k = 16 * kk + cq + 8 * (q >> 1);
        split2(sw_at(ga, k, p) * w[k], sw_at(ga, k + 1, p) * w[k + 1], ahi[kk][q],
               alo[kk][q]);
      }
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kC / 16; ++kk) {
      const uint64_t db = sw128_desc(sa + L::kA + kk * 16 * 128, kC * 128, 1024);
      wgmma_rs_tb<kNS>(acc, ahi[kk], db);
      wgmma_rs_tb<kNS>(acc, alo[kk], db);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(ahi);
    fence_regs(alo);

    __syncthreads();  // every warp is done with this stage and wrote its state
    if (tid == 0) {
      if (it + 2 < n_chunks) load(st, it + 2);
      const uint32_t hb = base + L::kOut + st * 2 * L::kPlane;
      const int mat = (int)(bh * n_chunks + ci);
      tma_store_3d(ts, hb, n_base, 0, mat);
      tma_store_3d(ts, hb + L::kPlane, n_base, kP, mat);
      bulk_commit();
      bulk_wait_read<1>();  // the other buffer is free for step it + 1
    }
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");

  if (reverse && dh0 != nullptr) {
#pragma unroll
    for (int i = 0; i < kNS / 2; ++i) {
      const int p = acc_row(i, r0), n = n_base + acc_col(i, cq);
      dh0[(bh * kP + p) * kN + n] = acc[i];
    }
  }
}

// ---------------------------------------------------------------------------
// 2. a chunk's gradients for a tile of heads
// ---------------------------------------------------------------------------

// Shared memory: C and Bm (64 x 128 each, two swizzled column blocks),
// then two stages of (x, dy, h_in, g) for one head (each state 64 x 128 in
// two column blocks of 128 rows: hi, then lo), then the rows' vectors,
// then the barriers.
struct TileLayout {
  static constexpr uint32_t kWide = 2 * kC * 128;          // 16 KB
  static constexpr uint32_t kCt = 0;
  static constexpr uint32_t kBt = kWide;
  static constexpr uint32_t kX = kC * 128;                 // 8 KB
  static constexpr uint32_t kColStride = 2 * kP * 128;     // a state's column block
  static constexpr uint32_t kState = 2 * kColStride;       // 32 KB
  static constexpr uint32_t kSx = 0, kSdy = kX, kSh = 2 * kX, kSg = 2 * kX + kState;
  static constexpr uint32_t kStage = 2 * kX + 2 * kState;  // 80 KB
  static constexpr uint32_t kRing = 2 * kWide;
  static constexpr uint32_t kVec = kRing + 2 * kStage;     // float [kVecs][kC]
  static constexpr int kVecs = 9;  // cum, dt, w, e^cum, rowq, v, s, diag, u
  static constexpr uint32_t kGh = kVec + kVecs * kC * 4;   // float gh[4]
  static constexpr uint32_t kBar = kGh + 16;               // three barriers
  static constexpr uint32_t kBytes = kBar + 24 + 1024;
};

__global__ void __launch_bounds__(kTileThreads, 1)
ssd_bwd_tile_kernel(const __grid_constant__ CUtensorMap tc, const __grid_constant__ CUtensorMap tb,
                    const __grid_constant__ CUtensorMap tx,
                    const __grid_constant__ CUtensorMap tdy,
                    const __grid_constant__ CUtensorMap th,
                    const __grid_constant__ CUtensorMap tg, const float* __restrict__ dA,
                    const float* __restrict__ dt, __nv_bfloat16* __restrict__ dx,
                    float* __restrict__ ddA, float* __restrict__ ddt,
                    float* __restrict__ part_b, float* __restrict__ part_c, int H, int G, int S,
                    int n_chunks, int tiles_per_group) {
  using L = TileLayout;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - smem_u32(smem_raw));
  const Rows rv(reinterpret_cast<float*>(gbase + L::kVec));
  const uint32_t sc = base + L::kCt, sb = base + L::kBt;
  const uint8_t* gc = gbase + L::kCt;
  const uint8_t* gb = gbase + L::kBt;
  const uint32_t full = base + L::kBar;  // stage st: full + 8 st
  const uint32_t cbar = full + 16;

  const int ci = blockIdx.x, b = blockIdx.z;
  const int g = blockIdx.y / tiles_per_group;
  const int hpg = H / G;
  const int h_begin = g * hpg + (blockIdx.y % tiles_per_group) * kHeadTile;
  const int nh = min(kHeadTile, (g + 1) * hpg - h_begin);
  const int c0 = ci * kC;
  const int valid = min(kC, S - c0);
  const int bg = b * G + g;
  const int tid = threadIdx.x, wg = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int r0 = 16 * warp + lane / 4;
  const int cq = 2 * (lane % 4);

  auto load_head = [&](int st, int t) {
    const uint32_t bar = full + 8 * st;
    const uint32_t s = base + L::kRing + st * L::kStage;
    const long long bh = (long long)b * H + h_begin + t;
    const int mat = (int)(bh * n_chunks + ci);
    mbar_expect_tx(bar, L::kStage);
    tma_load_3d(s + L::kSx, &tx, bar, 0, c0, (int)bh);
    tma_load_3d(s + L::kSdy, &tdy, bar, 0, c0, (int)bh);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      tma_load_3d(s + L::kSh + c * L::kColStride, &th, bar, c * kColBlock, 0, mat);
      tma_load_3d(s + L::kSg + c * L::kColStride, &tg, bar, c * kColBlock, 0, mat);
    }
  };
  if (tid == 0) {
    mbar_init(full, 1);
    mbar_init(full + 8, 1);
    mbar_init(cbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(cbar, 2 * L::kWide);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      tma_load_3d(sc + c * kC * 128, &tc, cbar, c * kColBlock, c0, bg);
      tma_load_3d(sb + c * kC * 128, &tb, cbar, c * kColBlock, c0, bg);
    }
    load_head(0, 0);
    if (nh > 1) load_head(1, 1);
  }

  // warpgroup 0: C B^T (rows i, columns j); warpgroup 1: B C^T (rows j,
  // columns i); each over N = 128 in eight k-steps, exact in f32
  float cb[kC / 2];
  mbar_wait(cbar, 0);
  {
    const uint32_t s1 = wg == 0 ? sc : sb, s2 = wg == 0 ? sb : sc;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) {
      const uint32_t off = (kk / 4) * kC * 128 + (kk % 4) * 32;
      wgmma_ss<kC>(cb, sw128_desc(s1 + off, 16, 1024), sw128_desc(s2 + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(cb);
  }

  // dC (warpgroup 0) or dB (warpgroup 1) of the tile's heads, summed in
  // head order
  float acc[kN / 2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) acc[i] = 0.0f;

  // dA and dt of the next head, held by warp 0 while this one computes
  float na0 = 0.f, na1 = 0.f, nt0 = 0.f, nt1 = 0.f;
  auto fetch = [&](int t) {
    const long long row = ((long long)b * H + h_begin + t) * S + c0;
    na0 = lane < valid ? dA[row + lane] : 0.f;
    nt0 = lane < valid ? dt[row + lane] : 0.f;
    na1 = 32 + lane < valid ? dA[row + 32 + lane] : 0.f;
    nt1 = 32 + lane < valid ? dt[row + 32 + lane] : 0.f;
  };
  if (tid < 32) fetch(0);

  for (int t = 0; t < nh; ++t) {
    const int st = t & 1;
    const long long bh = (long long)b * H + h_begin + t;
    if (tid < 32) {
      // the previous head's ddt and ddA, before its vectors are replaced
      if (t > 0) finish_rows(rv, ddt, ddA, (bh - 1) * S + c0, valid, lane);
      __syncwarp();
      float a0 = na0, a1 = na1;
      rv.dt[lane] = nt0;
      rv.dt[32 + lane] = nt1;
      const float t0 = nt0, t1 = nt1;
      if (t + 1 < nh) fetch(t + 1);
      const float last = warp_cumsum(a0, a1, lane);
      rv.cum[lane] = a0;
      rv.cum[32 + lane] = a1;
      rv.w[lane] = expf(last - a0) * t0;
      rv.w[32 + lane] = expf(last - a1) * t1;
      rv.ecum[lane] = expf(a0);
      rv.ecum[32 + lane] = expf(a1);
    }
    __syncthreads();

    const uint32_t s = base + L::kRing + st * L::kStage;
    const uint32_t sx = s + L::kSx, sdy = s + L::kSdy, sh = s + L::kSh, sg = s + L::kSg;
    mbar_wait(full + 8 * st, (t >> 1) & 1);

    if (wg == 0) {
      // ---- rows i: DX = dy x^T, R, Q's row sums; dC += R B + e^cum (dy h_in)
      float d[kC / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kP / 16; ++kk)
        wgmma_ss<kC>(d, sw128_desc(sdy + kk * 32, 16, 1024), sw128_desc(sx + kk * 32, 16, 1024),
                     kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(d);
      float q[2] = {0.0f, 0.0f};
      const float ci0 = rv.cum[r0], ci1 = rv.cum[r0 + 8];
#pragma unroll
      for (int idx = 0; idx < kC / 2; ++idx) {
        const int i = acc_row(idx, r0), j = acc_col(idx, cq);
        float r = 0.0f;
        if (i >= j) {  // exp only on and below the diagonal
          r = d[idx] * expf(((idx >> 1) & 1 ? ci1 : ci0) - rv.cum[j]) * rv.dt[j];
          if (j < i) q[(idx >> 1) & 1] = fmaf(cb[idx], r, q[(idx >> 1) & 1]);
        }
        d[idx] = r;
      }
      uint32_t rhi[kC / 16][4], rlo[kC / 16][4];
      split_tile(d, rhi, rlo);
      float tmp[kN / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kC / 16; ++kk) {
        const uint64_t db = sw128_desc(sb + kk * 16 * 128, kC * 128, 1024);
        wgmma_rs_tb<kN>(acc, rhi[kk], db);
        wgmma_rs_tb<kN>(acc, rlo[kk], db);
      }
#pragma unroll
      for (int part = 0; part < 2; ++part)
#pragma unroll
        for (int kk = 0; kk < kP / 16; ++kk)
          wgmma_ss_tb128(tmp, sw128_desc(sdy + kk * 32, 16, 1024),
                         sw128_desc(sh + part * kP * 128 + kk * 16 * 128, L::kColStride, 1024),
                         part > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(tmp);
      fence_regs(rhi);
      fence_regs(rlo);
      float v[2] = {0.0f, 0.0f};
      const float e0 = rv.ecum[r0], e1 = rv.ecum[r0 + 8];
#pragma unroll
      for (int idx = 0; idx < kN / 2; ++idx) {
        const int half = (idx >> 1) & 1;
        v[half] = fmaf(wide_at(gc, acc_row(idx, r0), acc_col(idx, cq)), tmp[idx], v[half]);
        acc[idx] = fmaf(half ? e1 : e0, tmp[idx], acc[idx]);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        q[e] = quad_sum(q[e]);
        v[e] = quad_sum(v[e]);
      }
      if (lane % 4 == 0) {
        rv.rowq[r0] = q[0];
        rv.rowq[r0 + 8] = q[1];
        rv.v[r0] = v[0];
        rv.v[r0 + 8] = v[1];
      }
      // <g, h_in> from the hi + lo planes: the two states share one
      // layout, so 16-byte unit k of h pairs with unit k of g
      {
        const uint8_t* gh = gbase + L::kRing + st * L::kStage + L::kSh;
        const uint8_t* gg = gbase + L::kRing + st * L::kStage + L::kSg;
        float part = 0.0f;
        for (int unit = tid; unit < 2 * kP * 8; unit += 128) {
          const int off = (unit / (kP * 8)) * L::kColStride + (unit % (kP * 8)) * 16;
          const uint4 hh = *reinterpret_cast<const uint4*>(gh + off);
          const uint4 hl = *reinterpret_cast<const uint4*>(gh + off + kP * 128);
          const uint4 ghi = *reinterpret_cast<const uint4*>(gg + off);
          const uint4 glo = *reinterpret_cast<const uint4*>(gg + off + kP * 128);
          const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(&hh);
          const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&hl);
          const __nv_bfloat162* c = reinterpret_cast<const __nv_bfloat162*>(&ghi);
          const __nv_bfloat162* c2 = reinterpret_cast<const __nv_bfloat162*>(&glo);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 x1 = __bfloat1622float2(a[e]), x2 = __bfloat1622float2(a2[e]);
            const float2 y1 = __bfloat1622float2(c[e]), y2 = __bfloat1622float2(c2[e]);
            part = fmaf(x1.x + x2.x, y1.x + y2.x, part);
            part = fmaf(x1.y + x2.y, y1.y + y2.y, part);
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
        if (lane == 0) rv.gh[warp] = part;
      }
    } else {
      // ---- rows j: XD = x dy^T, R^T, Q's column sums; dB += R^T C + w (x g)
      float d[kC / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kP / 16; ++kk)
        wgmma_ss<kC>(d, sw128_desc(sx + kk * 32, 16, 1024), sw128_desc(sdy + kk * 32, 16, 1024),
                     kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(d);
      const float cj[2] = {rv.cum[r0], rv.cum[r0 + 8]};
      const float tj[2] = {rv.dt[r0], rv.dt[r0 + 8]};
      float sum[2] = {0.0f, 0.0f}, dg[2] = {0.0f, 0.0f};
#pragma unroll
      for (int idx = 0; idx < kC / 2; ++idx) {
        const int half = (idx >> 1) & 1;
        const int j = acc_row(idx, r0), i = acc_col(idx, cq);
        float r = 0.0f;
        if (i >= j) {
          const float l = expf(rv.cum[i] - cj[half]);
          const float gm = cb[idx] * d[idx] * l;
          if (i > j) sum[half] += gm;
          else dg[half] = gm;
          r = d[idx] * l * tj[half];
        }
        d[idx] = r;
      }
      uint32_t rhi[kC / 16][4], rlo[kC / 16][4];
      split_tile(d, rhi, rlo);
      float tmp[kN / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kC / 16; ++kk) {
        const uint64_t db = sw128_desc(sc + kk * 16 * 128, kC * 128, 1024);
        wgmma_rs_tb<kN>(acc, rhi[kk], db);
        wgmma_rs_tb<kN>(acc, rlo[kk], db);
      }
#pragma unroll
      for (int part = 0; part < 2; ++part)
#pragma unroll
        for (int kk = 0; kk < kP / 16; ++kk)
          wgmma_ss_tb128(tmp, sw128_desc(sx + kk * 32, 16, 1024),
                         sw128_desc(sg + part * kP * 128 + kk * 16 * 128, L::kColStride, 1024),
                         part > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(tmp);
      fence_regs(rhi);
      fence_regs(rlo);
      float u[2] = {0.0f, 0.0f};
      const float w0 = rv.w[r0], w1 = rv.w[r0 + 8];
#pragma unroll
      for (int idx = 0; idx < kN / 2; ++idx) {
        const int half = (idx >> 1) & 1;
        u[half] = fmaf(wide_at(gb, acc_row(idx, r0), acc_col(idx, cq)), tmp[idx], u[half]);
        acc[idx] = fmaf(half ? w1 : w0, tmp[idx], acc[idx]);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sum[e] = quad_sum(sum[e]);
        dg[e] = quad_sum(dg[e]);
        u[e] = quad_sum(u[e]);
      }
      if (lane % 4 == 0) {
        rv.s[r0] = sum[0];
        rv.s[r0 + 8] = sum[1];
        rv.diag[r0] = dg[0];
        rv.diag[r0 + 8] = dg[1];
        rv.u[r0] = u[0];
        rv.u[r0 + 8] = u[1];
      }

      // ---- dx = W^T dy + w (B g^T), W^T from B C^T
      float m[kC / 2];
#pragma unroll
      for (int idx = 0; idx < kC / 2; ++idx) {
        const int half = (idx >> 1) & 1;
        const int j = acc_row(idx, r0), i = acc_col(idx, cq);
        m[idx] = i >= j ? cb[idx] * expf(rv.cum[i] - cj[half]) * tj[half] : 0.0f;
      }
      split_tile(m, rhi, rlo);
      float o[kP / 2], bgt[kP / 2];
#pragma unroll
      for (int i = 0; i < kP / 2; ++i) o[i] = 0.0f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kC / 16; ++kk) {
        const uint64_t db = sw128_desc(sdy + kk * 16 * 128, kC * 128, 1024);
        wgmma_rs_tb<kP>(o, rhi[kk], db);
        wgmma_rs_tb<kP>(o, rlo[kk], db);
      }
#pragma unroll
      for (int part = 0; part < 2; ++part)
#pragma unroll
        for (int kk = 0; kk < kN / 16; ++kk)
          wgmma_ss<kP>(bgt, sw128_desc(sb + (kk / 4) * kC * 128 + (kk % 4) * 32, 16, 1024),
                       sw128_desc(sg + (kk / 4) * L::kColStride + (kk % 4) * 32 + part * kP * 128,
                                  16, 1024),
                       part > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      fence_regs(bgt);
      fence_regs(rhi);
      fence_regs(rlo);
      __nv_bfloat16* dxb = dx + (bh * S + c0) * kP;
#pragma unroll
      for (int jj = 0; jj < kP / 8; ++jj) {
        const int p = 8 * jj + cq;
        if (r0 < valid)
          *reinterpret_cast<__nv_bfloat162*>(dxb + r0 * kP + p) =
              __floats2bfloat162_rn(fmaf(w0, bgt[4 * jj], o[4 * jj]),
                                    fmaf(w0, bgt[4 * jj + 1], o[4 * jj + 1]));
        if (r0 + 8 < valid)
          *reinterpret_cast<__nv_bfloat162*>(dxb + (r0 + 8) * kP + p) =
              __floats2bfloat162_rn(fmaf(w1, bgt[4 * jj + 2], o[4 * jj + 2]),
                                    fmaf(w1, bgt[4 * jj + 3], o[4 * jj + 3]));
      }
    }

    __syncthreads();  // every warp is done with this stage and wrote its sums
    if (tid == 0 && t + 2 < nh) load_head(st, t + 2);
  }
  if (tid < 32)
    finish_rows(rv, ddt, ddA, ((long long)b * H + h_begin + nh - 1) * S + c0, valid, lane);

  // this tile's dC (warpgroup 0) or dB (warpgroup 1) partial, rows below S
  float* part = (wg == 0 ? part_c : part_b) +
                (((long long)b * G * tiles_per_group + blockIdx.y) * S + c0) * kN;
#pragma unroll
  for (int jj = 0; jj < kN / 8; ++jj) {
    const int n = 8 * jj + cq;
    if (r0 < valid)
      *reinterpret_cast<float2*>(part + (long long)r0 * kN + n) =
          make_float2(acc[4 * jj], acc[4 * jj + 1]);
    if (r0 + 8 < valid)
      *reinterpret_cast<float2*>(part + (long long)(r0 + 8) * kN + n) =
          make_float2(acc[4 * jj + 2], acc[4 * jj + 3]);
  }
}

// ---------------------------------------------------------------------------
// 3. dB and dC: each group's tile partials summed in tile order
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(256)
ssd_bwd_tile_sum_kernel(const float4* __restrict__ part_b, const float4* __restrict__ part_c,
                        __nv_bfloat162* __restrict__ dB, __nv_bfloat162* __restrict__ dC,
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
    dB[2 * e] = __floats2bfloat162_rn(sb.x, sb.y);
    dB[2 * e + 1] = __floats2bfloat162_rn(sb.z, sb.w);
    dC[2 * e] = __floats2bfloat162_rn(sc.x, sc.y);
    dC[2 * e + 1] = __floats2bfloat162_rn(sc.z, sc.w);
  }
}

long long align256(long long n) { return (n + 255) / 256 * 256; }

// The scratch's regions, in bytes, each 256-byte aligned: the states
// entering each chunk and the gradients by the states leaving each chunk
// ((batch, heads, chunks, 2, 64, 128) bf16 each), and the tiles' dB and
// dC partials ((batch, groups, tiles, s, 128) f32 each).
struct Scratch {
  long long hin, gout, part_b, part_c, total;
  int tiles;
  Scratch(int batch, int heads, int groups, int s) {
    const long long nc = (s + kC - 1) / kC;
    tiles = (heads / groups + kHeadTile - 1) / kHeadTile;
    const long long states = align256((long long)batch * heads * nc * 2 * kP * kN * 2);
    const long long parts = align256((long long)batch * groups * tiles * s * kN * 4);
    hin = 0;
    gout = states;
    part_b = 2 * states;
    part_c = part_b + parts;
    total = part_c + parts;
  }
};

}  // namespace

// Bytes of scratch ssd_scan_bwd_wgmma needs for this shape.
extern "C" long long ssd_scan_bwd_wgmma_scratch_bytes(int batch, int heads, int groups, int s) {
  if (batch <= 0 || heads <= 0 || groups <= 0 || s <= 0 || heads % groups) return 0;
  return Scratch(batch, heads, groups, s).total;
}

// x, dy, dx: (batch, heads, s, 64) bf16; dA, dt, ddA, ddt: (batch, heads,
// s) f32; Bm, Cm, dB, dC: (batch, groups, s, 128) bf16; h0, dh (or null),
// dh0 (or null): (batch, heads, 64, 128) f32; scratch:
// ssd_scan_bwd_wgmma_scratch_bytes.  All contiguous, on the current
// device; x, dy, Bm, Cm and the scratch 16-byte aligned; groups dividing
// heads.
extern "C" int ssd_scan_bwd_wgmma(const void* x, const float* dA, const float* dt,
                                  const void* Bm, const void* Cm, const float* h0,
                                  const void* dy, const float* dh, void* dx, float* ddA,
                                  float* ddt, void* dB, void* dC, float* dh0, void* scratch,
                                  int batch, int heads, int groups, int s, void* stream) {
  if (batch <= 0 || heads <= 0 || s <= 0) return (int)cudaSuccess;
  if (groups <= 0 || heads % groups) return (int)cudaErrorInvalidValue;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const Scratch sc(batch, heads, groups, s);
  uint8_t* buf = static_cast<uint8_t*>(scratch);
  void* hin = buf + sc.hin;
  void* gout = buf + sc.gout;
  float* part_b = reinterpret_cast<float*>(buf + sc.part_b);
  float* part_c = reinterpret_cast<float*>(buf + sc.part_c);
  const int n_chunks = (s + kC - 1) / kC;
  const int mats = batch * heads * n_chunks;
  CUtensorMap mx, mdy, mb, mc, mh, mg, mhs, mgs;
  if (!encode_map(enc, &mx, x, batch * heads, s, kP, kC) ||
      !encode_map(enc, &mdy, dy, batch * heads, s, kP, kC) ||
      !encode_map(enc, &mb, Bm, batch * groups, s, kN, kC) ||
      !encode_map(enc, &mc, Cm, batch * groups, s, kN, kC) ||
      !encode_map(enc, &mh, hin, mats, 2 * kP, kN, 2 * kP) ||
      !encode_map(enc, &mg, gout, mats, 2 * kP, kN, 2 * kP) ||
      !encode_map(enc, &mhs, hin, mats, 2 * kP, kN, kP) ||
      !encode_map(enc, &mgs, gout, mats, 2 * kP, kN, kP))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)WalkLayout::kBytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ssd_bwd_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)TileLayout::kBytes);
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_walk_kernel<<<dim3(heads, batch, 2 * (kN / kNS)), kWalkThreads, WalkLayout::kBytes,
                        st>>>(mx, mdy, mb, mc, mhs, mgs, dA, dt, h0, dh, dh0, heads, groups, s,
                              n_chunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_tile_kernel<<<dim3(n_chunks, groups * sc.tiles, batch), kTileThreads,
                        TileLayout::kBytes, st>>>(
      mc, mb, mx, mdy, mh, mg, dA, dt, static_cast<__nv_bfloat16*>(dx), ddA, ddt, part_b,
      part_c, heads, groups, s, n_chunks, sc.tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long per_group = (long long)s * kN / 4;
  const long long total = (long long)batch * groups * per_group;
  const long long blocks = (total + 255) / 256;
  ssd_bwd_tile_sum_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, st>>>(
      reinterpret_cast<const float4*>(part_b), reinterpret_cast<const float4*>(part_c),
      static_cast<__nv_bfloat162*>(dB), static_cast<__nv_bfloat162*>(dC), per_group, total,
      sc.tiles);
  return (int)cudaGetLastError();
}
