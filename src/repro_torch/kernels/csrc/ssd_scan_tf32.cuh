// The Mamba-2 SSD scan's f32 tensor-core building blocks, shared by the
// forward (ssd_scan_tf32.cu) and the backward (ssd_scan_bwd_tf32.cu) at
// head dim 64 and d_state 128: 3xTF32 products on mma.sync, f32 tiles in
// shared memory with their rows rotated so that the fragment loads fall on
// distinct banks, and the chunk walk that both directions share.
//
// 3xTF32 (tf32_mma.cuh): each f32 operand x goes to the tensor cores as
// hi = tf32(x) and lo = tf32(x - hi), a product as lo_a hi_b + hi_a lo_b
// + hi_a hi_b summed in f32.  The dropped lo_a lo_b and the rounding of
// lo leave some 2^-22 of a product where one TF32 product would leave
// 2^-11 (ref.ssd_scan_ref and ref.ssd_scan_bwd_ref with split="tf32"
// model this rounding on the CPU).
//
// mma.sync m16n8k8 (TF32), fragments loaded by the threads, and not wgmma:
// wgmma reads TF32 operands only K-major from shared memory (the
// transpose bit is for 16-bit types), and an operand it reads from shared
// memory must already be split there.  Here half the products take an
// operand MN-major (B in (x w)^T B and R B, x in M x, C in R^T C, dy in
// W^T dy), so a wgmma design would transpose those tiles and store each
// tile twice, hi and lo, on its way in: 64 KB for a 64 x 128 f32 state
// instead of 32 KB.  mma.sync takes both operands from registers: every
// tile is staged once, as f32, each warp splits the values it loads, and
// a tile read K-major or MN-major is the same tile read at other
// addresses.  An accumulator serves as the next product's A operand with
// no shuffle, by pairing logical k = t with column 2t and k = t + 4 with
// column 2t + 1 (the B operand's rows take the same pairing), as in
// flash_attention_tf32.cu.
//
// Fragment layout of mma.m16n8k8 (g = lane / 4, t = lane % 4): A (16 x
// 8) a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B (8 x
// 8) b0 (t, g), b1 (t + 4, g); C (16 x 8) c0 (g, 2t), c1 (g, 2t + 1), c2
// (g + 8, 2t), c3 (g + 8, 2t + 1).
//
// Rotated tiles.  A warp reads a tile in one of three patterns: rows t
// (+ 4) at columns g ("A": a B operand read K-major, or an A operand read
// transposed), rows g at columns t (+ 4) ("B": an A operand, or a B
// operand read MN-major), and rows 2t, 2t + 1 at columns g (the paired B
// operand after an accumulator).  Row r of a W-column tile is stored
// rotated by skew(r) floats, a multiple of 4 (so a 16-byte copy lands
// whole): element (r, c) at r W + (c + skew(r)) mod W.  kSkewB, 4 (r mod
// 8), puts patterns B and the paired one on 32 distinct banks; kSkewAB,
// 8 (r mod 4) + 4 ((r / 4) mod 2), patterns A and B (no one skew serves
// all three).  Tiles arrive by cp.async, 16 bytes a thread at a time,
// rows past S filled with zeros.

#pragma once

#include "hopper_wgmma.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kC = 64;   // rows per chunk
constexpr int kP = 64;   // head dim
constexpr int kN = 128;  // d_state

// The A fragment (a0, a1, a2, a3) as hi and lo parts.
__device__ __forceinline__ void split_frag(float a0, float a1, float a2, float a3,
                                           uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_tf32(a0, hi[0], lo[0]);
  split_tf32(a1, hi[1], lo[1]);
  split_tf32(a2, hi[2], lo[2]);
  split_tf32(a3, hi[3], lo[3]);
}

// 16 bytes global -> shared, zero-filled when `valid` is false (src is then
// not read, but stays a valid address).
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

enum Skew { kSkewB = 0, kSkewAB = 1 };

// Offset of element (r, c) of a rotated tile of W columns (W a power of
// two, at least 32).
template <int W, int K>
__device__ __forceinline__ int at(int r, int c) {
  const int s = K == kSkewB ? 4 * (r & 7) : 8 * (r & 3) + 4 * ((r >> 2) & 1);
  return r * W + ((c + s) & (W - 1));
}

// Rows [0, 64) of W columns from src (rows `stride` floats apart) into a
// rotated tile, by THREADS threads; rows at or past `valid` are zeros.
template <int W, int K, int THREADS>
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long stride,
                                          int valid, int tid) {
  constexpr int kUnits = kC * W / 4;
#pragma unroll 4
  for (int u = tid; u < kUnits; u += THREADS) {
    const int r = u / (W / 4), c = 4 * (u % (W / 4));
    const bool in = r < valid;
    cp_async16(dst + at<W, K>(r, c), src + (in ? r * stride + c : 0), in);
  }
}

// ---------------------------------------------------------------------------
// The chunk walk, both directions
// ---------------------------------------------------------------------------

constexpr int kNS = 32;  // state columns per walk block
constexpr int kWalkBlocks = kN / kNS;  // walk blocks per (head, direction)
constexpr int kWalkWarps = 4;                       // consumers: 16 state rows each
constexpr int kWalkThreads = 32 * (kWalkWarps + 1);  // and one producer warp

// Shared memory (floats): two stages of (x or dy tile, the block's Bm or
// Cm columns), then the row weights and the decay of each stage.
struct WalkLayout {
  static constexpr int kA = kC * kP;
  static constexpr int kStage = kA + kC * kNS;
  static constexpr int kW = 2 * kStage;       // float w[2][kC]
  static constexpr int kDecay = kW + 2 * kC;  // float decay[2]
  static constexpr size_t kBytes = 4 * (size_t)(kDecay + 4);
};

// One block per (head, batch, quarter of the state's 128 columns,
// direction: blockIdx.z / kWalkBlocks).  Forward: h <- e^{cum_L} h + (x w)^T B from
// h0 (or zeros), w = e^{cum_L - cum} dt, writing the state entering each
// chunk to `hin` and the final state to `hout`.  Reverse: g <- e^{cum_L} g
// + (dy e^{cum})^T C from dh (or zeros), chunks in reverse order, writing
// the gradient by the state leaving each chunk to `gout` and its last
// value to `dh0`.  The block's 64 x 32 share of the state lives in
// registers of four warps (16 rows each, 4 accumulators of 16 x 8); each
// chunk's tiles arrive by cp.async into a two-stage ring while the
// previous chunk computes, and a fifth warp scans the next chunk's dA into
// its weights and decay meanwhile, off the chunks' serial path.  States
// are written f32, (batch, heads, chunks, 64, 128); hout and dh0 may be
// null.
__global__ void __launch_bounds__(kWalkThreads, 3)
ssd_walk_tf32_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                     const float* __restrict__ Bm, const float* __restrict__ Cm,
                     const float* __restrict__ dA, const float* __restrict__ dt,
                     const float* __restrict__ h0, const float* __restrict__ dh,
                     float* __restrict__ hin, float* __restrict__ gout,
                     float* __restrict__ hout, float* __restrict__ dh0, int H, int G, int S,
                     int n_chunks) {
  using L = WalkLayout;
  extern __shared__ __align__(16) float smem[];
  float* ws = smem + L::kW;
  float* decay = smem + L::kDecay;

  const int h = blockIdx.x, b = blockIdx.y;
  const int n_base = (blockIdx.z % kWalkBlocks) * kNS;  // this block's state columns
  const bool reverse = blockIdx.z >= kWalkBlocks;
  const float* a_src = reverse ? dy : x;
  const float* m_src = reverse ? Cm : Bm;
  const float* init = reverse ? dh : h0;
  float* states = reverse ? gout : hin;
  float* fin = reverse ? dh0 : hout;
  const long long bh = (long long)b * H + h;
  const long long bg = (long long)b * G + h / (H / G);
  const float* dAb = dA + bh * S;
  const float* dtb = dt + bh * S;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  // step `it` of the walk takes chunk it, or n_chunks - 1 - it in reverse
  auto chunk_of = [&](int it) { return reverse ? n_chunks - 1 - it : it; };
  auto load = [&](int st, int it) {
    if (it < n_chunks) {
      const int ci = chunk_of(it);
      const int valid = min(kC, S - ci * kC);
      float* sa = smem + st * L::kStage;
      const long long row = (long long)ci * kC;
      load_tile<kP, kSkewAB, kWalkThreads>(sa, a_src + (bh * S + row) * kP, kP, valid, tid);
      load_tile<kNS, kSkewAB, kWalkThreads>(sa + L::kA, m_src + (bg * S + row) * kN + n_base,
                                            kN, valid, tid);
    }
    cp_async_commit();  // a group every step, empty past the end
  };
  load(0, 0);
  load(1, 1);

  // accumulator nt: rows p0 and p0 + 8 (state rows), columns n_base + 8 nt
  // + 2t + {0, 1} (state columns)
  const int p0 = 16 * (warp % kWalkWarps) + g;
  float acc[kNS / 8][4];
#pragma unroll
  for (int nt = 0; nt < kNS / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = p0 + 8 * (e >> 1), n = n_base + 8 * nt + 2 * t + (e & 1);
      acc[nt][e] = init != nullptr && warp < kWalkWarps ? init[(bh * kP + p) * kN + n] : 0.0f;
    }

  // the producer: dA and dt of the step after the one it scans, held in
  // registers; step it's weights and decay into slot it % 2
  const bool producer = warp == kWalkWarps;
  float na0 = 0.f, na1 = 0.f, nt0 = 0.f, nt1 = 0.f;
  auto fetch = [&](int it) {
    if (it >= n_chunks) return;
    const int i0 = chunk_of(it) * kC + lane, i1 = i0 + 32;
    na0 = i0 < S ? dAb[i0] : 0.f;
    nt0 = i0 < S ? dtb[i0] : 0.f;
    na1 = i1 < S ? dAb[i1] : 0.f;
    nt1 = i1 < S ? dtb[i1] : 0.f;
  };
  auto produce = [&](int it) {
    float a0 = na0, a1 = na1;
    const float t0 = nt0, t1 = nt1;
    fetch(it + 1);
    const float last = warp_cumsum(a0, a1, lane);
    const int sl = it & 1;
    // forward: w = e^{cum_L - cum} dt; reverse: e^{cum}
    ws[sl * kC + lane] = reverse ? expf(a0) : expf(last - a0) * t0;
    ws[sl * kC + 32 + lane] = reverse ? expf(a1) : expf(last - a1) * t1;
    if (lane == 0) decay[sl] = expf(last);
  };
  if (producer) {
    fetch(0);
    produce(0);
  }

  for (int it = 0; it < n_chunks; ++it) {
    const int st = it & 1;
    const int ci = chunk_of(it);
    cp_async_wait<1>();  // this chunk's tiles (the next chunk's may fly)
    __syncthreads();     // and its weights
    if (producer) {
      if (it + 1 < n_chunks) produce(it + 1);  // into the slot read a step ago
    } else {
      // the state at this chunk's boundary
      float* out = states + (bh * n_chunks + ci) * (kP * kN) + n_base;
#pragma unroll
      for (int nt = 0; nt < kNS / 8; ++nt) {
        const int n = 8 * nt + 2 * t;
        *reinterpret_cast<float2*>(out + p0 * kN + n) = make_float2(acc[nt][0], acc[nt][1]);
        *reinterpret_cast<float2*>(out + (p0 + 8) * kN + n) =
            make_float2(acc[nt][2], acc[nt][3]);
      }
      const float dec = decay[st];
#pragma unroll
      for (int nt = 0; nt < kNS / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] *= dec;

      // A = (a w)^T: row p, key k is a[k][p] w[k]; B = the Bm or Cm tile
      const float* sa = smem + st * L::kStage;
      const float* sm = sa + L::kA;
      const float* w = ws + st * kC;
#pragma unroll 2
      for (int kk = 0; kk < kC / 8; ++kk) {
        const int k0 = 8 * kk + t, k1 = k0 + 4;
        const float w0 = w[k0], w1 = w[k1];
        uint32_t ahi[4], alo[4];
        split_frag(sa[at<kP, kSkewAB>(k0, p0)] * w0, sa[at<kP, kSkewAB>(k0, p0 + 8)] * w0,
                   sa[at<kP, kSkewAB>(k1, p0)] * w1, sa[at<kP, kSkewAB>(k1, p0 + 8)] * w1, ahi,
                   alo);
#pragma unroll
        for (int nt = 0; nt < kNS / 8; ++nt)
          mma_3xtf32(acc[nt], ahi, alo, sm[at<kNS, kSkewAB>(k0, 8 * nt + g)],
                     sm[at<kNS, kSkewAB>(k1, 8 * nt + g)]);
      }
    }
    __syncthreads();  // every warp is done with this stage, the next weights are written
    load(st, it + 2);
  }

  if (fin != nullptr && !producer) {
#pragma unroll
    for (int nt = 0; nt < kNS / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = p0 + 8 * (e >> 1), n = n_base + 8 * nt + 2 * t + (e & 1);
        fin[(bh * kP + p) * kN + n] = acc[nt][e];
      }
  }
}

// Launch the walk: `directions` 1 (forward only) or 2 (both).
cudaError_t launch_walk(const float* x, const float* dy, const float* Bm, const float* Cm,
                        const float* dA, const float* dt, const float* h0, const float* dh,
                        float* hin, float* gout, float* hout, float* dh0, int batch, int heads,
                        int groups, int s, int n_chunks, int directions, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_walk_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)WalkLayout::kBytes);
  if (err != cudaSuccess) return err;
  ssd_walk_tf32_kernel<<<dim3(heads, batch, directions * kWalkBlocks), kWalkThreads,
                         WalkLayout::kBytes, st>>>(x, dy, Bm, Cm, dA, dt, h0, dh, hin, gout, hout,
                                                   dh0, heads, groups, s, n_chunks);
  return cudaGetLastError();
}

// C B^T of a chunk into a 64-row f32 tile of shared memory, rows ROW
// floats apart, by eight warps (`warp` 0-7): warp w takes rows 16 (w % 4)
// .. + 15 and columns 32 (w / 4) .. + 31.  sc, sb: the chunk's C and Bm,
// 64 x 128 tiles rotated by K.
template <int ROW, int K>
__device__ __forceinline__ void chunk_cbt(const float* sc, const float* sb, float* scb, int warp,
                                          int lane) {
  const int g = lane / 4, t = lane % 4;
  const int i0 = 16 * (warp & 3) + g, j_base = 32 * (warp >> 2);
  float cb[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) cb[nt][e] = 0.0f;
#pragma unroll 2
  for (int kk = 0; kk < kN / 8; ++kk) {
    const int k0 = 8 * kk + t, k1 = k0 + 4;
    uint32_t ahi[4], alo[4];
    split_frag(sc[at<kN, K>(i0, k0)], sc[at<kN, K>(i0 + 8, k0)], sc[at<kN, K>(i0, k1)],
               sc[at<kN, K>(i0 + 8, k1)], ahi, alo);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int j = j_base + 8 * nt + g;
      mma_3xtf32(cb[nt], ahi, alo, sb[at<kN, K>(j, k0)], sb[at<kN, K>(j, k1)]);
    }
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int j = j_base + 8 * nt + 2 * t;
    *reinterpret_cast<float2*>(scb + i0 * ROW + j) = make_float2(cb[nt][0], cb[nt][1]);
    *reinterpret_cast<float2*>(scb + (i0 + 8) * ROW + j) = make_float2(cb[nt][2], cb[nt][3]);
  }
}

}  // namespace
