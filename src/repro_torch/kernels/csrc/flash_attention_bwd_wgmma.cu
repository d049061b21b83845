// Attention backward on Hopper's tensor cores (sm_90a): the bf16 path for
// head dims 64, 80 (hubert-xlarge), 128 and 256, and for MLA's q and k of
// head dim 192 with v of head dim 128; the gradient of
// flash_attention_wgmma.cu.
//
// The Pallas TPU kernel `flash_attention` (src/repro/kernels/
// flash_attention.py:77) has no backward: the reference trains through
// `blockwise_attention` (src/repro/models/attention.py:118), which XLA
// differentiates.  This kernel computes what flash_attention_bwd.cu (the
// first design, f32 on the CUDA cores, which keeps f32 inputs and other
// head dims) computes:
//   q (BH, S, D), k (BH / G, S, D), v (BH / G, S, Dv), o, dO (BH, S, Dv)
//   bf16, lse (BH, S) f32
//   -> dq (BH, S, D), dk (BH / G, S, D), dv (BH / G, S, Dv) bf16,
// with the forward's masks (causal, `local` within `window`, `chunked`)
// and its tanh softcap; query row bh reads kv row bh / G.  lse is each
// row's log-sum-exp in natural-log units, written by the bf16 forward
// when a gradient will be taken, so no launch recomputes it.  The
// kernels are templated on D (q and k columns) and DV (v, o and dO
// columns) apart, for D = DV in {64, 80, 128, 256} and (D, DV) = (192,
// 128).
//
// Arithmetic (FA2's backward): with s the scaled, softcapped (t =
// tanh(s / c), s = t c) scores, p = exp(s - lse) on the pairs the mask
// keeps and 0 elsewhere, and D_i = rowsum(dO * O),
//   dv_j = sum_i p_ij dO_i          dp_ij = dO_i . v_j
//   ds_ij = p_ij (dp_ij - D_i) (1 - t_ij^2 with a softcap)
//   dq_i = sum_j ds_ij k_j / sqrt(D)   dk_j = sum_i ds_ij q_i / sqrt(D)
// S = Q K^T and dP = dO V^T take bf16 inputs, so they are exact products
// summed in f32.  p and ds are f32 values: each is split into bf16 high
// and low parts (split2, hopper_wgmma.cuh) and both parts go through the
// product, so the three products that take them carry about 16 bits
// where one bf16 rounding would carry 8 (dq's sums cancel: sum_j ds_ij =
// 0).  Every product accumulates in f32.
//
// What bounds it on this card: operations.  The least work is five
// products per kept pair, three over D (s, dq, dk) and two over Dv (dp,
// dv): 6*D + 4*Dv flops (10*D when Dv = D; 1,664 at MLA's 192 / 128); at
// the serving shapes (D = 256, local window 2,048, MQA 10:1) and at
// MLA's (causal global, S 3,000) that is far above the bytes.  This
// design does 12*D on the dK/dV side (s, dp, and the two split products)
// and 8*D on the dQ side (s and dp again, and dq's split product): 20*D
// a pair on the tensor cores when Dv = D, where the first design did 18*D
// on the CUDA cores.
//
// Four launches on the caller's stream, no atomics (two runs give bitwise
// the same gradients):
//   1. attn_bwd_delta_kernel: D_i = rowsum(dO * O) in f32, a warp a row;
//   2. attn_bwd_dkdv_kernel: one block per (share, key tile of 64, kv
//      row).  A key tile's work is the list of (query head of the group,
//      query tile of 64 it can see); `shares` blocks split that list into
//      contiguous runs, so the grid fills the SMs where (key tiles x kv
//      rows) alone would not (94 blocks at the serving shape for 132
//      SMs).  flash_attention_bwd_wgmma_shares picks the count from the
//      occupancy and the longest list.  Each block keeps its K and V tile
//      in shared memory, streams (Q, dO) tiles through a two-stage TMA
//      ring, and sums P^T dO and dS^T Q into f32 dK and dV in registers,
//      written to its share's slot of a scratch buffer;
//   3. attn_bwd_dq_kernel: one block per (bh, query tile of 64) keeps Q
//      and dO, streams (K, V) tiles of the keys it can see, and sums dS K
//      into dq in registers (the first design's layout);
//   4. attn_bwd_sum_kernel: dK and dV are the shares' partials summed in
//      share order, scaled and rounded to bf16.
//
// Products: every one is a warpgroup MMA (wgmma) fed by TMA with the
// 128-byte swizzle, as in the forward.  S^T = K Q^T and dP^T = V dO^T
// (dK/dV side) and S = Q K^T, dP = dO V^T (dQ side) read both operands
// K-major from shared memory; P^T dO, dS^T Q and dS K take the split p
// or ds from registers (an accumulator's layout is the A operand's
// register layout) and dO, Q or K from shared memory as the MN-major B
// operand (the transpose bit), so no operand is transposed by hand.
//
// Registers: at D = 256 dK and dV for 64 keys in f32 are 256 floats a
// thread of one warpgroup, above the 255-register limit.  So a block runs
// D / 128 consumer warpgroups (two at D = 256, one below), each owning
// D / 2 columns of dK and dV (of dq on the dQ side).  With two, one
// computes the score tile and the other the dP tile, each over all of D,
// and they exchange them through shared memory (f32, in the
// accumulator's layout: thread t of one warpgroup holds the elements
// thread t of the other holds); both then form p and ds for their own
// columns.  A block takes about 225 KB of shared memory at D = 256 (K,
// V, two (Q, dO) stages, the exchange), one block an SM.
//
// MLA's (192, 128): Q and K are three 128-byte column blocks, V and dO
// two.  S^T = K Q^T takes twelve k16 steps, dP^T = V dO^T eight.  dK (64
// x 192 f32) and dV (64 x 128 f32) are 160 floats a thread of one
// warpgroup, with S, dP and the split P and dS besides above the limit,
// and an n of 96 (half of 192) would start a B operand in the middle of
// a 64-column swizzle atom.  So the two warpgroups split the five column
// blocks at block boundaries: warpgroup 0 computes the score tile and
// owns dK's first 128 columns (one m64n128 product a k16 step, split in
// two); warpgroup 1 computes the dP tile and owns dV (m64n128) and dK's
// last 64 columns (m64n64).  That is 28 and 32 m64n64k16 steps an item
// (12 + 16 and 8 + 16 + 8), and 96 accumulator floats a thread in both
// (warpgroup 0 leaves its 32-float second accumulator idle).  On the dQ
// side warpgroup 0 owns dq's first 128 columns and warpgroup 1 the last
// 64.  Shared memory: dK/dV about 154 KB (K 24 KB, V 16 KB, two (Q, dO)
// stages of 40 KB, the exchange 32 KB), dQ about 153 KB (Q, dO, two (K,
// V) stages, the exchange); one block an SM.  ptxas (CUDA 12 on the
// H100's machine, printed by chip_smoke.py's phase 0): dK/dV 235
// registers, dQ 249, no spill (at D 256: 255 and 206; the softcap's loop
// beside the plain one took them from 246 and 162).
//
// D = DV = 80 (hubert-xlarge) is no multiple of 64: each row is kept as
// two whole 128-byte column blocks, the tensor maps (80 columns wide)
// filling columns 80-127 with zeros, and the kernels run as at D = 128
// (one warpgroup, its registers and shared memory) but for the products
// over D: S^T, dP^T, S and dP take five k16 steps over the 80 columns.
// The products whose N is the head dim (dV, dK, dq) run at N = 128 (an
// MN-major B operand comes in 64-column atoms of the 128-byte swizzle),
// their last 48 columns zero and not written: 2,176 operations a kept
// pair on the tensor cores where the unpadded design's 20*D would be
// 1,600.  A block there is bound by the latency of its one warpgroup's
// chain of steps, and the per-pair tests of the mask and the softcap
// (branches around each pair's steps, and integer divisions for chunked
// masks) lengthened it most: where the mask keeps every pair below S (not
// causal, global, no softcap: hubert-xlarge's attention), the kernels
// are instantiated with kAll, whose pairs take pair_grad_all, one
// straight run the compiler schedules with the exponentials in flight.
// ptxas: dK/dV 255 registers (254 with kAll), dQ 200 (155), no spill.
//
// The softcap: t and 1 - t^2 from one fast_tanh (hopper_wgmma.cuh; 1 -
// t^2 as 4 r (1 - r)), the forward's constant, in pair_grad_cap; a tile's
// pairs go through it or through pair_grad in two loops, the softcap
// tested once a tile.  At gemma2-2b's shape the softcap's tanhf and
// division had taken 0.39 of the backward's 1.05 ms (the same inputs
// without it: 0.66 ms); with fast_tanh, 0.10 of 0.67.  The dK/dV grid
// launches each kv row's first key tiles first where the key tiles'
// work differs (a causal mask gives key tile 0 every query tile).
//
// Masks: tiles that the mask hides from every pair are skipped (the key
// tile's query range, the query tile's key range); tiles that it shows
// whole skip the per-element test.  Rows and keys past S read zeros
// through the tensor maps' out-of-bounds fill and take p = 0; they are
// not written.  Every row sees its own key, so window 1 keeps one pair.
//
// Interface: plain C, bound from Python with ctypes.  The entry point
// launches on the caller's stream, allocates nothing (the wrapper passes
// D_i's (BH, S) f32 buffer and the partials' scratch), does not
// synchronise, and returns a CUDA error code (0 on success).

#include <math.h>

#include "hopper_wgmma.cuh"

namespace {

constexpr int kT = 64;         // query rows and keys per tile: a warpgroup's M
constexpr int kStages = 2;     // the streamed tiles' ring
constexpr float kLog2e = 1.4426950408889634f;

enum Kind { kGlobal = 0, kLocal = 1, kChunked = 2 };

struct Mask {
  int S, causal, kind, window;
  float scale, softcap, cap_k2;  // cap_k2: fast_tanh's 2 log2(e) scale / softcap

  __device__ __forceinline__ bool visible(int qp, int kp) const {
    bool v = qp < S && kp < S;
    if (causal) v = v && qp >= kp;
    if (kind == kLocal) v = v && (qp - kp) < window;
    else if (kind == kChunked) v = v && (qp / window) == (kp / window);
    return v;
  }

  // whether every pair of query tile [q0, q0 + kT) and key tile
  // [k0, k0 + kT) is kept
  __device__ __forceinline__ bool whole(int q0, int k0) const {
    const int q1 = q0 + kT - 1, k1 = k0 + kT - 1;
    bool w = q1 < S && k1 < S;
    if (causal) w = w && q0 >= k1;
    if (kind == kLocal) w = w && q1 - k0 < window;
    else if (kind == kChunked)
      w = w && q0 / window == q1 / window && k0 / window == k1 / window &&
          q0 / window == k0 / window;
    return w;
  }

  // the keys any row of query tile q0 may see: [lo, hi)
  __host__ __device__ void key_range(int q0, int& lo, int& hi) const {
    const int q_last = (q0 + kT < S ? q0 + kT : S) - 1;
    lo = 0;
    hi = S;
    if (causal) hi = q_last + 1;
    if (kind == kLocal) {
      lo = q0 - window + 1 > 0 ? q0 - window + 1 : 0;
    } else if (kind == kChunked) {
      lo = (q0 / window) * window;
      const int end = (q_last / window + 1) * window;
      hi = hi < end ? hi : end;
    }
  }

  // the query rows that may see any key of key tile k0: [lo, hi)
  __host__ __device__ void query_range(int k0, int& lo, int& hi) const {
    const int k_last = (k0 + kT < S ? k0 + kT : S) - 1;
    lo = causal ? k0 : 0;
    hi = S;
    if (kind == kLocal) {
      hi = k_last + window < S ? k_last + window : S;
    } else if (kind == kChunked) {
      const int start = (k0 / window) * window, end = (k_last / window + 1) * window;
      lo = lo > start ? lo : start;
      hi = hi < end ? hi : end;
    }
  }

  // key tile k0's work: each query head of its group times the query
  // tiles qt0 .. qt0 + n_qt - 1 that can see any of its keys
  __host__ __device__ void items(int k0, int& qt0, int& n_qt) const {
    int lo, hi;
    query_range(k0, lo, hi);
    qt0 = lo / kT;
    n_qt = (hi - qt0 * kT + kT - 1) / kT;
  }
};

// p and ds of one pair from its two dot products, in place: on entry s is
// q.k and dp is dO.v; on exit s is p and dp is ds (both 0 off the mask)
__device__ __forceinline__ void pair_grad(float& s, float& dp, float lse, float delta,
                                          bool keep, const Mask& m) {
  const float p = keep ? exp2f((s * m.scale - lse) * kLog2e) : 0.0f;
  s = p;
  dp = p * (dp - delta);
}

// pair_grad with the softcap: s = c t, t = tanh(q.k scale / c), and
// ds = p (dp - D_i) (1 - t^2), t and 1 - t^2 = 4 r (1 - r) from one
// fast_tanh.  The kernels take a tile's pairs through this or pair_grad
// in two loops (the softcap tested once a tile), so the loop without a
// softcap carries none of its steps.
__device__ __forceinline__ void pair_grad_cap(float& s, float& dp, float lse, float delta,
                                              bool keep, const Mask& m) {
  float r;
  const float x = fast_tanh(s, m.cap_k2, r) * m.softcap;
  const float p = keep ? exp2f((x - lse) * kLog2e) : 0.0f;
  s = p;
  dp = p * (dp - delta) * (4.0f * r * (1.0f - r));
}

// pair_grad where the mask keeps every pair below S and there is no
// softcap: the same steps with no branch, p selected to 0 for a pair past
// S (a padded row or key scores 0, whose exponential against an lse of
// the other side could overflow)
__device__ __forceinline__ void pair_grad_all(float& s, float& dp, float lse, float delta,
                                              bool keep, float scale) {
  const float p = exp2f((s * scale - lse) * kLog2e);
  s = keep ? p : 0.0f;
  dp = s * (dp - delta);
}

// acc (64 x N, f32) = A (64 rows) B^T (N rows), both tiles K-major in
// shared memory in D / 64 swizzled column blocks of 128 bytes
template <int D, int N>
__device__ __forceinline__ void tile_dot(float (&acc)[N / 2], uint32_t sa, uint32_t sb) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss<N>(acc, sw128_desc(sa + (kk / 4) * kT * 128 + off, 16, 1024),
                sw128_desc(sb + (kk / 4) * N * 128 + off, 16, 1024), kk > 0);
  }
}

// The two score-side tiles of one step, s (= A1 B1^T, over D columns) and
// dp (= A2 B2^T, over DV columns), in every warpgroup's registers.  With
// one warpgroup it computes both; with two, warpgroup w computes product
// w and they swap through `xch` (two slots of kT / 2 floats a thread,
// thread-major).
template <int D, int DV, int kWG>
__device__ __forceinline__ void score_tiles(float (&s)[kT / 2], float (&dp)[kT / 2],
                                            uint32_t a1, uint32_t b1, uint32_t a2,
                                            uint32_t b2, float* xch, int wg, int lt) {
  if constexpr (kWG == 1) {
    wgmma_fence();
    tile_dot<D, kT>(s, a1, b1);
    tile_dot<DV, kT>(dp, a2, b2);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);
  } else {
    float x[kT / 2];
    wgmma_fence();
    if constexpr (D == DV) {
      tile_dot<D, kT>(x, wg == 0 ? a1 : a2, wg == 0 ? b1 : b2);
    } else if (wg == 0) {
      tile_dot<D, kT>(x, a1, b1);
    } else {
      tile_dot<DV, kT>(x, a2, b2);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(x);
#pragma unroll
    for (int i = 0; i < kT / 2; ++i) xch[(wg * (kT / 2) + i) * 128 + lt] = x[i];
    __syncthreads();  // both tiles are in shared memory
#pragma unroll
    for (int i = 0; i < kT / 2; ++i) {
      s[i] = xch[i * 128 + lt];
      dp[i] = xch[(kT / 2 + i) * 128 + lt];
    }
  }
}

// A 64 x 64 f32 accumulator as bf16 high and low parts in the A operand's
// register layout: k-step kk (16 columns) is registers 8kk .. 8kk+7
__device__ __forceinline__ void split_tile(const float (&a)[kT / 2], uint32_t (&hi)[kT / 16][4],
                                           uint32_t (&lo)[kT / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kT / 16; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      split2(a[8 * kk + 2 * q], a[8 * kk + 2 * q + 1], hi[kk][q], lo[kk][q]);
}

// acc (64 x N) += (hi + lo) (64 x 64, registers) B (64 rows x N columns
// from column `col`, MN-major in shared memory: the transpose bit)
template <int N>
__device__ __forceinline__ void tile_acc(float (&acc)[N / 2], const uint32_t (&hi)[kT / 16][4],
                                         const uint32_t (&lo)[kT / 16][4], uint32_t sb,
                                         int col) {
#pragma unroll
  for (int kk = 0; kk < kT / 16; ++kk) {
    const uint64_t db = sw128_desc(sb + (col / kColBlock) * kT * 128 + kk * 16 * 128,
                                   kT * 128, 1024);
    wgmma_rs_tb<N>(acc, hi[kk], db);
    wgmma_rs_tb<N>(acc, lo[kk], db);
  }
}

// The first W of one warpgroup's N accumulator columns of 64 rows into
// columns [col, col + W) of a row-major plane of `width` columns, rows
// r_base + r0 and r_base + r0 + 8 below S, each value times `scale`: f32
// pairs, or bf16 pairs when T is __nv_bfloat16
template <int N, typename T, int W = N>
__device__ __forceinline__ void store_tile(T* dst, int width, int col, const float (&a)[N / 2],
                                           int r_base, int r0, int cq, int S, float scale) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r_base + r0 + 8 * half;
    if (r >= S) continue;
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      const long long at = (long long)r * width + col + cq + 8 * j;
      const float x = a[4 * j + 2 * half] * scale, y = a[4 * j + 2 * half + 1] * scale;
      if constexpr (sizeof(T) == 4)
        *reinterpret_cast<float2*>(dst + at) = make_float2(x, y);
      else
        *reinterpret_cast<__nv_bfloat162*>(dst + at) = __floats2bfloat162_rn(x, y);
    }
  }
}

// ---------------------------------------------------------------------------
// 1. D_i = rowsum(dO * O)
// ---------------------------------------------------------------------------

constexpr int kDeltaRows = 8;  // rows per block, a warp each

__global__ void __launch_bounds__(32 * kDeltaRows)
attn_bwd_delta_kernel(const __nv_bfloat16* __restrict__ o,
                      const __nv_bfloat16* __restrict__ dout, float* __restrict__ delta,
                      long long rows, int D) {
  const long long row = (long long)blockIdx.x * kDeltaRows + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const uint4* ob = reinterpret_cast<const uint4*>(o + row * D);
  const uint4* db = reinterpret_cast<const uint4*>(dout + row * D);
  float acc = 0.0f;
  for (int c = lane; c < D / 8; c += 32) {
    const uint4 a = ob[c], b = db[c];
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 fa = __bfloat1622float2(a2[e]), fb = __bfloat1622float2(b2[e]);
      acc = fmaf(fa.x, fb.x, acc);
      acc = fmaf(fa.y, fb.y, acc);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// ---------------------------------------------------------------------------
// 2. dK and dV partials: one block per (share, key tile, kv row)
// ---------------------------------------------------------------------------

// Shared memory: K, V, then the (Q, dO) ring, the exchange (two
// warpgroups only), each stage's lse and D_i, the barriers; tiles on
// 1,024-byte boundaries.  Q and K tiles are kT x D bf16, V and dO tiles
// kT x DV, each in whole column blocks (padded_cols).
template <int D, int DV>
struct DkdvLayout {
  static constexpr int kWG = D > 128 || D != DV ? 2 : 1;  // consumer warpgroups
  static constexpr uint32_t kQK = kT * padded_cols(D) * 2;
  static constexpr uint32_t kVO = kT * padded_cols(DV) * 2;
  static constexpr uint32_t kStage = kQK + kVO;
  static constexpr uint32_t kK = 0;
  static constexpr uint32_t kV = kQK;
  static constexpr uint32_t kRing = kQK + kVO;  // stage st: Q, then dO
  static constexpr uint32_t kX = kRing + kStages * kStage;
  static constexpr uint32_t kRows = kX + (kWG == 2 ? 2 * (kT / 2) * 128 * 4 : 0);
  static constexpr uint32_t kBar = kRows + kStages * 2 * kT * 4;
  // the K/V barrier and one a stage, then slack to align the base
  static constexpr uint32_t kBytes = kBar + 8 * (kStages + 1) + 1024;
};

// The column split of the gradients between the warpgroups.  With D =
// DV, warpgroup w owns columns [w D / kWG, (w + 1) D / kWG) of dK and dV:
// accumulator 0 is its dV, accumulator 1 its dK, N0 = N1 = D / kWG.  With
// MLA's (192, 128) (the only D != DV pair), accumulator 0 is 128 columns
// and 1 is 64: warpgroup 0 owns dK[:, 0:128] in 0 (1 idle), warpgroup 1
// dV in 0 and dK[:, 128:192] in 1.  On the dQ side the same N0, N1:
// warpgroup 0 owns dq[:, 0:N0] in 0, warpgroup 1 dq[:, N0:D] in 1 (D !=
// DV; with D = DV accumulator 0 holds each warpgroup's D / kWG columns).
// kN0 and kN1 are the accumulators' widths, kW0 and kW1 the columns of
// them written: 128 and 80 at D = DV = 80 (one warpgroup, its products at
// N = 128 over the padded blocks).
template <int D, int DV>
struct Split {
  static_assert(D == DV || (D == 192 && DV == 128), "unsupported head dims");
  static constexpr bool kMixed = D != DV;
  static constexpr int kWG = DkdvLayout<D, DV>::kWG;
  static constexpr int kN0 = kMixed ? DV : padded_cols(D) / kWG;
  static constexpr int kN1 = kMixed ? D - DV : padded_cols(D) / kWG;
  static constexpr int kW0 = kMixed ? DV : D / kWG;
  static constexpr int kW1 = kMixed ? D - DV : D / kWG;
};

// kAll: the mask keeps every pair below S (see the header).
template <int D, int DV, bool kAll = false>
__global__ void __launch_bounds__(128 * DkdvLayout<D, DV>::kWG, 1)
attn_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ part, int bh_kv,
                     int group, int shares, int heads_inner, Mask mask) {
  using L = DkdvLayout<D, DV>;
  using P = Split<D, DV>;
  constexpr int kWG = L::kWG;
  constexpr int kQKCols = col_blocks(D), kVCols = col_blocks(DV);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - smem_u32(smem_raw));
  float* xch = reinterpret_cast<float*>(gbase + L::kX);
  float* rows = reinterpret_cast<float*>(gbase + L::kRows);  // [stage][lse, D_i][kT]
  const uint32_t sk = base + L::kK, sv = base + L::kV;
  const uint32_t kvbar = base + L::kBar;
  const uint32_t full = kvbar + 8;  // stage st: full + 8 * st

  const int S = mask.S;
  // grid (shares, kv rows, key tiles) where the key tiles' work differs
  // (causal, local, chunked): the first key tiles, which the most query
  // tiles see under a causal mask, are launched first in every kv row;
  // else (shares, key tiles, kv rows), a kv row's key tiles side by side
  const int share = blockIdx.x;
  const int kvh = heads_inner ? blockIdx.y : blockIdx.z;
  const int k0 = (heads_inner ? blockIdx.z : blockIdx.y) * kT;
  int qt0, n_qt;
  mask.items(k0, qt0, n_qt);
  const int n_items = group * n_qt;
  const int i_begin = (int)((long long)n_items * share / shares);
  const int n_mine = (int)((long long)n_items * (share + 1) / shares) - i_begin;
  const int tid = threadIdx.x;

  auto item_rows = [&](int item, int& bh, int& q0) {
    bh = kvh * group + item / n_qt;
    q0 = (qt0 + item % n_qt) * kT;
  };
  auto load_item = [&](int st, int item) {
    int bh, q0;
    item_rows(item, bh, q0);
    const uint32_t bar = full + 8 * st;
    const uint32_t sq = base + L::kRing + st * L::kStage;
    mbar_expect_tx(bar, L::kStage);
#pragma unroll
    for (int c = 0; c < kQKCols; ++c)
      tma_load_3d(sq + c * kT * 128, &tq, bar, c * kColBlock, q0, bh);
#pragma unroll
    for (int c = 0; c < kVCols; ++c)
      tma_load_3d(sq + L::kQK + c * kT * 128, &tdo, bar, c * kColBlock, q0, bh);
  };
  // lse and D_i of an item's query rows into its stage (rows past S: 0)
  auto stage_rows = [&](int st, int item) {
    if (tid < 2 * kT) {
      int bh, q0;
      item_rows(item, bh, q0);
      const int r = q0 + tid % kT;
      const float* src = tid < kT ? lse : delta;
      rows[st * 2 * kT + tid] = r < S ? src[(long long)bh * S + r] : 0.0f;
    }
  };

  if (tid == 0) {
    for (int b = 0; b <= kStages; ++b) mbar_init(kvbar + 8 * b, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0 && n_mine > 0) {
    mbar_expect_tx(kvbar, L::kQK + L::kVO);
#pragma unroll
    for (int c = 0; c < kQKCols; ++c)
      tma_load_3d(sk + c * kT * 128, &tk, kvbar, c * kColBlock, k0, kvh);
#pragma unroll
    for (int c = 0; c < kVCols; ++c)
      tma_load_3d(sv + c * kT * 128, &tv, kvbar, c * kColBlock, k0, kvh);
    for (int st = 0; st < kStages && st < n_mine; ++st) load_item(st, i_begin + st);
  }
  for (int st = 0; st < kStages && st < n_mine; ++st) stage_rows(st, i_begin + st);
  __syncthreads();

  // accumulator layout: warp w of a warpgroup owns rows 16w .. 16w+15; a
  // thread holds rows r0 and r0 + 8, columns 8j + cq + {0, 1}
  const int wg = tid / 128, lt = tid % 128;
  const int warp = lt / 32, lane = lt % 32;
  const int r0 = 16 * warp + lane / 4;
  const int cq = 2 * (lane % 4);

  // the Split's two accumulators (with D = DV: dV and dK)
  float a0[P::kN0 / 2], a1[P::kN1 / 2];
#pragma unroll
  for (int i = 0; i < P::kN0 / 2; ++i) a0[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < P::kN1 / 2; ++i) a1[i] = 0.0f;

  if (n_mine > 0) mbar_wait(kvbar, 0);
  for (int it = 0; it < n_mine; ++it) {
    const int st = it % kStages;
    int bh, q0;
    item_rows(i_begin + it, bh, q0);
    const uint32_t sq = base + L::kRing + st * L::kStage;
    const uint32_t sdo = sq + L::kQK;
    const float* lse_s = rows + st * 2 * kT;
    const float* delta_s = lse_s + kT;
    mbar_wait(full + 8 * st, (it / kStages) & 1);

    // S^T = K Q^T and dP^T = V dO^T: rows keys, columns query rows
    float s[kT / 2], dp[kT / 2];
    score_tiles<D, DV, kWG>(s, dp, sk, sq, sv, sdo, xch, wg, lt);

    if constexpr (kAll) {
#pragma unroll
      for (int i = 0; i < kT / 2; ++i) {
        const int qc = 8 * (i / 4) + cq + (i % 2);
        const int kr = r0 + 8 * ((i / 2) % 2);
        pair_grad_all(s[i], dp[i], lse_s[qc], delta_s[qc], q0 + qc < S && k0 + kr < S,
                      mask.scale);
      }
    } else {
      const bool whole = mask.whole(q0, k0);
      if (mask.softcap > 0.0f) {
#pragma unroll
        for (int i = 0; i < kT / 2; ++i) {
          const int qc = 8 * (i / 4) + cq + (i % 2);
          const int kr = r0 + 8 * ((i / 2) % 2);
          pair_grad_cap(s[i], dp[i], lse_s[qc], delta_s[qc],
                        whole || mask.visible(q0 + qc, k0 + kr), mask);
        }
      } else {
#pragma unroll
        for (int i = 0; i < kT / 2; ++i) {
          const int qc = 8 * (i / 4) + cq + (i % 2);
          const int kr = r0 + 8 * ((i / 2) % 2);
          pair_grad(s[i], dp[i], lse_s[qc], delta_s[qc],
                    whole || mask.visible(q0 + qc, k0 + kr), mask);
        }
      }
    }

    if constexpr (!P::kMixed) {
      // dV += P^T dO, then dK += dS^T Q (each split in two), this
      // warpgroup's columns; dS is split while P^T dO runs
      constexpr int kDW = P::kN0;
      uint32_t ph[kT / 16][4], pl[kT / 16][4], dh[kT / 16][4], dl[kT / 16][4];
      split_tile(s, ph, pl);
      wgmma_fence();
      tile_acc<kDW>(a0, ph, pl, sdo, wg * kDW);
      wgmma_commit();
      split_tile(dp, dh, dl);
      wgmma_fence();
      tile_acc<kDW>(a1, dh, dl, sq, wg * kDW);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(a0);
      fence_regs(a1);
      fence_regs(ph);
      fence_regs(pl);
      fence_regs(dh);
      fence_regs(dl);
    } else {
      // warpgroup 0: dK[:, 0:128] += dS^T Q; warpgroup 1: dV += P^T dO,
      // then dK[:, 128:192] += dS^T Q (each split in two)
      uint32_t h[kT / 16][4], l[kT / 16][4];
      if (wg == 0) {
        split_tile(dp, h, l);
        wgmma_fence();
        tile_acc<P::kN0>(a0, h, l, sq, 0);
        wgmma_commit();
      } else {
        split_tile(s, h, l);
        wgmma_fence();
        tile_acc<P::kN0>(a0, h, l, sdo, 0);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(a0);
        fence_regs(h);
        fence_regs(l);
        split_tile(dp, h, l);
        wgmma_fence();
        tile_acc<P::kN1>(a1, h, l, sq, P::kN0);
        wgmma_commit();
      }
      wgmma_wait_all();
      fence_regs(a0);
      fence_regs(a1);
      fence_regs(h);
      fence_regs(l);
    }

    // every warp is done with this stage: refill it with item it + kStages
    __syncthreads();
    if (it + kStages < n_mine) {
      if (tid == 0) load_item(st, i_begin + it + kStages);
      stage_rows(st, i_begin + it + kStages);
    }
  }

  // this share's partials, rows below S (an empty share writes zeros):
  // every share's dK planes (S x D), then every share's dV planes (S x DV)
  float* pk = part + ((long long)share * bh_kv + kvh) * S * D;
  float* pv = part + (long long)shares * bh_kv * S * D +
              ((long long)share * bh_kv + kvh) * S * DV;
  if constexpr (!P::kMixed) {
    store_tile<P::kN1, float, P::kW1>(pk, D, wg * P::kW1, a1, k0, r0, cq, S, 1.0f);
    store_tile<P::kN0, float, P::kW0>(pv, DV, wg * P::kW0, a0, k0, r0, cq, S, 1.0f);
  } else if (wg == 0) {
    store_tile<P::kN0>(pk, D, 0, a0, k0, r0, cq, S, 1.0f);
  } else {
    store_tile<P::kN0>(pv, DV, 0, a0, k0, r0, cq, S, 1.0f);
    store_tile<P::kN1>(pk, D, P::kN0, a1, k0, r0, cq, S, 1.0f);
  }
}

// ---------------------------------------------------------------------------
// 3. dQ: one block per (bh, query tile)
// ---------------------------------------------------------------------------

// Shared memory: Q, dO, then the (K, V) ring, the exchange (two
// warpgroups only), the barriers; tiles in whole column blocks.
template <int D, int DV>
struct DqLayout {
  static constexpr int kWG = D > 128 || D != DV ? 2 : 1;
  static constexpr uint32_t kQK = kT * padded_cols(D) * 2;
  static constexpr uint32_t kVO = kT * padded_cols(DV) * 2;
  static constexpr uint32_t kStage = kQK + kVO;
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kDO = kQK;
  static constexpr uint32_t kRing = kQK + kVO;  // stage st: K, then V
  static constexpr uint32_t kX = kRing + kStages * kStage;
  static constexpr uint32_t kBar = kX + (kWG == 2 ? 2 * (kT / 2) * 128 * 4 : 0);
  static constexpr uint32_t kBytes = kBar + 8 * (kStages + 1) + 1024;
};

template <int D, int DV, bool kAll = false>
__global__ void __launch_bounds__(128 * DqLayout<D, DV>::kWG, 1)
attn_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                   const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int group,
                   Mask mask) {
  using L = DqLayout<D, DV>;
  using P = Split<D, DV>;
  constexpr int kWG = L::kWG;
  constexpr int kQKCols = col_blocks(D), kVCols = col_blocks(DV);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - smem_u32(smem_raw));
  float* xch = reinterpret_cast<float*>(gbase + L::kX);
  const uint32_t sq = base + L::kQ, sdo = base + L::kDO;
  const uint32_t qbar = base + L::kBar;
  const uint32_t full = qbar + 8;

  const int S = mask.S;
  const int bh = blockIdx.x, kvh = bh / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kT;  // longest tiles first
  int lo, hi;
  mask.key_range(q0, lo, hi);
  const int k_first = (lo / kT) * kT;
  const int n_tiles = (hi - k_first + kT - 1) / kT;
  const int tid = threadIdx.x;

  auto load_kv = [&](int st, int k0) {
    const uint32_t bar = full + 8 * st;
    const uint32_t skt = base + L::kRing + st * L::kStage;
    mbar_expect_tx(bar, L::kStage);
#pragma unroll
    for (int c = 0; c < kQKCols; ++c)
      tma_load_3d(skt + c * kT * 128, &tk, bar, c * kColBlock, k0, kvh);
#pragma unroll
    for (int c = 0; c < kVCols; ++c)
      tma_load_3d(skt + L::kQK + c * kT * 128, &tv, bar, c * kColBlock, k0, kvh);
  };
  if (tid == 0) {
    for (int b = 0; b <= kStages; ++b) mbar_init(qbar + 8 * b, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(qbar, L::kQK + L::kVO);
#pragma unroll
    for (int c = 0; c < kQKCols; ++c)
      tma_load_3d(sq + c * kT * 128, &tq, qbar, c * kColBlock, q0, bh);
#pragma unroll
    for (int c = 0; c < kVCols; ++c)
      tma_load_3d(sdo + c * kT * 128, &tdo, qbar, c * kColBlock, q0, bh);
    for (int st = 0; st < kStages && st < n_tiles; ++st) load_kv(st, k_first + st * kT);
  }

  const int wg = tid / 128, lt = tid % 128;
  const int warp = lt / 32, lane = lt % 32;
  const int r0 = 16 * warp + lane / 4;
  const int cq = 2 * (lane % 4);
  const int qp0 = q0 + r0, qp1 = qp0 + 8;
  const float* lse_b = lse + (long long)bh * S;
  const float* delta_b = delta + (long long)bh * S;
  const float lse0 = qp0 < S ? lse_b[qp0] : 0.0f, lse1 = qp1 < S ? lse_b[qp1] : 0.0f;
  const float dl0 = qp0 < S ? delta_b[qp0] : 0.0f, dl1 = qp1 < S ? delta_b[qp1] : 0.0f;

  // dq's columns: with D = DV, [wg D / kWG, (wg + 1) D / kWG) in a0;
  // with MLA's, warpgroup 0's [0, N0) in a0, warpgroup 1's [N0, D) in a1
  constexpr int kN1 = P::kMixed ? P::kN1 : 2;  // a1 idle with D = DV
  float a0[P::kN0 / 2], a1[kN1 / 2];
#pragma unroll
  for (int i = 0; i < P::kN0 / 2; ++i) a0[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < kN1 / 2; ++i) a1[i] = 0.0f;

  mbar_wait(qbar, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages;
    const int k0 = k_first + it * kT;
    const uint32_t skt = base + L::kRing + st * L::kStage;
    const uint32_t svt = skt + L::kQK;
    mbar_wait(full + 8 * st, (it / kStages) & 1);

    // S = Q K^T and dP = dO V^T: rows query rows, columns keys
    float s[kT / 2], dp[kT / 2];
    score_tiles<D, DV, kWG>(s, dp, sq, skt, sdo, svt, xch, wg, lt);

    if constexpr (kAll) {
#pragma unroll
      for (int i = 0; i < kT / 2; ++i) {
        const int kc = 8 * (i / 4) + cq + (i % 2);
        const bool second = (i / 2) % 2;
        pair_grad_all(s[i], dp[i], second ? lse1 : lse0, second ? dl1 : dl0,
                      (second ? qp1 : qp0) < S && k0 + kc < S, mask.scale);
      }
    } else {
      const bool whole = mask.whole(q0, k0);
      if (mask.softcap > 0.0f) {
#pragma unroll
        for (int i = 0; i < kT / 2; ++i) {
          const int kc = 8 * (i / 4) + cq + (i % 2);
          const bool second = (i / 2) % 2;
          pair_grad_cap(s[i], dp[i], second ? lse1 : lse0, second ? dl1 : dl0,
                        whole || mask.visible(second ? qp1 : qp0, k0 + kc), mask);
        }
      } else {
#pragma unroll
        for (int i = 0; i < kT / 2; ++i) {
          const int kc = 8 * (i / 4) + cq + (i % 2);
          const bool second = (i / 2) % 2;
          pair_grad(s[i], dp[i], second ? lse1 : lse0, second ? dl1 : dl0,
                    whole || mask.visible(second ? qp1 : qp0, k0 + kc), mask);
        }
      }
    }

    // dQ += dS K (split in two), this warpgroup's columns
    uint32_t dh[kT / 16][4], dl[kT / 16][4];
    split_tile(dp, dh, dl);
    wgmma_fence();
    if constexpr (!P::kMixed) {
      tile_acc<P::kN0>(a0, dh, dl, skt, wg * P::kN0);
    } else if (wg == 0) {
      tile_acc<P::kN0>(a0, dh, dl, skt, 0);
    } else {
      tile_acc<P::kN1>(a1, dh, dl, skt, P::kN0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(a0);
    fence_regs(a1);
    fence_regs(dh);
    fence_regs(dl);

    __syncthreads();  // every warp is done with this stage and the exchange
    if (tid == 0 && it + kStages < n_tiles) load_kv(st, k0 + kStages * kT);
  }

  __nv_bfloat16* dqb = dq + (long long)bh * S * D;
  if constexpr (!P::kMixed)
    store_tile<P::kN0, __nv_bfloat16, P::kW0>(dqb, D, wg * P::kW0, a0, q0, r0, cq, S,
                                              mask.scale);
  else if (wg == 0)
    store_tile<P::kN0>(dqb, D, 0, a0, q0, r0, cq, S, mask.scale);
  else
    store_tile<P::kN1>(dqb, D, P::kN0, a1, q0, r0, cq, S, mask.scale);
}

// ---------------------------------------------------------------------------
// 4. dK and dV: the shares' partials summed in share order
// ---------------------------------------------------------------------------

// part holds `shares` planes of dK partials (nk floats each), then
// `shares` of dV partials (nv floats each)
__global__ void __launch_bounds__(256)
attn_bwd_sum_kernel(const float* __restrict__ part, __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, long long nk, long long nv, int shares,
                    float scale) {
  const long long nk4 = nk / 4, nv4 = nv / 4, n4 = nk4 > nv4 ? nk4 : nv4;
  const float* pv = part + (long long)shares * nk;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    if (i < nk4) {
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int p = 0; p < shares; ++p) {
        const float4 x = reinterpret_cast<const float4*>(part + (long long)p * nk)[i];
        a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
      }
      reinterpret_cast<uint2*>(dk)[i] =
          make_uint2(pack_bf16(a.x * scale, a.y * scale), pack_bf16(a.z * scale, a.w * scale));
    }
    if (i < nv4) {
      float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int p = 0; p < shares; ++p) {
        const float4 y = reinterpret_cast<const float4*>(pv + (long long)p * nv)[i];
        b.x += y.x; b.y += y.y; b.z += y.z; b.w += y.w;
      }
      reinterpret_cast<uint2*>(dv)[i] = make_uint2(pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
    }
  }
}

Mask make_mask(int s, int d, int causal, int kind, int window, float softcap) {
  const double scale = 1.0 / sqrt((double)d);
  return Mask{s, causal, kind, window, (float)scale, softcap,
              softcap > 0.0f ? (float)(2.0 * kLog2e * scale / softcap) : 0.0f};
}

// Blocks of the dK/dV kernel an SM holds, or 0 when the query fails.
template <int D, int DV>
int dkdv_occupancy() {
  const int smem = (int)DkdvLayout<D, DV>::kBytes;
  if (cudaFuncSetAttribute(attn_bwd_dkdv_kernel<D, DV>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem) != cudaSuccess)
    return 0;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, attn_bwd_dkdv_kernel<D, DV>,
                                                    128 * DkdvLayout<D, DV>::kWG,
                                                    smem) != cudaSuccess)
    return 0;
  return n;
}

// A dK/dV block's fixed work (its K and V tile in, its 64 x D f32
// partials of dK and dV out and read back by the sum), in items: at D =
// 256 the 128 KB of partials take about as long as one item's products
// on an SM's share of the bandwidth.
constexpr int kBlockCost = 2;

// The share count: the one (smallest on a tie) that minimises the waves
// of dK/dV blocks times the work of the longest share, a proxy for the
// launch's span.  Large grids take one share; at the serving shape (one
// kv row, 47 key tiles, ten heads) it is about ten.
int choose_shares(int bh_kv, int s, int group, const Mask& m, int per_sm) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      per_sm <= 0)
    return 0;
  const int tiles = (s + kT - 1) / kT;
  int most = 1;
  for (int t = 0; t < tiles; ++t) {
    int qt0, n_qt;
    m.items(t * kT, qt0, n_qt);
    most = n_qt * group > most ? n_qt * group : most;
  }
  const long long slots = (long long)sms * per_sm;
  const long long blocks = (long long)bh_kv * tiles;
  int best = 1;
  long long best_cost = -1;
  for (int p = 1; p <= most; ++p) {
    const long long waves = (blocks * p + slots - 1) / slots;
    const long long cost = waves * ((most + p - 1) / p + kBlockCost);
    if (best_cost < 0 || cost < best_cost) {
      best = p;
      best_cost = cost;
    }
  }
  return best;
}

template <int D, int DV, bool kAll = false>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, void* dq, void* dk, void* dv,
                   float* delta, float* part, int bh, int s, int group, int shares,
                   const Mask& mask, cudaStream_t stream) {
  using LK = DkdvLayout<D, DV>;
  using LQ = DqLayout<D, DV>;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  const int bh_kv = bh / group;
  CUtensorMap mq, mk, mv, mdo;
  if (!encode_map(enc, &mq, q, bh, s, D, kT) || !encode_map(enc, &mk, k, bh_kv, s, D, kT) ||
      !encode_map(enc, &mv, v, bh_kv, s, DV, kT) ||
      !encode_map(enc, &mdo, dout, bh, s, DV, kT))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_dkdv_kernel<D, DV, kAll>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)LK::kBytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attn_bwd_dq_kernel<D, DV, kAll>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)LQ::kBytes);
  if (err != cudaSuccess) return err;

  const long long rows = (long long)bh * s;
  attn_bwd_delta_kernel<<<(unsigned)((rows + kDeltaRows - 1) / kDeltaRows), 32 * kDeltaRows, 0,
                          stream>>>(static_cast<const __nv_bfloat16*>(o),
                                    static_cast<const __nv_bfloat16*>(dout), delta, rows, DV);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int tiles = (s + kT - 1) / kT;
  const int heads_inner = mask.causal || mask.kind != kGlobal;
  attn_bwd_dkdv_kernel<D, DV, kAll>
      <<<heads_inner ? dim3(shares, bh_kv, tiles) : dim3(shares, tiles, bh_kv),
         128 * LK::kWG, LK::kBytes, stream>>>(mq, mk, mv, mdo, lse, delta, part, bh_kv,
                                              group, shares, heads_inner, mask);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  attn_bwd_dq_kernel<D, DV, kAll><<<dim3(bh, tiles), 128 * LQ::kWG, LQ::kBytes, stream>>>(
      mq, mk, mv, mdo, lse, delta, static_cast<__nv_bfloat16*>(dq), group, mask);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long nk = (long long)bh_kv * s * D, nv = (long long)bh_kv * s * DV;
  const long long blocks = ((nk > nv ? nk : nv) / 4 + 255) / 256;
  attn_bwd_sum_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(
      part, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), nk, nv, shares,
      mask.scale);
  return cudaGetLastError();
}

}  // namespace

// The number of shares the dK/dV launch splits each key tile's work
// into (the partials' scratch is shares * (bh / group) * s * (d + dv)
// f32), or 0 when the arguments are refused or the device query fails.
extern "C" int flash_attention_bwd_wgmma_shares(int bh, int s, int d, int dv, int group,
                                                int causal, int kind, int window) {
  if (bh <= 0 || s <= 0 || group <= 0 || bh % group) return 0;
  if (kind != kGlobal && window < 1) return 0;
  const Mask m = make_mask(s, d, causal, kind, window, 0.0f);
  const int bh_kv = bh / group;
  if (d == 192 && dv == 128)
    return choose_shares(bh_kv, s, group, m, dkdv_occupancy<192, 128>());
  if (d != dv) return 0;
  switch (d) {
    case 64: return choose_shares(bh_kv, s, group, m, dkdv_occupancy<64, 64>());
    case 80: return choose_shares(bh_kv, s, group, m, dkdv_occupancy<80, 80>());
    case 128: return choose_shares(bh_kv, s, group, m, dkdv_occupancy<128, 128>());
    case 256: return choose_shares(bh_kv, s, group, m, dkdv_occupancy<256, 256>());
    default: return 0;
  }
}

// q, dq: (bh, s, d) bf16; o, dout: (bh, s, dv) bf16; k, dk: (bh / group,
// s, d) bf16; v, dv_out: (bh / group, s, dv) bf16; lse: (bh, s) f32 from
// the forward; delta: (bh, s) f32 scratch; part: shares * (bh / group) *
// s * (d + dv) f32 scratch.  All contiguous, 16-byte aligned, on the
// current device; d = dv in {64, 80, 128, 256} or (d, dv) = (192, 128).
// kind: 0 global, 1 local, 2 chunked.
extern "C" int flash_attention_bwd_wgmma(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, const float* lse,
                                         void* dq, void* dk, void* dv_out, float* delta,
                                         float* part, int bh, int s, int d, int dv, int group,
                                         int shares, int causal, int kind, int window,
                                         double softcap, void* stream) {
  if (bh <= 0 || s <= 0) return (int)cudaSuccess;
  if (group <= 0 || bh % group || shares <= 0) return (int)cudaErrorInvalidValue;
  if (kind != kGlobal && window < 1) return (int)cudaErrorInvalidValue;
  const Mask m = make_mask(s, d, causal, kind, window, (float)softcap);
  const cudaStream_t st = (cudaStream_t)stream;
  if (d == 192 && dv == 128)
    return (int)launch<192, 128>(q, k, v, o, dout, lse, dq, dk, dv_out, delta, part, bh, s,
                                 group, shares, m, st);
  if (d != dv) return (int)cudaErrorInvalidValue;
  switch (d) {
    case 64:
      return (int)launch<64, 64>(q, k, v, o, dout, lse, dq, dk, dv_out, delta, part, bh, s,
                                 group, shares, m, st);
    case 80:
      if (!causal && kind == kGlobal && softcap == 0.0)
        return (int)launch<80, 80, true>(q, k, v, o, dout, lse, dq, dk, dv_out, delta, part,
                                         bh, s, group, shares, m, st);
      return (int)launch<80, 80>(q, k, v, o, dout, lse, dq, dk, dv_out, delta, part, bh, s,
                                 group, shares, m, st);
    case 128:
      return (int)launch<128, 128>(q, k, v, o, dout, lse, dq, dk, dv_out, delta, part, bh, s,
                                   group, shares, m, st);
    case 256:
      return (int)launch<256, 256>(q, k, v, o, dout, lse, dq, dk, dv_out, delta, part, bh, s,
                                   group, shares, m, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
