// Forward attention with an online softmax on Hopper's tensor cores
// (sm_90a): the bf16 path for head dims 64, 80 (hubert-xlarge), 128 and
// 256, and for MLA's q and k of head dim 192 with v of head dim 128.
//
// Replaces, for bf16 inputs with D = Dv in {64, 80, 128, 256} or (D, Dv) =
// (192, 128), the Pallas TPU kernel `flash_attention` (`_kernel`) of
// src/repro/kernels/flash_attention.py:
//   q (BH, S, D), k (BH / G, S, D), v (BH / G, S, Dv), bf16
//   -> o (BH, S, Dv) bf16,
// with causal, `local` (sliding window) and `chunked` (aligned chunks of
// `window` keys) masks and an optional tanh softcap on the scores.  Query
// row bh reads kv row bh / G, so MQA and GQA need no repeat of k and v.
// f32 inputs and other head dims stay on the CUDA-core kernel of
// flash_attention.cu; the wrapper picks the path from dtype, D and Dv
// alone.  The kernel is templated on DQK (q and k columns) and DV (v and
// o columns) apart; the scale is 1/sqrt(DQK).
//
// Arithmetic, as the Pallas kernel does it: s = (q.k) * (1/sqrt(D)) with
// the bf16 products summed in f32 (bf16 x bf16 is exact in f32, so only
// the order of summation differs); softcap s = tanh(s / c) * c, before the
// mask, its tanh from fast_tanh (hopper_wgmma.cuh: one ex2.approx and one
// rcp.approx on q.k times a constant the host rounds once, within about
// 1e-6 of tanh); masked scores take the finite value -2.3819763e38 and
// keys past S take -inf; the running (m, l, acc) are f32, l sums the f32 p, p is
// rounded to bf16 before P.V, which accumulates in f32; o = acc / max(l,
// 1e-30) is written in bf16.  When a gradient will be taken the caller
// also asks for each row's log-sum-exp, lse = m + log(max(l, 1e-30)) in
// f32, natural-log units (the scores stay unscaled by log2(e), which only
// the exp2f calls apply), written beside o: the backward
// (flash_attention_bwd_wgmma.cu) reads it instead of recomputing it.
//
// What bounds it on this card.  At the serving shapes (D = 256, a local
// window of 2,048, S up to 3,000) the work is 4*D operations per unmasked
// query-key pair against 2*D bytes of q, k, v and o per query row: it is
// bound by the tensor cores' bf16 rate (989 TFLOP/s dense), not by
// memory.  The earlier kernel ran both products on the CUDA cores in f32
// (67 TFLOP/s at most).
//
// What the design does:
//   * one block of one warpgroup (128 threads) per (bh, tile of 64 query
//     rows); both products run as warpgroup MMAs (wgmma): S = Q K^T as
//     m64n{BK}k16 steps over DQK with Q and K in shared memory (12 steps
//     at MLA's 192), and O += P V as m64n{DV}k16 steps over the BK keys of
//     a tile (m64n128k16 at MLA's 128), with P
//     taken from registers (S's accumulator layout is the A operand's
//     register layout, so p is rounded to bf16 in place) and V from shared
//     memory as the MN-major B operand (the transpose bit);
//   * O (64 x DV f32), m and l live in the warpgroup's registers: DV / 2
//     floats of O a thread, 128 at DV = 256.  The register budget is met by
//     the tile sizes, not by setmaxnreg: a block is one warpgroup and
//     nothing else, so __launch_bounds__(128, 1) leaves each thread 255
//     registers for O, S (BK / 2), P (BK / 4) and the softmax state (ptxas
//     gives 179 at D = 256, so two blocks fit in an SM's 65,536);
//   * Q, K and V arrive by TMA (cp.async.bulk.tensor, 3-d tensor maps
//     encoded on the host with cuTensorMapEncodeTiled) with the 128-byte
//     swizzle that the wgmma descriptors name.  A row of D bf16 is cut
//     into D / 64 column blocks of 128 bytes (three for MLA's q and k,
//     two for its v), each stored as its own
//     rows x 128 B swizzled tile; D = 80 as two blocks whose last 48
//     columns the tensor maps fill with zeros (col_blocks,
//     hopper_wgmma.cuh).  K and V go into a ring of two stages,
//     each with an mbarrier: the copy of tile j + 1 is in flight while
//     tile j's products run, and tile j + 2's copy starts as soon as
//     tile j's products are done;
//   * kv tiles that the mask hides from every row of the q tile are
//     skipped (as in the CUDA-core kernel), and tiles that it shows whole
//     to every row skip the per-element mask;
//   * D = 80: S = Q K^T takes its five k16 steps over the 80 columns;
//     O += P V runs at N = 128 over V's two blocks (an MN-major B operand
//     comes in 64-column atoms of the 128-byte swizzle), the last 48
//     columns of O zero and not written: 416 operations a kept pair where
//     320 would do.  A block there is bound by the latency of its one
//     warpgroup's chain of steps, not by the tensor cores, so the tests of
//     the softcap and of a whole tile are taken once a tile (kFlat), not
//     once an element: a whole tile is one straight run of multiplies;
//   * a ragged last q or kv tile needs no special case: the tensor maps'
//     out-of-bounds fill reads zeros past S, keys past S take -inf, and
//     query rows past S are not written;
//   * q tiles are launched longest first, the last q tile, whose causal
//     or local kv range is the widest, first, with the heads side by
//     side, so the blocks sharing one kv head (MQA 10:1 at the serving
//     shape) start together and share K and V in L2; where the K and V of
//     all heads overflow the L2 (MLA's 128 heads from S 1,000), in groups
//     of heads whose K and V fit (order_heads);
//   * the softcap (gemma2-2b's 50) costs two MUFU steps a score where
//     tanhf and an IEEE division took some twenty instructions on the
//     block's one chain: at gemma2-2b's shape (BH 8 over 4 kv heads, S
//     3,000) the kernel with it ran at 2.3x the time without it; with
//     fast_tanh, 1.15x.  The softcap and the mask take their loops once a
//     tile (kFlat's form), so the loop without a softcap carries none of
//     its steps (phase 12 (i)'s split in chip_smoke.py times all three);
//   * a grid of fewer blocks than the card holds (plan: recurrentgemma-2b's
//     prompts of 512 and 1,000 tokens) cuts each q tile's kv range into
//     shares, one block each, and flash_wgmma_combine joins a q tile's
//     shares in order; a grid that fills the card is not cut, since
//     shares there were slower at every count timed.
//
// Interface: plain C, bound from Python with ctypes.  The entry point
// launches on the caller's stream, allocates nothing, does not
// synchronise, and returns a CUDA error code (0 on success).

#include <math.h>

#include "hopper_wgmma.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block: one warpgroup's M
constexpr int kStages = 2;     // K/V ring
constexpr int kThreads = 128;  // one warpgroup
constexpr float kNegInf = -2.3819763e38f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxSplits = 8;  // kv shares of one q tile, at most

enum Kind { kGlobal = 0, kLocal = 1, kChunked = 2 };

// Shared memory of one block: Q, then the K ring, then the V ring, then
// the barriers; every tile starts on a 1,024-byte boundary (the 128-byte
// swizzle repeats every 8 rows of 128 bytes).
template <int DQK, int DV, int BK>
struct Layout {
  static constexpr int kQKW = padded_cols(DQK), kVW = padded_cols(DV);  // kept columns
  static constexpr uint32_t kQBytes = kBQ * kQKW * 2;
  static constexpr uint32_t kKTile = BK * kQKW * 2;  // one K tile
  static constexpr uint32_t kVTile = BK * kVW * 2;   // one V tile
  static constexpr uint32_t kK = kQBytes;
  static constexpr uint32_t kV = kK + kStages * kKTile;
  static constexpr uint32_t kBar = kV + kStages * kVTile;
  // kStages full barriers and the Q barrier, then slack to align the base
  static constexpr uint32_t kBytes = kBar + 8 * (kStages + 1) + 1024;
};

// Whether key kp is visible from query qp under the mask.
__device__ __forceinline__ bool visible(int qp, int kp, int causal, int kind, int window) {
  bool ok = !causal || qp >= kp;
  if (kind == kLocal) ok = ok && (qp - kp) < window;
  else if (kind == kChunked) ok = ok && (qp / window) == (kp / window);
  return ok;
}

// The kv tiles of BK keys that any row of the q tile at q0 may see:
// k_first, the first tile's first key, and n_tiles.
__host__ __device__ inline void kv_tiles(int q0, int S, int BK, int causal, int kind,
                                         int window, int& k_first, int& n_tiles) {
  const int q_last = (q0 + kBQ < S ? q0 + kBQ : S) - 1;
  int lo = 0, hi = S;
  if (causal) hi = q_last + 1;
  if (kind == kLocal) {
    lo = q0 - window + 1 > 0 ? q0 - window + 1 : 0;
  } else if (kind == kChunked) {
    lo = (q0 / window) * window;
    const int end = (q_last / window + 1) * window;
    hi = hi < end ? hi : end;
  }
  k_first = (lo / BK) * BK;
  n_tiles = (hi - k_first + BK - 1) / BK;
}

// grid (bh, n_q * splits), taken in groups of `heads` query heads
// (order_heads): row splits * i + z of a head is share z of its i-th q
// tile counted from the last (longest first, a q tile's shares side by
// side).  With split_tiles > 0, share z takes kv tiles [z split_tiles,
// (z + 1) split_tiles) of its q tile; a q tile with more than one share
// writes its unnormalised output, running maximum and sum to `part`,
// (splits, BH, S, DV) outputs, then (splits, BH, S) maxima, then (splits,
// BH, S) sums, which flash_wgmma_combine joins; a q tile whose kv tiles
// fit in one share writes o and lse itself.  cap_k2 is 2 log2(e) scale /
// softcap (fast_tanh's constant; unused without a softcap).
template <int DQK, int DV, int BK, bool kFlat = false>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                   float* __restrict__ lse, float* __restrict__ part, int S, int group,
                   float scale, int causal, int kind, int window, float softcap, float cap_k2,
                   int splits, int split_tiles, int heads) {
  using L = Layout<DQK, DV, BK>;
  constexpr int kQKCols = col_blocks(DQK);  // 128-byte column blocks per row
  constexpr int kVCols = col_blocks(DV);
  constexpr int kVW = L::kVW;  // O's columns in the accumulator
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;
  const uint32_t sk = base + L::kK;
  const uint32_t sv = base + L::kV;
  const uint32_t full = base + L::kBar;  // stage st: full + 8 * st
  const uint32_t qbar = full + 8 * kStages;

  const int tid = threadIdx.x;
  // launch order (x fastest): groups of `heads` query heads, each group's
  // q tiles longest first with its heads side by side; row y of a head is
  // share y % splits of the (y / splits)-th q tile counted from the last
  const long long b = blockIdx.x + (long long)gridDim.x * blockIdx.y;
  const long long per_group = (long long)heads * gridDim.y;
  const int r = (int)(b % per_group);
  const int bh = (int)(b / per_group) * heads + r % heads;
  const int kvh = bh / group;
  const int n_q = (S + kBQ - 1) / kBQ;
  const int q0 = (n_q - 1 - r / heads / splits) * kBQ;
  const int share = r / heads % splits;

  // the kv tiles this block takes: all of the q tile's, or its share
  int k_first, n_tiles, n_shares = 1;
  kv_tiles(q0, S, BK, causal, kind, window, k_first, n_tiles);
  if (split_tiles > 0) {
    n_shares = (n_tiles + split_tiles - 1) / split_tiles;
    if (share >= n_shares) return;  // an empty share: the combine reads none
    k_first += share * split_tiles * BK;
    n_tiles = min(split_tiles, n_tiles - share * split_tiles);
  }

  auto load_kv = [&](int st, int k0) {
    const uint32_t bar = full + 8 * st;
    mbar_expect_tx(bar, L::kKTile + L::kVTile);
#pragma unroll
    for (int c = 0; c < kQKCols; ++c)
      tma_load_3d(sk + st * L::kKTile + c * BK * 128, &tk, bar, c * kColBlock, k0, kvh);
#pragma unroll
    for (int c = 0; c < kVCols; ++c)
      tma_load_3d(sv + st * L::kVTile + c * BK * 128, &tv, bar, c * kColBlock, k0, kvh);
  };

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(full + 8 * st, 1);
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(qbar, L::kQBytes);
#pragma unroll
    for (int c = 0; c < kQKCols; ++c)
      tma_load_3d(sq + c * kBQ * 128, &tq, qbar, c * kColBlock, q0, bh);
    for (int st = 0; st < kStages && st < n_tiles; ++st) load_kv(st, k_first + st * BK);
  }

  // thread layout of a wgmma accumulator: warp w owns rows 16w .. 16w+15;
  // a thread holds rows r0 and r0 + 8, columns 8j + 2 * (lane % 4) + {0, 1}
  const int warp = tid / 32, lane = tid % 32;
  const int r0 = 16 * warp + lane / 4;
  const int cq = 2 * (lane % 4);
  const int qp0 = q0 + r0, qp1 = qp0 + 8;

  float acc[kVW / 2];
#pragma unroll
  for (int i = 0; i < kVW / 2; ++i) acc[i] = 0.0f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;

  mbar_wait(qbar, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages;
    const int k0 = k_first + it * BK;
    mbar_wait(full + 8 * st, (it / kStages) & 1);

    // S = Q K^T over DQK in steps of 16: column block c, 32-byte step
    // within it (the swizzle is applied by the hardware to the address)
    float s[BK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DQK / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      const uint64_t da = sw128_desc(sq + (kk / 4) * kBQ * 128 + off, 16, 1024);
      const uint64_t db =
          sw128_desc(sk + st * L::kKTile + (kk / 4) * BK * 128 + off, 16, 1024);
      wgmma_ss<BK>(s, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // scale, softcap, then the mask (whole tiles the mask shows to every
    // row skip it; keys past S always take -inf)
    const int q_hi = q0 + kBQ - 1;
    bool whole = k0 + BK <= S;
    if (causal) whole = whole && k0 + BK - 1 <= q0;
    if (kind == kLocal) whole = whole && q_hi - k0 < window;
    else if (kind == kChunked)
      whole = whole && q0 / window == q_hi / window && k0 / window == q0 / window &&
              (k0 + BK - 1) / window == q0 / window;
    if (kFlat || softcap > 0.0f) {
      // the same steps, each test taken once a tile; the softcap's tanh
      // from fast_tanh (two MUFU steps and no division a score)
      if (softcap > 0.0f) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          float r;
          s[i] = fast_tanh(s[i], cap_k2, r) * softcap;
        }
      } else {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) s[i] *= scale;
      }
      if (!whole) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int kp = k0 + 8 * (i / 4) + cq + (i % 2);
          const int qp = (i % 4) < 2 ? qp0 : qp1;
          if (!visible(qp, kp, causal, kind, window)) s[i] = kNegInf;
          if (kp >= S) s[i] = -INFINITY;
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        float x = s[i] * scale;
        if (!whole) {
          const int kp = k0 + 8 * (i / 4) + cq + (i % 2);
          const int qp = (i % 4) < 2 ? qp0 : qp1;
          if (!visible(qp, kp, causal, kind, window)) x = kNegInf;
          if (kp >= S) x = -INFINITY;
        }
        s[i] = x;
      }
    }

    // online softmax; a row's four threads are lanes 4g .. 4g+3
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < BK / 2; i += 4) {
      mx0 = fmaxf(mx0, fmaxf(s[i], s[i + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[i + 2], s[i + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp2f((m0 - mn0) * kLog2e), al1 = exp2f((m1 - mn1) * kLog2e);
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int i = 0; i < BK / 2; i += 4) {
      s[i] = exp2f((s[i] - mn0) * kLog2e);
      s[i + 1] = exp2f((s[i + 1] - mn0) * kLog2e);
      s[i + 2] = exp2f((s[i + 2] - mn1) * kLog2e);
      s[i + 3] = exp2f((s[i + 3] - mn1) * kLog2e);
      sum0 += s[i] + s[i + 1];
      sum1 += s[i + 2] + s[i + 3];
    }
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
    l0 = l0 * al0 + sum0;
    l1 = l1 * al1 + sum1;
    m0 = mn0;
    m1 = mn1;

    // p as bf16 in the A operand's register layout: keys 16kk .. 16kk+15
    // are accumulator chunks 2kk (registers 8kk .. 8kk+3) and 2kk+1
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);  // row r0, keys +0..7
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);  // row r0 + 8
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);  // row r0, keys +8..15
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);  // row r0 + 8
    }
#pragma unroll
    for (int i = 0; i < kVW / 2; i += 4) {
      acc[i] *= al0;
      acc[i + 1] *= al0;
      acc[i + 2] *= al1;
      acc[i + 3] *= al1;
    }

    // O += P V over the tile's keys in steps of 16: V rows are 128-byte
    // swizzled rows of each column block; LBO steps from one column block
    // to the next, SBO from one 8-row group to the next
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t db = sw128_desc(sv + st * L::kVTile + kk * 16 * 128, BK * 128, 1024);
      wgmma_rs_tb<kVW>(acc, pa[kk], db);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(pa);

    // every warp is done with this stage: refill it with tile it + kStages
    __syncthreads();
    if (tid == 0 && it + kStages < n_tiles) load_kv(st, k0 + kStages * BK);
  }

  if (n_shares > 1) {
    // this share's unnormalised O, m and l for the combine (a row's four
    // threads hold the same m and l, the first writes them)
    const long long rows = (long long)gridDim.x * S;
    float* po = part + ((long long)share * rows + (long long)bh * S) * DV;
    float* pm = part + (long long)splits * rows * DV + share * rows + (long long)bh * S;
    float* pl = pm + (long long)splits * rows;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      if (qp0 < S)
        *reinterpret_cast<float2*>(po + (long long)qp0 * DV + 8 * j + cq) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
      if (qp1 < S)
        *reinterpret_cast<float2*>(po + (long long)qp1 * DV + 8 * j + cq) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
    if (cq == 0 && qp0 < S) {
      pm[qp0] = m0;
      pl[qp0] = l0;
    }
    if (cq == 0 && qp1 < S) {
      pm[qp1] = m1;
      pl[qp1] = l1;
    }
    return;
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  // each row's log-sum-exp for the backward, when asked for: a row's four
  // threads hold the same m and l, the first writes them
  if (lse != nullptr && cq == 0) {
    if (qp0 < S) lse[(long long)bh * S + qp0] = m0 + logf(d0);
    if (qp1 < S) lse[(long long)bh * S + qp1] = m1 + logf(d1);
  }
  // O's first DV columns (at D = 80 the accumulator's last 48 are zero)
  __nv_bfloat16* ob = o + (long long)bh * S * DV;
  if (qp0 < S) {
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)qp0 * DV + 8 * j + cq) =
          __floats2bfloat162_rn(acc[4 * j] / d0, acc[4 * j + 1] / d0);
    }
  }
  if (qp1 < S) {
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)qp1 * DV + 8 * j + cq) =
          __floats2bfloat162_rn(acc[4 * j + 2] / d1, acc[4 * j + 3] / d1);
    }
  }
}


// A split q tile's rows joined: o = sum_z e^(m_z - m) acc_z / max(sum_z
// e^(m_z - m) l_z, 1e-30), m the largest m_z, over the q tile's shares in
// order (no atomics: the same bits every call), written in bf16 with the
// row's lse.  One warp a row of DV outputs, two columns a lane at a time;
// rows of q tiles that one share held were written by the main kernel.
template <int DV, int BK>
__global__ void __launch_bounds__(256)
flash_wgmma_combine(const float* __restrict__ part, __nv_bfloat16* __restrict__ o,
                    float* __restrict__ lse, int bh_rows, int S, int splits,
                    int split_tiles, int causal, int kind, int window) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;  // bh * S + qp
  const int lane = threadIdx.x % 32;
  const long long rows = (long long)bh_rows * S;
  if (row >= rows) return;
  int k_first, n_tiles;
  kv_tiles((int)(row % S) / kBQ * kBQ, S, BK, causal, kind, window, k_first, n_tiles);
  const int n = (n_tiles + split_tiles - 1) / split_tiles;
  if (n <= 1) return;
  const float* pm = part + (long long)splits * rows * DV + row;
  const float* pl = pm + (long long)splits * rows;
  float m = pm[0];
  for (int z = 1; z < n; ++z) m = fmaxf(m, pm[z * rows]);
  float w[kMaxSplits];
  float l = 0.0f;
#pragma unroll
  for (int z = 0; z < kMaxSplits; ++z) {
    w[z] = z < n ? exp2f((pm[z * rows] - m) * kLog2e) : 0.0f;
    if (z < n) l += w[z] * pl[z * rows];
  }
  const float d = fmaxf(l, 1e-30f);
  if (lse != nullptr && lane == 0) lse[row] = m + logf(d);
  for (int c = 2 * lane; c < DV; c += 64) {
    float x = 0.0f, y = 0.0f;
#pragma unroll
    for (int z = 0; z < kMaxSplits; ++z) {
      if (z < n) {
        const float2 a = *reinterpret_cast<const float2*>(part + (z * rows + row) * DV + c);
        x += w[z] * a.x;
        y += w[z] * a.y;
      }
    }
    *reinterpret_cast<__nv_bfloat162*>(o + row * DV + c) = __floats2bfloat162_rn(x / d, y / d);
  }
}

// The kv shares to cut each q tile's kv range into, and `most`, the kv
// tiles of the longest q tile.  Where the grid's (bh x q tiles) blocks
// leave some of the card's block slots (SMs times the blocks an SM holds)
// empty, ceil(slots / blocks) shares, at most kMaxSplits and `most`; else
// one.  Shares of a grid that fills the card were slower at every count
// timed on the H100: a q tile's shares write and reread f32 partials, and
// the longest q tiles, launched first, finish alone on their SMs at full
// speed.  At recurrentgemma-2b's 10 heads, S 512 and 1,000 (80 and 160
// blocks for 264 slots), 4 and 2 shares were the fastest counts.  The SM
// count is the current device's (132 when the query fails).
template <int DQK, int DV, int BK, bool kFlat>
int plan(int bh, int s, int causal, int kind, int window, int& most) {
  most = 1;
  for (int q0 = 0; q0 < s; q0 += kBQ) {
    int k_first, n_tiles;
    kv_tiles(q0, s, BK, causal, kind, window, k_first, n_tiles);
    most = n_tiles > most ? n_tiles : most;
  }
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      sms <= 0)
    sms = 132;
  // the blocks an SM holds (the kernel's registers and shared memory), asked once
  static const int per_sm = []() {
    const int smem = (int)Layout<DQK, DV, BK>::kBytes;
    int n = 0;
    if (cudaFuncSetAttribute(flash_wgmma_kernel<DQK, DV, BK, kFlat>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, flash_wgmma_kernel<DQK, DV, BK, kFlat>, kThreads, smem) != cudaSuccess)
      return 1;
    return n > 0 ? n : 1;
  }();
  const long long blocks = (long long)bh * ((s + kBQ - 1) / kBQ);
  const long long slots = (long long)sms * per_sm;
  if (blocks >= slots) return 1;
  const int splits = (int)((slots + blocks - 1) / blocks);
  const int cap = most < kMaxSplits ? most : kMaxSplits;
  return splits < cap ? splits : cap;
}

// The query heads a group of the launch order takes.  Where every kv
// head's K and V fit in the L2 cache together, all of them: the q tiles
// go longest first over every head (the balance the causal grid needs).
// Else the query heads of the most kv heads (a divisor of bh / group)
// whose K and V fit in a third of it, at least one kv head's: MLA's 128
// heads at S 2,048 (1.3 MB of K and V each, 168 MB in all) go 8 kv heads
// at a time, where all 128 at once had each block read its K and V tiles
// from device memory (the forward took about as long as those 2.7 GB at
// 3.35 TB/s: 0.78 ms, against 0.46 grouped, on the H100).  Groups of a
// third of the L2 were timed against a sixth and two thirds there, and
// grouping K and V that fit (gemma-7b's 49 MB) was slower.
int order_heads(int bh, int s, int group, int dqk, int dv) {
  const int bh_kv = bh / group;
  const long long per_head = (long long)s * (padded_cols(dqk) + padded_cols(dv)) * 2;
  int dev = 0, l2 = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, dev) != cudaSuccess || l2 <= 0)
    l2 = 50 << 20;
  if (bh_kv * per_head <= l2) return bh;
  int best = 1;
  for (int h = 1; h <= bh_kv; ++h)
    if (bh_kv % h == 0 && h * per_head <= l2 / 3) best = h;
  return best * group;
}

template <int DQK, int DV, int BK, bool kFlat>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   float* part, int bh, int s, int group, int causal, int kind, int window,
                   float softcap, int splits, cudaStream_t stream) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  int most;
  if (splits != plan<DQK, DV, BK, kFlat>(bh, s, causal, kind, window, most) ||
      (splits > 1 && part == nullptr))
    return cudaErrorInvalidValue;  // the scratch was sized for another plan
  const int split_tiles = splits > 1 ? (most + splits - 1) / splits : 0;
  CUtensorMap mq, mk, mv;
  if (!encode_map(enc, &mq, q, bh, s, DQK, kBQ) ||
      !encode_map(enc, &mk, k, bh / group, s, DQK, BK) ||
      !encode_map(enc, &mv, v, bh / group, s, DV, BK))
    return cudaErrorInvalidValue;
  const int smem = (int)Layout<DQK, DV, BK>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_wgmma_kernel<DQK, DV, BK, kFlat>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const double scale = 1.0 / sqrt((double)DQK);
  const float cap_k2 = softcap > 0.0f ? (float)(2.0 * kLog2e * scale / softcap) : 0.0f;
  const dim3 grid(bh, ((s + kBQ - 1) / kBQ) * splits);
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(o);
  flash_wgmma_kernel<DQK, DV, BK, kFlat><<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, ob, lse, part, s, group, (float)scale, causal, kind, window, softcap,
      cap_k2, splits, split_tiles, order_heads(bh, s, group, DQK, DV));
  err = cudaGetLastError();
  if (err != cudaSuccess || split_tiles == 0) return err;
  const long long rows = (long long)bh * s;
  flash_wgmma_combine<DV, BK><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      part, ob, lse, bh, s, splits, split_tiles, causal, kind, window);
  return cudaGetLastError();
}

// An instantiation of the kernel: head dims, keys per kv tile, kFlat.
template <int A, int B, int C, bool F>
struct Inst {
  static constexpr int DQK = A, DV = B, BK = C;
  static constexpr bool kFlat = F;
};

// f(Inst<...>{}) for the instantiation that takes head dims (d, dv), or
// `refused` for head dims none takes.  Keys per kv tile: 32 at D = 256 and
// 128 (at D = 256, Q and a two-stage ring of 32-key tiles take 97 KB, so
// two blocks share an SM, where 64-key tiles would take 161 KB and leave
// the SM one block), 64 at D = 64.  Both sizes were timed at the serving
// shape on the H100; these were the faster.  At (192, 128), 64 keys: Q
// (24 KB) and two stages of K (24 KB) and V (16 KB) take 106 KB, so two
// blocks still share an SM, and S is an m64n64 accumulator of 32 floats a
// thread beside O's 64.  At D = 80, 64 keys (32 and 64 were timed at
// hubert-xlarge's shape on the H100 with kFlat; 64 was the faster): Q and
// two stages of K and V, each two padded blocks, take 81 KB, two blocks
// an SM.  Registers and spills: chip_smoke.py's phase 0.
template <typename F>
int dispatch(int d, int dv, int refused, F&& f) {
  if (d == 192 && dv == 128) return f(Inst<192, 128, 64, false>{});
  if (d != dv) return refused;
  switch (d) {
    case 64: return f(Inst<64, 64, 64, false>{});
    case 80: return f(Inst<80, 80, 64, true>{});
    case 128: return f(Inst<128, 128, 32, false>{});
    case 256: return f(Inst<256, 256, 32, false>{});
    default: return refused;
  }
}

}  // namespace

// The number of kv shares flash_attention_wgmma_fwd cuts each q tile's
// kv range into for this call on the current device (1: no split), or 0
// for arguments it refuses.
extern "C" int flash_attention_wgmma_splits(int bh, int s, int d, int dv, int causal,
                                            int kind, int window) {
  if (kind != kGlobal && window < 1) return 0;
  return dispatch(d, dv, 0, [&](auto inst) {
    using I = decltype(inst);
    int most;
    return bh <= 0 || s <= 0
               ? 1
               : plan<I::DQK, I::DV, I::BK, I::kFlat>(bh, s, causal, kind, window, most);
  });
}

// q: (bh, s, d), k: (bh / group, s, d), v: (bh / group, s, dv), o: (bh,
// s, dv), bf16, contiguous, 16-byte aligned, on the current device; d = dv
// in {64, 80, 128, 256}, or d = 192 with dv = 128 (MLA).  kind: 0 global, 1
// local, 2 chunked.  lse: null, or (bh, s) f32 that takes each row's
// log-sum-exp of its scaled, softcapped, masked scores (natural log:
// m + log(max(l, 1e-30))), which the backward of
// flash_attention_bwd_wgmma.cu reads; serving passes null.  splits:
// flash_attention_wgmma_splits' answer; above 1, `part` is scratch of
// splits * bh * s * (dv + 2) f32 for the shares' partials, joined by a
// second launch (else unused, and may be null).
extern "C" int flash_attention_wgmma_fwd(const void* q, const void* k, const void* v,
                                         void* o, float* lse, float* part, int bh, int s,
                                         int d, int dv, int group, int causal, int kind,
                                         int window, double softcap, int splits,
                                         void* stream) {
  if (bh <= 0 || s <= 0) return (int)cudaSuccess;
  if (group <= 0 || bh % group) return (int)cudaErrorInvalidValue;
  if (kind != kGlobal && window < 1) return (int)cudaErrorInvalidValue;
  return dispatch(d, dv, (int)cudaErrorInvalidValue, [&](auto inst) {
    using I = decltype(inst);
    return (int)launch<I::DQK, I::DV, I::BK, I::kFlat>(
        q, k, v, o, lse, part, bh, s, group, causal, kind, window, (float)softcap, splits,
        (cudaStream_t)stream);
  });
}
