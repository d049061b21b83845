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
// mask; masked scores take the finite value -2.3819763e38 and keys past S
// take -inf; the running (m, l, acc) are f32, l sums the f32 p, p is
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
//     gives 180 at D = 256, so two blocks fit in an SM's 65,536);
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
//   * q tiles are launched longest first: blockIdx.y counts q tiles from
//     the last, whose causal or local kv range is the widest, and
//     blockIdx.x runs over bh, so the blocks sharing one kv head (MQA
//     10:1 at the serving shape) start together and share K and V in L2.
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

template <int DQK, int DV, int BK, bool kFlat = false>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                   float* __restrict__ lse, int S, int group, float scale, int causal,
                   int kind, int window, float softcap) {
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
  const int bh = blockIdx.x;
  const int kvh = bh / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest tiles first

  // the keys any row of this tile may see: [lo, hi)
  const int q_last = min(q0 + kBQ, S) - 1;
  int lo = 0, hi = S;
  if (causal) hi = q_last + 1;
  if (kind == kLocal) {
    lo = max(0, q0 - window + 1);
  } else if (kind == kChunked) {
    lo = (q0 / window) * window;
    hi = min(hi, (q_last / window + 1) * window);
  }
  const int k_first = (lo / BK) * BK;
  const int n_tiles = (hi - k_first + BK - 1) / BK;

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
    if constexpr (kFlat) {
      // the same steps, each test taken once a tile
      if (softcap > 0.0f) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) s[i] = tanhf(s[i] * scale / softcap) * softcap;
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
        if (softcap > 0.0f) x = tanhf(x / softcap) * softcap;
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


template <int DQK, int DV, int BK, bool kFlat = false>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                   int s, int group, int causal, int kind, int window, float softcap,
                   cudaStream_t stream) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap mq, mk, mv;
  if (!encode_map(enc, &mq, q, bh, s, DQK, kBQ) ||
      !encode_map(enc, &mk, k, bh / group, s, DQK, BK) ||
      !encode_map(enc, &mv, v, bh / group, s, DV, BK))
    return cudaErrorInvalidValue;
  const int smem = (int)Layout<DQK, DV, BK>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_wgmma_kernel<DQK, DV, BK, kFlat>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const float scale = (float)(1.0 / sqrt((double)DQK));
  const dim3 grid(bh, (s + kBQ - 1) / kBQ);
  flash_wgmma_kernel<DQK, DV, BK, kFlat><<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), lse, s, group, scale, causal, kind,
      window, softcap);
  return cudaGetLastError();
}

}  // namespace

// q: (bh, s, d), k: (bh / group, s, d), v: (bh / group, s, dv), o: (bh,
// s, dv), bf16, contiguous, 16-byte aligned, on the current device; d = dv
// in {64, 80, 128, 256}, or d = 192 with dv = 128 (MLA).  kind: 0 global, 1
// local, 2 chunked.  lse: null, or (bh, s) f32 that takes each row's
// log-sum-exp of its scaled, softcapped, masked scores (natural log:
// m + log(max(l, 1e-30))), which the backward of
// flash_attention_bwd_wgmma.cu reads; serving passes null.
//
// Keys per kv tile, by head dims: 32 at D = 256 and 128 (at D = 256, Q and
// a two-stage ring of 32-key tiles take 97 KB, so two blocks share an SM,
// where 64-key tiles would take 161 KB and leave the SM one block), 64 at
// D = 64.  Both sizes were timed at the serving shape on the H100; these
// were the faster.  At (192, 128), 64 keys: Q (24 KB) and two stages of K
// (24 KB) and V (16 KB) take 106 KB, so two blocks still share an SM, and
// S is an m64n64 accumulator of 32 floats a thread beside O's 64.  At
// D = 80, 64 keys (32 and 64 were timed at hubert-xlarge's shape on the
// H100 with kFlat; 64 was the faster): Q and two stages of K and V, each
// two padded blocks, take 81 KB, two blocks an SM (ptxas: 138 registers,
// no spill, printed by chip_smoke.py's phase 0).
extern "C" int flash_attention_wgmma_fwd(const void* q, const void* k, const void* v,
                                         void* o, float* lse, int bh, int s, int d, int dv,
                                         int group, int causal, int kind, int window,
                                         double softcap, void* stream) {
  if (bh <= 0 || s <= 0) return (int)cudaSuccess;
  if (group <= 0 || bh % group) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const float cap = (float)softcap;
  if (d == 192 && dv == 128)
    return (int)launch<192, 128, 64>(q, k, v, o, lse, bh, s, group, causal, kind, window,
                                     cap, st);
  if (d != dv) return (int)cudaErrorInvalidValue;
  switch (d) {
    case 64:
      return (int)launch<64, 64, 64>(q, k, v, o, lse, bh, s, group, causal, kind, window,
                                     cap, st);
    case 80:
      return (int)launch<80, 80, 64, true>(q, k, v, o, lse, bh, s, group, causal, kind,
                                           window, cap, st);
    case 128:
      return (int)launch<128, 128, 32>(q, k, v, o, lse, bh, s, group, causal, kind, window,
                                       cap, st);
    case 256:
      return (int)launch<256, 256, 32>(q, k, v, o, lse, bh, s, group, causal, kind, window,
                                       cap, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
