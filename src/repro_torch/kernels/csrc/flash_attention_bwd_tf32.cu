// Attention backward on Hopper's tensor cores at f32 accuracy (sm_90a):
// the f32 path for q/k and v head dims (D, Dv) = (64, 64), (96, 96),
// (128, 128), (256, 256) and MLA's (192, 128), with or without a softcap,
// the gradient of flash_attention_tf32.cu.
//
// The Pallas TPU kernel `flash_attention` (src/repro/kernels/
// flash_attention.py:77) has no backward: the reference trains through
// `blockwise_attention` (src/repro/models/attention.py:118), which XLA
// differentiates.  This kernel computes what flash_attention_bwd.cu (the
// first design, f32 on the CUDA cores, which keeps the other head dims)
// computes:
//   q (BH, S, D), o and dO (BH, S, Dv), k (BH / G, S, D) and v (BH / G,
//   S, Dv) f32, lse (BH, S) f32
//   -> dq (BH, S, D), dk (BH / G, S, D) and dv (BH / G, S, Dv) f32,
// with the forward's masks (causal, `local` within `window`, `chunked`)
// and its optional tanh softcap c; query row bh reads kv row bh / G.  lse
// is each row's log-sum-exp in natural-log units, written by the 3xTF32
// forward when a gradient will be taken, so no launch recomputes it.
//
// Arithmetic (FA2's backward): with s the scaled scores, p = exp(s - lse)
// on the pairs the mask keeps and 0 elsewhere, and D_i = rowsum(dO * O),
//   dv_j = sum_i p_ij dO_i          dp_ij = dO_i . v_j
//   ds_ij = p_ij (dp_ij - D_i)
//   dq_i = sum_j ds_ij k_j / sqrt(D)   dk_j = sum_i ds_ij q_i / sqrt(D)
// With a softcap (the CAP instantiations) each pair's raw score x = q.k is
// recomputed, t = tanh(x / (sqrt(D) c)) by tanhf, the capped score is c t,
// p = exp(c t - lse) and ds_ij = p_ij (dp_ij - D_i) (1 - t^2): the cap's
// derivative, as the bf16 wgmma backward has it, but with tanhf (2 ulps)
// where that kernel's fast_tanh takes ex2.approx and rcp.approx.  The
// forward forms its scores in double (its header says why); here a score
// moves p by at most some 1e-5 of itself, inside the gradients' tolerance
// (1e-5 of an element plus 1e-4 of the largest), so the f32 tanh serves.
// Every product runs on the tensor cores in TF32 with three terms
// (3xTF32), as in the forward: each f32 operand x is split into hi =
// tf32(x) and lo = tf32(x - hi), and a product is lo_a hi_b + hi_a lo_b +
// hi_a hi_b summed in f32, which leaves some 2^-23 of it where one TF32
// product would leave 2^-11.  p and ds are split like any operand.
//
// What bounds it on this card: operations.  The least work is five
// products per kept pair, s, dq and dk over D and dp and dv over Dv (6*D
// + 4*Dv; 10*D where Dv = D), at the TF32 rate (495 TFLOP/s); at the
// serving shape (D = 256, local window 2,048, MQA 10:1) and at MLA's
// (BH 128, causal, S 3,000) that is far above the bytes.  3xTF32 triples
// each product; the dK/dV side does four (s, dp, dv, dk) and the dQ side
// three (s and dp again, dq): 6*(4*D + 3*Dv) a pair on the tensor cores
// (42*D where Dv = D), where the first design did 18*D on the CUDA cores
// (67 TFLOP/s at most).
//
// Why mma.sync and not wgmma: the forward's reason (flash_attention_tf32.cu)
// holds.  wgmma reads TF32 operands only K-major from shared memory, so
// Q, dO, K and V would need transposed copies and their hi and lo parts
// staged apart; at D = 256 that leaves no room for a second stage.
// mma.sync (m16n8k8, TF32) takes both operands from registers: the tiles
// are staged once, as f32, and each warp splits what it loads.
//
// Three launches on the caller's stream, no atomics (two runs give
// bitwise the same gradients): flash_attention_bwd_wgmma.cu's structure
// for bf16 with its dK/dV and dQ launches joined:
//   1. attn_bwd_tf32_delta_kernel: D_i in f32, a warp a row;
//   2. attn_bwd_tf32_main_kernel, whose blocks are of two kinds:
//      dK/dV blocks, one per (share, key tile of 32, kv row).  A key
//      tile's work is the list of (query head of the group, query tile of
//      32 it can see); it is cut into runs of `per` items, one block each
//      (blocks past the list return), so the grid fills the SMs where (key
//      tiles x kv rows) alone would not, and the key tiles near the
//      diagonal, which few query tiles see, take fewer blocks.  Each keeps
//      its K and V tile in shared memory, streams (Q, dO) tiles through a
//      two-stage cp.async ring, and sums P^T dO and dS^T Q into f32 dK and
//      dV in registers, written to its share's slot of a scratch buffer.
//      Then dQ blocks, one per (bh, query tile of 32), longest first:
//      each keeps Q and dO, streams (K, V) tiles of the keys it can see,
//      and sums dS K into dq in registers.  In one grid the SMs that
//      finish their dK/dV blocks take dQ blocks at once, where two
//      launches left a tail of each.  flash_attention_bwd_tf32_shares
//      picks the share count from the occupancy and both kinds' work;
//   3. attn_bwd_tf32_sum_kernel: dK and dV are the shares' partials summed
//      in share order, dK scaled.
//
// Warps: eight a block, two row groups of 16 (keys on the dK/dV side,
// query rows on the dQ side) with four warps each.  Of a row group's
// four, two compute the score tile (16 x 32, over D) and two the dP tile
// (over Dv), two n-blocks of 8 columns each; they meet through shared
// memory (a named barrier of the group's 128 threads), where the dP
// warps turn p and dp into ds (with a softcap the P warps hand them p (1
// - t^2): on the dK/dV side in ds's slot, beside p, on the dQ side in p's).  Then each warp takes the product of p or
// ds with its share of the columns: on the dK/dV side the P warps own dV
// (half of Dv each) and the dS warps dK (half of D each); on the dQ side
// all four own a quarter of dq.  At D = 256 a thread holds 64 f32 of dK
// or dV (32 of dq).  The transposed products (P^T dO, dS^T Q) need no
// shuffle: the score accumulator is already P^T's A fragment when logical
// k = t is read as query 2t and k = t + 4 as query 2t + 1, and the B
// fragment takes dO's (or Q's) rows 2t and 2t + 1 to match, as the
// forward does for P V.
//
// MLA's (192, 128): Q and K rows are staged at D + 4 floats, V and dO
// rows at Dv + 4, so a block's two fixed tiles, its two-stage ring and
// the exchange take 134,656 bytes, one block an SM as at D = 256.  The
// score warps' product runs 24 k8 steps, the dP warps' 16, so the dP
// warps wait at the exchange for a third of the score warps' time; and
// the dS warps own dK's 96 columns a half (12 n-blocks, 48 f32 a thread)
// where the P warps own dV's 64 (8 n-blocks, 32 f32).  The dQ side's
// warps own 48 columns of dq each (6 n-blocks).  The layout is kept
// simple (the same roles at every (D, Dv)); balancing the two kinds of
// warp is later work.  ptxas (CUDA 12 on the H100's machine, printed by
// chip_smoke.py's phase 0): the main kernel 197 registers at (192, 128),
// 228 at (256, 256), 147 at (128, 128), 110 at (64, 64), no spill.
//
// (96, 96), the ~100M training example's head dim: rows staged at 100
// floats (no product on padding, fragment loads on distinct banks), the
// score and dP warps both 12 k8 steps, the dK and dV halves 6 n-blocks
// each, dq's quarters 3; the tiles, ring and exchange take 85,504 bytes
// and ptxas gives the main kernel 128 registers (softcap or not), so two
// blocks share an SM (the share count reads the occupancy).
//
// Masks: tiles that the mask hides from every pair are skipped (the key
// tile's query range, the query tile's key range); tiles that it shows
// whole skip the per-element test.  Rows and keys past S load zeros
// (cp.async's zero fill) and take p = 0; they are not written.
//
// Interface: plain C, bound from Python with ctypes.  The entry point
// launches on the caller's stream, allocates nothing (the wrapper passes
// D_i's (BH, S) f32 buffer and the partials' scratch), does not
// synchronise, and returns a CUDA error code (0 on success).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kT = 32;            // query rows and keys per tile
constexpr int kThreads = 256;     // eight warps: two row groups of four
constexpr int kPad = 4;           // floats of padding per staged row
constexpr int kDeltaRows = 8;     // D_i rows per block, a warp each

enum Kind { kGlobal = 0, kLocal = 1, kChunked = 2 };

struct Mask {
  int S, causal, kind, window;
  float scale;
  float softcap, cap_scale;  // c and 1 / (sqrt(D) c); 0 without a softcap

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

  // key tile k0's query tiles: qt0 .. qt0 + n_qt - 1 (each query head of
  // the group takes them all)
  __host__ __device__ void items(int k0, int& qt0, int& n_qt) const {
    int lo, hi;
    query_range(k0, lo, hi);
    qt0 = lo / kT;
    n_qt = (hi - qt0 * kT + kT - 1) / kT;
  }
};

// Items per dK/dV block: the key tiles' longest work list cut into
// `shares` runs.
__host__ __device__ inline int items_per_share(int most, int shares) {
  return (most + shares - 1) / shares;
}

// A staged tile of kT rows of W floats: rows padded to W + kPad floats,
// so every fragment load of a warp falls on distinct banks.
template <int W>
struct Staged {
  static constexpr int kRow = W + kPad;      // floats per staged row
  static constexpr int kTile = kT * kRow;    // floats of a staged tile
};

// q and k of D columns, v, o and dO of DV.  Each side keeps one tile of
// D columns and one of DV (K and V; Q and dO) and streams pairs of the
// other two through the ring.
template <int D, int DV>
struct Layout {
  static constexpr int kPair = Staged<D>::kTile + Staged<DV>::kTile;
  // the exchange: [row group][p, ds][n-block][element][lane]
  static constexpr int kX = 2 * 2 * 4 * 4 * 32;
  // two fixed tiles, a two-stage ring of two, the exchange, and a stage's
  // lse and D_i (dK/dV side)
  static constexpr size_t kBytes = 4 * (size_t)(3 * kPair + kX + 2 * 2 * kT);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// rows row0 .. row0 + kT - 1 of a (S, W) matrix into a staged tile
template <int W>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int row0, int S) {
  constexpr int kVec = W / 4;  // 16-byte pieces of a row
  for (int e = threadIdx.x; e < kT * kVec; e += kThreads) {
    const int r = e / kVec, c = e % kVec;
    const bool in = row0 + r < S;
    cp_async16(dst + r * Staged<W>::kRow + 4 * c,
               src + (long long)(in ? row0 + r : 0) * W + 4 * c, in);
  }
}

// acc[nb] (16 rows x 8 columns) = A B^T over all W columns: A is the 16
// rows at `a`, B the 8 rows at b + 8 nb * kRow (n-block nb), both staged
// row-major at width W (D for S, Dv for dP).  A thread holds rows g,
// g + 8 and columns 2t, 2t + 1.  As in the forward's Q K^T, the large
// terms hi_a hi_b of each 8 columns are summed from zero on the tensor
// cores and added in f32 with Kahan's compensation, and the small terms
// accumulate on the tensor cores: the tensor core's adds do not round to
// nearest, so a sum over all of W on it has an error that grows with W,
// where this one does not.  The backward's scores then agree with the
// forward's to a few ulps, and p = exp(s - lse) is 1 where a row sees one
// key.
template <int W, int NB>
__device__ __forceinline__ void rows_dot(float (&acc)[NB][4], const float* a, const float* b,
                                         int g, int t) {
  constexpr int R = Staged<W>::kRow;
  float small[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = small[n][e] = 0.0f;
#pragma unroll 4
  for (int kk = 0; kk < W / 8; ++kk) {
    const float* ap = a + g * R + 8 * kk + t;
    uint32_t ahi[4], alo[4];
    split_tf32(ap[0], ahi[0], alo[0]);
    split_tf32(ap[8 * R], ahi[1], alo[1]);
    split_tf32(ap[4], ahi[2], alo[2]);
    split_tf32(ap[8 * R + 4], ahi[3], alo[3]);
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      const float* bp = b + (8 * n + g) * R + 8 * kk + t;
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(bp[0], bh0, bl0);
      split_tf32(bp[4], bh1, bl1);
      float big[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      mma_tf32(big, ahi, bh0, bh1);
      mma_tf32(small[n], alo, bh0, bh1);
      mma_tf32(small[n], ahi, bl0, bl1);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // Kahan: the add's rounding error joins the small terms
        const float y = big[e];
        const float sum = acc[n][e] + y;
        small[n][e] += (acc[n][e] - sum) + y;
        acc[n][e] = sum;
      }
    }
  }
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += small[n][e];
}

// A 16 x 32 tile of p or ds from the exchange (four n-blocks, this
// lane's elements) as A fragments of the k-blocks: logical k = t is
// column 2t of the n-block, k = t + 4 column 2t + 1.
__device__ __forceinline__ void tile_frags(const float* x, int lane, uint32_t (&hi)[4][4],
                                           uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kb = 0; kb < 4; ++kb) {
    const float* v = x + kb * 4 * 32 + lane;  // [n-block][element][lane]
    split_tf32(v[0 * 32], hi[kb][0], lo[kb][0]);  // row g,     column 2t
    split_tf32(v[2 * 32], hi[kb][1], lo[kb][1]);  // row g + 8, column 2t
    split_tf32(v[1 * 32], hi[kb][2], lo[kb][2]);  // row g,     column 2t + 1
    split_tf32(v[3 * 32], hi[kb][3], lo[kb][3]);  // row g + 8, column 2t + 1
  }
}

// acc[j] (16 rows x 8 columns, columns col + 8 j), j < NJ, += X (16 x 32,
// the fragments) B, B the 32 staged rows of width W at `b` (row 2t and
// 2t + 1 of each k-block of 8, matching the fragments' pairing).  Each
// tile's product is summed from zero on the tensor cores and added to acc
// in f32, so the error does not grow with the number of tiles summed (as
// the forward folds P V into O).  acc may hold more n-blocks than NJ (a
// block's warps share one array, sized for the widest).
template <int W, int NJ, int NA>
__device__ __forceinline__ void frags_acc(float (&acc)[NA][4], const uint32_t (&hi)[4][4],
                                          const uint32_t (&lo)[4][4], const float* b, int col,
                                          int g, int t) {
  static_assert(NJ <= NA, "the accumulator holds every n-block");
  constexpr int R = Staged<W>::kRow;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) {
      const float* bp = b + (8 * kb + 2 * t) * R + col + 8 * j + g;
      mma_3xtf32(part, hi[kb], lo[kb], bp[0], bp[R]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += part[e];
  }
}

__device__ __forceinline__ void group_barrier(int r) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + r) : "memory");
}

// ---------------------------------------------------------------------------
// 1. D_i = rowsum(dO * O), over Dv
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(32 * kDeltaRows)
attn_bwd_tf32_delta_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                           float* __restrict__ delta, long long rows, int dv) {
  const long long row = (long long)blockIdx.x * kDeltaRows + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float4* ob = reinterpret_cast<const float4*>(o + row * dv);
  const float4* db = reinterpret_cast<const float4*>(dout + row * dv);
  float acc = 0.0f;
  for (int c = lane; c < dv / 4; c += 32) {
    const float4 a = ob[c], b = db[c];
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
    acc = fmaf(a.z, b.z, acc);
    acc = fmaf(a.w, b.w, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// ---------------------------------------------------------------------------
// 2. dK and dV partials: one block per (share, key tile, kv row)
// ---------------------------------------------------------------------------

template <int D, int DV, bool CAP>
__device__ __forceinline__ void dkdv_block(const float* __restrict__ q,
                                           const float* __restrict__ k,
                                           const float* __restrict__ v,
                                           const float* __restrict__ dout,
                                           const float* __restrict__ lse,
                                           const float* __restrict__ delta,
                                           float* __restrict__ part, int bh_kv, int group,
                                           int shares, int per, const Mask& mask, int share,
                                           int key_tile, int kvh) {
  using L = Layout<D, DV>;
  constexpr int RQ = Staged<D>::kRow, RV = Staged<DV>::kRow;
  constexpr int NJK = D / 16;   // n-blocks of a dS warp's half of D (dK)
  constexpr int NJV = DV / 16;  // n-blocks of a P warp's half of Dv (dV)
  constexpr int NJ = NJK > NJV ? NJK : NJV;
  extern __shared__ float smem[];
  float* sk = smem;
  float* sv = sk + Staged<D>::kTile;
  float* ring = sv + Staged<DV>::kTile;    // stage st: Q, then dO
  float* xch = ring + 2 * L::kPair;
  float* rows = xch + L::kX;               // [stage][lse, D_i][kT]

  const int S = mask.S;
  const int k0 = key_tile * kT;
  int qt0, n_qt;
  mask.items(k0, qt0, n_qt);
  const int n_items = group * n_qt;
  const int i_begin = share * per;
  if (i_begin >= n_items) return;  // the sum reads no share past the list
  const int n_mine = min(per, n_items - i_begin);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r = warp / 4, role = warp % 4;  // keys 16 r .. 16 r + 15
  const bool p_warp = role < 2;             // P and dV; else dP, dS and dK
  const int half = role % 2;                // its n-blocks and columns

  auto item_rows = [&](int item, int& bh, int& q0) {
    bh = kvh * group + item / n_qt;
    q0 = (qt0 + item % n_qt) * kT;
  };
  auto load_item = [&](int st, int item) {
    int bh, q0;
    item_rows(item, bh, q0);
    float* sq = ring + st * L::kPair;
    load_tile<D>(sq, q + (long long)bh * S * D, q0, S);
    load_tile<DV>(sq + Staged<D>::kTile, dout + (long long)bh * S * DV, q0, S);
    if (tid < 2 * kT) {  // lse and D_i of the item's rows (past S: 0)
      const int row = q0 + tid % kT;
      const float* src = tid < kT ? lse : delta;
      rows[st * 2 * kT + tid] = row < S ? src[(long long)bh * S + row] : 0.0f;
    }
  };

  load_tile<D>(sk, k + (long long)kvh * S * D, k0, S);
  load_tile<DV>(sv, v + (long long)kvh * S * DV, k0, S);
  load_item(0, i_begin);
  cp_async_commit();

  float acc[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  float* xp = xch + r * 2 * 4 * 4 * 32;  // this row group's p
  float* xs = xp + 4 * 4 * 32;           // and ds

  for (int it = 0; it < n_mine; ++it) {
    const int st = it & 1;
    if (it + 1 < n_mine) load_item(st ^ 1, i_begin + it + 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    int bh, q0;
    item_rows(i_begin + it, bh, q0);
    const float* sq = ring + st * L::kPair;
    const float* sdo = sq + Staged<D>::kTile;
    const float* lse_s = rows + st * 2 * kT;
    const float* delta_s = lse_s + kT;
    const bool whole = mask.whole(q0, k0);

    // S^T = K Q^T over D (P warps) or dP^T = V dO^T over Dv (dS warps):
    // keys 16 r .., query columns of n-blocks 2 half, 2 half + 1
    float x[2][4];
    if (p_warp)
      rows_dot<D, 2>(x, sk + 16 * r * RQ, sq + 16 * half * RQ, g, t);
    else
      rows_dot<DV, 2>(x, sv + 16 * r * RV, sdo + 16 * half * RV, g, t);
    if (p_warp) {
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        const int n = 2 * half + nb;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = 8 * n + 2 * t + (e & 1), kr = 16 * r + g + 8 * (e >> 1);
          const bool keep = whole || mask.visible(q0 + qc, k0 + kr);
          const int i = (n * 4 + e) * 32 + lane;
          if constexpr (CAP) {
            // p, and p (1 - t^2) for the dS warps in ds's slot
            const float tc = tanhf(x[nb][e] * mask.cap_scale);
            const float p = keep ? expf(mask.softcap * tc - lse_s[qc]) : 0.0f;
            xp[i] = p;
            xs[i] = p * (1.0f - tc * tc);
          } else {
            xp[i] = keep ? expf(x[nb][e] * mask.scale - lse_s[qc]) : 0.0f;
          }
        }
      }
    }
    group_barrier(r);  // p is in the exchange
    if (!p_warp) {
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        const int n = 2 * half + nb;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = 8 * n + 2 * t + (e & 1);
          const int i = (n * 4 + e) * 32 + lane;
          xs[i] = (CAP ? xs[i] : xp[i]) * (x[nb][e] - delta_s[qc]);
        }
      }
    }
    group_barrier(r);  // ds is in the exchange

    // dV += P^T dO (P warps, this warp's half of Dv) or dK += dS^T Q (dS
    // warps, its half of D)
    uint32_t hi[4][4], lo[4][4];
    tile_frags(p_warp ? xp : xs, lane, hi, lo);
    if (p_warp)
      frags_acc<DV, NJV>(acc, hi, lo, sdo, half * (DV / 2), g, t);
    else
      frags_acc<D, NJK>(acc, hi, lo, sq, half * (D / 2), g, t);

    // every warp is done with this stage and the exchange
    __syncthreads();
  }

  // this share's partials, keys below S: dK in dS warps, dV in P warps.
  // The scratch holds every share's dK (bh_kv, S, D), then every share's
  // dV (bh_kv, S, Dv)
  const int width = p_warp ? DV : D;
  const int nj = p_warp ? NJV : NJK;
  float* out = p_warp ? part + (long long)shares * bh_kv * S * D +
                            ((long long)share * bh_kv + kvh) * S * DV
                      : part + ((long long)share * bh_kv + kvh) * S * D;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int kp = k0 + 16 * r + g + 8 * hr;
    if (kp >= S) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j >= nj) break;
      const int col = half * (width / 2) + 8 * j + 2 * t;
      *reinterpret_cast<float2*>(out + (long long)kp * width + col) =
          make_float2(acc[j][2 * hr], acc[j][2 * hr + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// 3. dQ: one block per (bh, query tile)
// ---------------------------------------------------------------------------

template <int D, int DV, bool CAP>
__device__ __forceinline__ void dq_block(const float* __restrict__ q,
                                         const float* __restrict__ k,
                                         const float* __restrict__ v,
                                         const float* __restrict__ dout,
                                         const float* __restrict__ lse,
                                         const float* __restrict__ delta, float* __restrict__ dq,
                                         int group, const Mask& mask, int bh, int q_tile) {
  using L = Layout<D, DV>;
  constexpr int RQ = Staged<D>::kRow, RV = Staged<DV>::kRow;
  constexpr int NJ = D / 32;  // n-blocks of a warp's quarter of D
  extern __shared__ float smem[];
  float* sq = smem;
  float* sdo = sq + Staged<D>::kTile;
  float* ring = sdo + Staged<DV>::kTile;  // stage st: K, then V
  float* xch = ring + 2 * L::kPair;

  const int S = mask.S;
  const int kvh = bh / group;
  const int q0 = q_tile * kT;
  int lo, hi;
  mask.key_range(q0, lo, hi);
  const int k_first = (lo / kT) * kT;
  const int n_tiles = (hi - k_first + kT - 1) / kT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r = warp / 4, role = warp % 4;  // query rows 16 r .. 16 r + 15
  const bool p_warp = role < 2;             // P; else dP and dS
  const int half = role % 2;
  const float* kb = k + (long long)kvh * S * D;
  const float* vb = v + (long long)kvh * S * DV;

  auto load_kv = [&](int st, int k0) {
    float* s = ring + st * L::kPair;
    load_tile<D>(s, kb, k0, S);
    load_tile<DV>(s + Staged<D>::kTile, vb, k0, S);
  };
  load_tile<D>(sq, q + (long long)bh * S * D, q0, S);
  load_tile<DV>(sdo, dout + (long long)bh * S * DV, q0, S);
  if (n_tiles > 0) load_kv(0, k_first);
  cp_async_commit();

  // this thread's rows, their lse and D_i (rows past S: 0, never written)
  const int qr0 = q0 + 16 * r + g, qr1 = qr0 + 8;
  const float lse0 = qr0 < S ? lse[(long long)bh * S + qr0] : 0.0f;
  const float lse1 = qr1 < S ? lse[(long long)bh * S + qr1] : 0.0f;
  const float del0 = qr0 < S ? delta[(long long)bh * S + qr0] : 0.0f;
  const float del1 = qr1 < S ? delta[(long long)bh * S + qr1] : 0.0f;

  float acc[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  float* xp = xch + r * 2 * 4 * 4 * 32;
  float* xs = xp + 4 * 4 * 32;

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    const int k0 = k_first + it * kT;
    if (it + 1 < n_tiles) load_kv(st ^ 1, k0 + kT);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const float* sk = ring + st * L::kPair;
    const float* sv = sk + Staged<D>::kTile;
    const bool whole = mask.whole(q0, k0);

    // S = Q K^T over D (P warps) or dP = dO V^T over Dv (dS warps): rows
    // 16 r .., key columns of n-blocks 2 half, 2 half + 1
    float x[2][4];
    if (p_warp)
      rows_dot<D, 2>(x, sq + 16 * r * RQ, sk + 16 * half * RQ, g, t);
    else
      rows_dot<DV, 2>(x, sdo + 16 * r * RV, sv + 16 * half * RV, g, t);
    if (p_warp) {
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        const int n = 2 * half + nb;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kc = 8 * n + 2 * t + (e & 1);
          const int qp = e < 2 ? qr0 : qr1;
          const bool keep = whole || mask.visible(qp, k0 + kc);
          const float lse_r = e < 2 ? lse0 : lse1;
          float p;
          if constexpr (CAP) {
            // dq reads p only through ds: the dS warps get p (1 - t^2)
            const float tc = tanhf(x[nb][e] * mask.cap_scale);
            p = keep ? expf(mask.softcap * tc - lse_r) * (1.0f - tc * tc) : 0.0f;
          } else {
            p = keep ? expf(x[nb][e] * mask.scale - lse_r) : 0.0f;
          }
          xp[(n * 4 + e) * 32 + lane] = p;
        }
      }
    }
    group_barrier(r);
    if (!p_warp) {
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        const int n = 2 * half + nb;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = xp[(n * 4 + e) * 32 + lane];
          xs[(n * 4 + e) * 32 + lane] = p * (x[nb][e] - (e < 2 ? del0 : del1));
        }
      }
    }
    group_barrier(r);

    // dq += dS K, this warp's quarter of D
    uint32_t fh[4][4], fl[4][4];
    tile_frags(xs, lane, fh, fl);
    frags_acc<D, NJ>(acc, fh, fl, sk, role * (D / 4), g, t);

    __syncthreads();  // every warp is done with this stage and the exchange
  }

  float* out = dq + (long long)bh * S * D;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qp = hr == 0 ? qr0 : qr1;
    if (qp >= S) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = role * (D / 4) + 8 * j + 2 * t;
      *reinterpret_cast<float2*>(out + (long long)qp * D + col) =
          make_float2(acc[j][2 * hr] * mask.scale, acc[j][2 * hr + 1] * mask.scale);
    }
  }
}

// ---------------------------------------------------------------------------
// 2 and 3 in one launch: the dK/dV blocks (key tile by key tile, a tile's
// shares together), then the dQ blocks, longest query tiles first; one
// grid, so the SMs the dK/dV blocks free take dQ blocks at once
// ---------------------------------------------------------------------------

template <int D, int DV, bool CAP>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_tf32_main_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ part, float* __restrict__ dq, int bh_kv, int group,
                          int shares, int per, int tiles, Mask mask) {
  long long b = blockIdx.x;
  const long long n_dkdv = (long long)shares * tiles * bh_kv;
  if (b < n_dkdv) {
    const int share = (int)(b % shares);
    b /= shares;
    dkdv_block<D, DV, CAP>(q, k, v, dout, lse, delta, part, bh_kv, group, shares, per, mask,
                      share, (int)(b % tiles), (int)(b / tiles));
  } else {
    b -= n_dkdv;
    const int bh_rows = bh_kv * group;
    dq_block<D, DV, CAP>(q, k, v, dout, lse, delta, dq, group, mask, (int)(b % bh_rows),
                    tiles - 1 - (int)(b / bh_rows));
  }
}

// ---------------------------------------------------------------------------
// 4. dK and dV: the shares' partials summed in share order
// ---------------------------------------------------------------------------

// Four floats of dK (i below bh_kv * S * D / 4) or of dV (the rest): the
// used shares' partials at (bh_kv, S, width) summed in share order.
__global__ void __launch_bounds__(256)
attn_bwd_tf32_sum_kernel(const float* __restrict__ part, float* __restrict__ dk,
                         float* __restrict__ dv, int bh_kv, int D, int DV, int group,
                         int shares, int per, Mask mask) {
  const int S = mask.S;
  const long long nk = (long long)bh_kv * S * D, nv = (long long)bh_kv * S * DV;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < (nk + nv) / 4;
       i += (long long)gridDim.x * blockDim.x) {
    const bool is_k = i < nk / 4;                // D and Dv are multiples of 4
    const long long e = is_k ? 4 * i : 4 * i - nk;
    const int width = is_k ? D : DV;
    const long long n = is_k ? nk : nv;
    const float* src = is_k ? part : part + (long long)shares * nk;
    const int kp = (int)((e % ((long long)S * width)) / width);
    int qt0, n_qt;
    mask.items(kp / kT * kT, qt0, n_qt);
    const int used = min(shares, (group * n_qt + per - 1) / per);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int z = 0; z < used; ++z) {
      const float4 x = reinterpret_cast<const float4*>(src + (long long)z * n + e)[0];
      a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
    }
    if (is_k)
      reinterpret_cast<float4*>(dk + e)[0] =
          make_float4(a.x * mask.scale, a.y * mask.scale, a.z * mask.scale, a.w * mask.scale);
    else
      reinterpret_cast<float4*>(dv + e)[0] = a;
  }
}

Mask make_mask(int s, int d, int causal, int kind, int window, double softcap) {
  return Mask{s, causal, kind, window, (float)(1.0 / sqrt((double)d)), (float)softcap,
              softcap > 0.0 ? (float)(1.0 / (sqrt((double)d) * softcap)) : 0.0f};
}

// The longest work list of any key tile, in items.
int most_items(int s, int group, const Mask& m) {
  int most = 1;
  for (int k0 = 0; k0 < s; k0 += kT) {
    int qt0, n_qt;
    m.items(k0, qt0, n_qt);
    most = n_qt * group > most ? n_qt * group : most;
  }
  return most;
}

// The largest dynamic shared memory a block may take is set once per
// device and head dims, not at every call.
template <int D, int DV, bool CAP>
cudaError_t allow_smem() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(attn_bwd_tf32_main_kernel<D, DV, CAP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Layout<D, DV>::kBytes);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

// Blocks of the main kernel an SM holds, or 0 when the query fails.
template <int D, int DV, bool CAP>
int main_occupancy() {
  if (allow_smem<D, DV, CAP>() != cudaSuccess) return 0;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, attn_bwd_tf32_main_kernel<D, DV, CAP>,
                                                    kThreads, (int)Layout<D, DV>::kBytes) !=
      cudaSuccess)
    return 0;
  return n;
}

// The main launch's work by the columns its products and copies run over:
// a dK/dV item (a query tile of one head against the key tile) four
// products, s and dk over D and dp and dv over Dv; a dQ block's key tile
// three, s and dq over D and dp over Dv; a block's fixed work (its
// resident tiles in, its outputs out) twice an item's for dK/dV (the
// partials, read back by the sum) and an item's for dQ.  Where D = Dv
// these are 4, 3, 8 and 4 times D.
struct Work {
  long long item, tile, dkdv_block, dq_block;
};
Work work_of(int d, int dv) {
  return Work{2LL * (d + dv), 2LL * d + dv, 4LL * (d + dv), 2LL * (d + dv)};
}

// The share count: with `per` items a dK/dV block, key tile t takes
// ceil(items_t / per) blocks.  The launch's span is about the larger of
// its work spread over the SMs and its longest block; the count minimises
// that (the dQ blocks' work is fixed), the smallest on a tie.
int choose_shares(int bh_kv, int s, int group, const Mask& m, const Work& w, int per_sm) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      per_sm <= 0)
    return 0;
  const int most = most_items(s, group, m);
  const long long slots = (long long)sms * per_sm;
  long long dq_work = 0, dq_longest = 0, items = 0;
  for (int q0 = 0; q0 < s; q0 += kT) {
    int lo, hi;
    m.key_range(q0, lo, hi);
    const long long x = w.dq_block + w.tile * (long long)((hi - lo / kT * kT + kT - 1) / kT);
    dq_work += x;
    dq_longest = x > dq_longest ? x : dq_longest;
  }
  dq_work *= (long long)bh_kv * group;
  for (int k0 = 0; k0 < s; k0 += kT) {
    int qt0, n_qt;
    m.items(k0, qt0, n_qt);
    items += (long long)group * n_qt;
  }
  items *= bh_kv;
  int best = 1;
  long long best_cost = -1;
  for (int shares = 1; shares <= most; ++shares) {
    const int per = items_per_share(most, shares);
    long long blocks = 0;
    for (int k0 = 0; k0 < s; k0 += kT) {
      int qt0, n_qt;
      m.items(k0, qt0, n_qt);
      blocks += (group * n_qt + per - 1) / per;
    }
    blocks *= bh_kv;
    const long long work = dq_work + w.item * items + w.dkdv_block * blocks;
    long long cost = (work + slots - 1) / slots;
    const long long longest = w.item * per + w.dkdv_block;
    cost = cost > longest ? cost : longest;
    cost = cost > dq_longest ? cost : dq_longest;
    if (best_cost < 0 || cost < best_cost) {
      best = shares;
      best_cost = cost;
    }
  }
  return best;
}

template <int D, int DV, bool CAP>
cudaError_t launch(const float* q, const float* k, const float* v, const float* o,
                   const float* dout, const float* lse, float* dq, float* dk, float* dv,
                   float* delta, float* part, int bh, int s, int group, int shares,
                   const Mask& mask, cudaStream_t stream) {
  const int bh_kv = bh / group;
  cudaError_t err = allow_smem<D, DV, CAP>();
  if (err != cudaSuccess) return err;
  const int per = items_per_share(most_items(s, group, mask), shares);

  const long long rows = (long long)bh * s;
  attn_bwd_tf32_delta_kernel<<<(unsigned)((rows + kDeltaRows - 1) / kDeltaRows),
                               32 * kDeltaRows, 0, stream>>>(o, dout, delta, rows, DV);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int tiles = (s + kT - 1) / kT;
  const long long blocks = (long long)(shares + group) * tiles * bh_kv;
  attn_bwd_tf32_main_kernel<D, DV, CAP>
      <<<(unsigned)blocks, kThreads, Layout<D, DV>::kBytes, stream>>>(
          q, k, v, dout, lse, delta, part, dq, bh_kv, group, shares, per, tiles, mask);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long n = (long long)bh_kv * s * (D + DV);
  const long long sum_blocks = (n / 4 + 255) / 256;
  attn_bwd_tf32_sum_kernel<<<(unsigned)(sum_blocks < 4096 ? sum_blocks : 4096), 256, 0,
                             stream>>>(
      part, dk, dv, bh_kv, D, DV, group, shares, per, mask);
  return cudaGetLastError();
}

// The head dims' blocks an SM holds, with or without the softcap, or 0.
template <bool CAP>
int occupancy(int d) {
  switch (d) {
    case 64: return main_occupancy<64, 64, CAP>();
    case 96: return main_occupancy<96, 96, CAP>();
    case 128: return main_occupancy<128, 128, CAP>();
    case 192: return main_occupancy<192, 128, CAP>();
    case 256: return main_occupancy<256, 256, CAP>();
  }
  return 0;
}

// The head dims' launch, with or without the softcap.
template <bool CAP>
cudaError_t dispatch(const float* q, const float* k, const float* v, const float* o,
                     const float* dout, const float* lse, float* dq, float* dk, float* dv,
                     float* delta, float* part, int bh, int s, int d, int group, int shares,
                     const Mask& m, cudaStream_t st) {
  switch (d) {
    case 64:
      return launch<64, 64, CAP>(q, k, v, o, dout, lse, dq, dk, dv, delta, part, bh, s, group,
                                 shares, m, st);
    case 96:
      return launch<96, 96, CAP>(q, k, v, o, dout, lse, dq, dk, dv, delta, part, bh, s, group,
                                 shares, m, st);
    case 128:
      return launch<128, 128, CAP>(q, k, v, o, dout, lse, dq, dk, dv, delta, part, bh, s, group,
                                   shares, m, st);
    case 192:
      return launch<192, 128, CAP>(q, k, v, o, dout, lse, dq, dk, dv, delta, part, bh, s, group,
                                   shares, m, st);
    default:
      return launch<256, 256, CAP>(q, k, v, o, dout, lse, dq, dk, dv, delta, part, bh, s, group,
                                   shares, m, st);
  }
}

}  // namespace

// The (D, Dv) pairs the kernel takes: D = Dv in {64, 96, 128, 256}, and
// MLA's (192, 128).
static bool takes(int d, int dv) {
  return (d == dv && (d == 64 || d == 96 || d == 128 || d == 256)) || (d == 192 && dv == 128);
}

// The number of shares the dK/dV launch cuts each key tile's work into
// (the partials' scratch is shares * (bh / group) * s * (d + dv) f32) for
// the softcapped kernel when `capped` is not 0, or 0 when the arguments
// are refused or the device query fails.
extern "C" int flash_attention_bwd_tf32_shares(int bh, int s, int d, int dv, int group,
                                               int causal, int kind, int window, int capped) {
  if (bh <= 0 || s <= 0 || group <= 0 || bh % group || !takes(d, dv)) return 0;
  if (kind != kGlobal && window < 1) return 0;
  const Mask m = make_mask(s, d, causal, kind, window, 0.0);
  const int per_sm = capped ? occupancy<true>(d) : occupancy<false>(d);
  return choose_shares(bh / group, s, group, m, work_of(d, dv), per_sm);
}

// q, dq: (bh, s, d) f32; o, dout: (bh, s, dv) f32; k, dk: (bh / group, s,
// d) f32; v, dv_out: (bh / group, s, dv) f32; lse: (bh, s) f32 from the
// forward; delta: (bh, s) f32 scratch; part: shares * (bh / group) * s *
// (d + dv) f32 scratch (every share's dK partials, then every share's
// dV).  All contiguous, 16-byte aligned, on the current device; (d, dv)
// in {(64, 64), (96, 96), (128, 128), (256, 256), (192, 128)}; softcap > 0
// caps the scores (the CAP instantiations), 0 does not.  kind: 0 global,
// 1 local, 2 chunked.
extern "C" int flash_attention_bwd_tf32(const void* q, const void* k, const void* v,
                                        const void* o, const void* dout, const float* lse,
                                        void* dq, void* dk, void* dv_out, float* delta,
                                        float* part, int bh, int s, int d, int dv, int group,
                                        int shares, int causal, int kind, int window,
                                        double softcap, void* stream) {
  if (bh <= 0 || s <= 0) return (int)cudaSuccess;
  if (group <= 0 || bh % group || shares <= 0 || softcap < 0.0 || !takes(d, dv))
    return (int)cudaErrorInvalidValue;
  if (kind != kGlobal && window < 1) return (int)cudaErrorInvalidValue;
  const Mask m = make_mask(s, d, causal, kind, window, softcap);
  const cudaStream_t st = (cudaStream_t)stream;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* of = static_cast<const float*>(o);
  const float* df = static_cast<const float*>(dout);
  float* dqf = static_cast<float*>(dq);
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv_out);
  return (int)(softcap > 0.0 ? dispatch<true>(qf, kf, vf, of, df, lse, dqf, dkf, dvf, delta,
                                              part, bh, s, d, group, shares, m, st)
                             : dispatch<false>(qf, kf, vf, of, df, lse, dqf, dkf, dvf, delta,
                                               part, bh, s, d, group, shares, m, st));
}
