// Forward attention with an online softmax on Hopper's tensor cores at f32
// accuracy (sm_90a): the f32 path for q/k and v head dims (D, Dv) = (64,
// 64), (96, 96), (128, 128), (256, 256) and MLA's (192, 128), with or
// without a softcap.
//
// Replaces, for f32 inputs at those head dims, the Pallas TPU kernel
// `flash_attention` (`_kernel`) of src/repro/kernels/flash_attention.py:
//   q (BH, S, D), k (BH / G, S, D) and v (BH / G, S, Dv), f32
//   -> o (BH, S, Dv) f32,
// with causal, `local` (sliding window) and `chunked` (aligned chunks of
// `window` keys) masks and an optional tanh softcap on the scores.  Query
// row bh reads kv row bh / G, so MQA and GQA need no repeat of k and v.
// bf16 inputs take flash_attention_wgmma.cu, other head dims the CUDA-core
// kernel of flash_attention.cu; the wrapper picks the path from dtype, D
// and Dv.
//
// Arithmetic: both products run on the tensor cores in TF32 with three
// terms (3xTF32; with a softcap q.k runs in f64, below).  Each f32 operand x is split into hi = tf32(x) (round to
// nearest, the low 13 bits zero) and lo = tf32(x - hi), and a product is
// lo_a hi_b + hi_a lo_b + hi_a hi_b summed in f32: the dropped lo_a lo_b
// and the rounding of lo leave some 2^-23 of the product, where plain TF32
// (hi_a hi_b) would leave 2^-11, far outside the f32 tolerance of 1e-5.
// Every operand is rounded to TF32 by this code before the tensor core
// reads it, so how the hardware treats the low 13 bits does not matter.
// Then as the Pallas kernel: s = (q.k) * (1/sqrt(D)); softcap s = tanh(s /
// c) * c, before the mask; masked scores take the finite value
// -2.3819763e38 and keys past S take -inf; the running (m, l, acc) are
// f32; p stays f32 (split like any operand) for P.V; o = acc / max(l,
// 1e-30).
//
// The softcap in f64.  At softcapped scores (tens in magnitude) one f32
// rounding of a score moves p by some 1e-7 of itself times |s|, and the
// output by about the f32 tolerance (1e-5 absolute plus 1e-5 relative):
// the plain f32 version itself lands at up to 0.86 of it from the function
// evaluated in float64, and this kernel, with tanhf (2 ulps, 6e-6 of a
// score at c = 50) and four f32 roundings between q.k and p, at 1.05.
// With the score formed in double from the 3xTF32 sums the worst element
// still grew with D: the tensor cores' rounding of each four-product sum
// of hi parts adds up over D / 4 sums instead of averaging out.  So with
// a softcap (the CAP instantiations) q.k runs on the FP64 tensor cores
// (mma m8n8k4 .f64: f32 products are exact in double, the sums round at
// 2^-53), then is scaled by 1/(sqrt(D) c), capped by the double tanh and
// multiplied by c; the score is kept as an f32 pair hi + lo, the row
// maximum is taken over hi, and p = exp((hi - m) + lo), so the only f32
// roundings left are the exp's and P V's (3xTF32 as without a softcap).
// chip_smoke.py's phase 4 holds every route's worst element against
// float64.  The cost: the FP64 tensor cores run at 67 TFLOP/s against
// TF32's 495 and each operand is converted to double on its way in,
// where 3xTF32 runs three products; and the double tanh takes some 40
// FP64 operations a score.  Without a softcap nothing of this is compiled.
//
// When the caller asks (a gradient will be taken), each row's log-sum-exp
// m + log(max(l, 1e-30)) is written beside o for the backward of
// flash_attention_bwd_tf32.cu.
//
// What bounds it on this card.  At the serving shapes (D = 256, a local
// window of 2,048, S up to 3,000) the work is 2*(D + Dv) operations per
// unmasked query-key pair (4*D where Dv = D), three times over in 3xTF32,
// against (D + Dv)*4 bytes of q, k, v and o per query row: it is bound by
// the tensor cores' TF32 rate (495 TFLOP/s dense), as at MLA's (BH 128,
// causal, S up to 3,000).  The earlier kernel ran both products on the
// CUDA cores in f32 (67 TFLOP/s at most) and lost to
// scaled_dot_product_attention.
//
// Why mma.sync (m16n8k8, TF32) and not wgmma.  wgmma reads TF32 operands
// only K-major from shared memory (the transpose bit is for 16-bit types),
// so V would have to be transposed on its way in, and an operand read from
// shared memory must already be split there: K and V twice over, hi and
// lo.  At D = 256 an f32 q tile of 64 rows is 64 KB; hi and lo tiles of
// even 32 keys of K and of the transposed V add 128 KB, which leaves no
// room for a second stage in the 227 KB of an SM.  mma.sync takes both
// operands from registers: K and V are staged once, as f32, and each warp
// splits the values it loads; V's B fragment is read straight from its
// rows, and the score accumulator serves as P's A fragment with no
// shuffle, by pairing logical k = t with key 2t and k = t + 4 with key
// 2t + 1 (the same pairing is used for V's rows).
//
// What the design does:
//   * one block of eight warps per (bh, tile of 64 query rows): two warps
//     for each 16 rows, one for each half of a kv tile's keys.  A warp's
//     scores (16 x BK / 2) and its share of the output (16 x Dv, 128
//     floats a thread at Dv = 256, 64 at MLA's 128) stay in registers;
//     the pair meets once a tile (a named barrier) to agree on the rows'
//     running maximum, and its two outputs and sums are added at the
//     end.  Four warps, one a row group, left an SM with one warp on each
//     scheduler;
//   * the large terms of Q K^T are summed on the tensor cores four products
//     at a time and added in f32, and P V one kv tile at a time: summed on
//     the tensor cores over all of D, Q K^T missed the f32 tolerance
//     several times over at softcap 50 with scores of magnitude 64;
//   * the split rounds with integer operations, not cvt.rna.tf32.f32,
//     which issues at a quarter of their rate and held a first version
//     far below the tensor cores' TF32 rate;
//   * q, then K and V tiles of BK keys (32 at D = 256, 192 and 128, 64 at
//     D = 64 and 96), arrive by cp.async into a two-stage ring: the next kv tile
//     is in flight while this one's products run.  q and K rows are
//     padded to D + 4 floats, V rows to Dv + 4, so every fragment load of
//     a warp falls on distinct banks; keys and queries past S are
//     zero-filled;
//   * kv tiles that the mask hides from every row of the q tile are
//     skipped, and tiles that it shows whole to every row skip the
//     per-element mask; q tiles are launched longest first;
//   * at D = 256 an SM holds one block, and a causal grid's longest q
//     tiles would run on alone (at S = 512, 80 blocks of 2 to 16 kv
//     tiles on 132 SMs).  So each q tile's kv tiles may be split into up
//     to 8 shares (blockIdx.z), chosen so that no block holds more than
//     half an SM's fair share of the tiles (flash_attention_tf32_splits
//     tells the caller how many, to size the scratch); each share writes
//     its unnormalised output, maximum and sum, and a second launch joins
//     them.
//
// MLA's (192, 128): BK 32.  The q tile (64 rows of 196 floats, 49 KB)
// and two stages of K (192 columns) and V (128) take 134,144 bytes, one
// block an SM; BK 64 would take 218 KB for the same one block an SM and
// double each warp's score, p and split registers, and BK 16 (92 KB, two
// blocks an SM) would leave each warp one n-block of keys a tile and
// twice the meetings a key, under a register budget halved to 128.  So
// the MLA shape takes the D = 128 and 256 tile.  S = Q K^T runs 24 k8
// steps over D, P V 16 n-blocks over Dv; the scale is 1/sqrt(D).  ptxas
// (CUDA 12 on the H100's machine, printed by chip_smoke.py's phase 0):
// 218 registers at (192, 128), 255 at (256, 256), 203 at (128, 128), 208
// at (96, 96), 171 at (64, 64), no spill; the softcapped instantiations
// the same but for (256, 256), which spills 8 bytes.
//
// (96, 96), the ~100M training example's head dim (gemma2's softcap of
// 50, BH 64 over 32 kv rows, S 512): BK 64 as at D = 64, at its true
// width: S = Q K^T runs 12 k8 steps, P V 12 n-blocks, and rows padded to
// 100 floats keep every fragment load on distinct banks (100 = 4 mod
// 32), so no product is spent on padding.  q and a two-stage ring of 64
// keys take 128,000 bytes, one block an SM, as the registers (a thread's
// 48 f32 of output, 16 scores) allow at most two.  Its grid, 64 x 8 q
// tiles, fills 132 SMs nearly four times over, so the plan splits no kv
// range there.  What bounds it is bytes (q, k, v and o once: 37.7 MB,
// 0.0113 ms at 3.35 TB/s; its 3.2e9 operations take 0.0065 ms at the TF32
// rate), but the kernel runs q.k on the FP64 tensor cores, a double tanh
// for every score and P V three times over: the tensor cores' and the
// FP64 pipe's time, not the bytes, set its pace.
//
// Interface: plain C, bound from Python with ctypes.  The entry point
// launches on the caller's stream, allocates nothing, does not
// synchronise, and returns a CUDA error code (0 on success).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kRowGroups = 4;  // of 16 query rows
constexpr int kThreads = 32 * 2 * kRowGroups;  // two warps a row group
constexpr int kPad = 4;        // floats of padding per staged row
constexpr int kSMs = 132;      // the H100's SMs: one block each at D = 256
constexpr int kMaxSplits = 8;
constexpr float kNegInf = -2.3819763e38f;

enum Kind { kGlobal = 0, kLocal = 1, kChunked = 2 };

template <int D, int DV, int BK>
struct Layout {
  static constexpr int kRow = D + kPad;                // floats per q or K row
  static constexpr int kRowV = DV + kPad;              // floats per V row
  static constexpr int kQ = kBQ * kRow;                // floats of the q tile
  static constexpr int kTile = BK * kRow;              // floats of a K tile
  static constexpr int kTileV = BK * kRowV;            // floats of a V tile
  static constexpr size_t kBytes =
      4 * (size_t)(kQ + 2 * kTile + 2 * kTileV);      // q, 2 K, 2 V
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
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// d = a b over k = 4 (A: rows g, g + 8 at column t; B: row t, column g)
__device__ __forceinline__ void mma_tf32_k4(float (&d)[4], uint32_t a0, uint32_t a1,
                                            uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// (d0, d1) += a b in f64 on the FP64 tensor cores: an 8 x 8 x 4 product,
// A row g = lane / 4 at column t = lane % 4, B row t at column g, D row g
// at columns 2t and 2t + 1
__device__ __forceinline__ void mma_f64(double& d0, double& d1, double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
      : "+d"(d0), "+d"(d1)
      : "d"(a), "d"(b));
}

// Whether key kp is visible from query qp under the mask.
__device__ __forceinline__ bool visible(int qp, int kp, int causal, int kind, int window) {
  bool ok = !causal || qp >= kp;
  if (kind == kLocal) ok = ok && (qp - kp) < window;
  else if (kind == kChunked) ok = ok && (qp / window) == (kp / window);
  return ok;
}

// The kv tiles of BK keys that any row of the q tile starting at q0 may
// see: n_tiles tiles from key k_first.
__host__ __device__ inline void kv_tiles(int q0, int S, int BK, int causal, int kind,
                                         int window, int& k_first, int& n_tiles) {
  const int q_last = min(q0 + kBQ, S) - 1;
  int lo = 0, hi = S;
  if (causal) hi = q_last + 1;
  if (kind == kLocal) {
    lo = max(0, q0 - window + 1);
  } else if (kind == kChunked) {
    lo = (q0 / window) * window;
    hi = min(hi, (q_last / window + 1) * window);
  }
  k_first = (lo / BK) * BK;
  n_tiles = (hi - k_first + BK - 1) / BK;
}

// With a kv split (split_tiles > 0), block z of a q tile takes its kv
// tiles [z split_tiles, (z + 1) split_tiles) and writes its unnormalised
// output, running maximum and sum to `part` instead of o: (splits, BH, S,
// Dv) outputs, then (splits, BH, S) maxima, then (splits, BH, S) sums.
// CAP: with a softcap, formed in double (see the header); cap_scale is
// 1 / (sqrt(D) softcap) and softcap c.
template <int D, int DV, int BK, bool CAP>
__global__ void __launch_bounds__(kThreads, 1)
flash_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int S, int group,
                  float scale, int causal, int kind, int window, double softcap,
                  double cap_scale, int split_tiles, float* __restrict__ part,
                  float* __restrict__ lse) {
  using L = Layout<D, DV, BK>;
  constexpr int R = L::kRow, RV = L::kRowV;
  constexpr int KH = BK / 2;  // keys of a tile per warp
  extern __shared__ float smem[];
  float* sq = smem;
  float* sk = sq + L::kQ;            // stage st: sk + st * kTile
  float* sv = sk + 2 * L::kTile;     // stage st: sv + st * kTileV
  __shared__ float red[2][2][kBQ];   // [tile parity][key half][row]: row maxima

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int rg = warp % kRowGroups;  // rows 16 rg .. 16 rg + 15
  const int kh = warp / kRowGroups;  // keys kh KH .. kh KH + KH - 1 of a tile
  const int bh = blockIdx.x;
  const int kvh = bh / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest tiles first
  const float* qb = q + (long long)bh * S * D;
  const float* kb = k + (long long)kvh * S * D;
  const float* vb = v + (long long)kvh * S * DV;

  int k_first, n_tiles;
  kv_tiles(q0, S, BK, causal, kind, window, k_first, n_tiles);
  if (split_tiles > 0) {  // this block's share of the kv tiles
    const int first = blockIdx.z * split_tiles;
    if (first >= n_tiles) return;  // the combine reads no empty share
    k_first += first * BK;
    n_tiles = min(split_tiles, n_tiles - first);
  }

  // `rows` rows of `width` floats from row0 on, staged `stride` apart
  auto load_rows = [&](float* dst, const float* src, int row0, int rows, int width,
                       int stride) {
    const int vec = width / 4;  // 16-byte pieces of a row
    for (int e = tid; e < rows * vec; e += kThreads) {
      const int r = e / vec, c = e % vec;
      const bool in = row0 + r < S;
      cp_async16(dst + r * stride + 4 * c, src + (long long)(in ? row0 + r : 0) * width + 4 * c,
                 in);
    }
  };
  auto load_kv = [&](int st, int k0) {
    load_rows(sk + st * L::kTile, kb, k0, BK, D, R);
    load_rows(sv + st * L::kTileV, vb, k0, BK, DV, RV);
  };

  load_rows(sq, qb, q0, kBQ, D, R);
  if (n_tiles > 0) load_kv(0, k_first);
  cp_async_commit();

  const int rq = 16 * rg + g;  // this thread's rows: rq, rq + 8
  const int qp0 = q0 + rq, qp1 = qp0 + 8;
  float acc[DV / 8][4];
#pragma unroll
  for (int j = 0; j < DV / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;  // l over this warp's keys

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    const int k0 = k_first + it * BK;
    if (it + 1 < n_tiles) load_kv(st ^ 1, k0 + BK);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* ks = sk + st * L::kTile + kh * KH * R;
    const float* vs = sv + st * L::kTileV + kh * KH * RV;

    // S = Q K^T over this warp's keys: A = q rows (row, d), B = K rows
    // (key, d).
    float s[KH / 8][4], small[KH / 8][4];
    if constexpr (CAP) {
      // With a softcap, in f64 on the FP64 tensor cores (m8n8k4: rows g
      // of the top and the bottom 8, keys 2t and 2t + 1 of each n-block,
      // the m16n8 accumulator's layout): f32 products are exact in double
      // and the sums round at 2^-53, then the score is formed in double
      // (see the header) and kept as hi (s) + lo (small).
      double sd[KH / 8][4];
#pragma unroll
      for (int n = 0; n < KH / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sd[n][e] = 0.0;
#pragma unroll 4
      for (int kk = 0; kk < D / 4; ++kk) {
        const float* qa = sq + rq * R + 4 * kk + t;
        const double a0 = qa[0], a1 = qa[8 * R];
#pragma unroll
        for (int n = 0; n < KH / 8; ++n) {
          const double b = ks[(8 * n + g) * R + 4 * kk + t];
          mma_f64(sd[n][0], sd[n][1], a0, b);
          mma_f64(sd[n][2], sd[n][3], a1, b);
        }
      }
#pragma unroll
      for (int n = 0; n < KH / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const double c = softcap * tanh(sd[n][e] * cap_scale);
          s[n][e] = (float)c;
          small[n][e] = (float)(c - (double)s[n][e]);
        }
    } else {
      // The large terms hi_q hi_k are summed from zero on the tensor
      // cores four products at a time (m16n8k4: the k8 fragments' two
      // halves) and added to s in f32 with Kahan's compensation, so
      // neither the tensor core's rounding of its sums nor s's own grows
      // with D; the small terms, 2^-11 of those, and the compensation
      // accumulate on the tensor cores.
#pragma unroll
      for (int n = 0; n < KH / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = small[n][e] = 0.0f;
#pragma unroll 4
      for (int kk = 0; kk < D / 8; ++kk) {
        const float* qa = sq + rq * R + 8 * kk + t;
        uint32_t ahi[4], alo[4];
        split_tf32(qa[0], ahi[0], alo[0]);
        split_tf32(qa[8 * R], ahi[1], alo[1]);
        split_tf32(qa[4], ahi[2], alo[2]);
        split_tf32(qa[8 * R + 4], ahi[3], alo[3]);
#pragma unroll
        for (int n = 0; n < KH / 8; ++n) {
          const float* kr = ks + (8 * n + g) * R + 8 * kk + t;
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(kr[0], bh0, bl0);
          split_tf32(kr[4], bh1, bl1);
          float big0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, big1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma_tf32_k4(big0, ahi[0], ahi[1], bh0);
          mma_tf32_k4(big1, ahi[2], ahi[3], bh1);
          mma_tf32(small[n], alo, bh0, bh1);
          mma_tf32(small[n], ahi, bl0, bl1);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            // Kahan: the add's rounding error joins the small terms
            const float y = big0[e] + big1[e];
            const float sum = s[n][e] + y;
            small[n][e] += (s[n][e] - sum) + y;
            s[n][e] = sum;
          }
        }
      }
#pragma unroll
      for (int n = 0; n < KH / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] += small[n][e];
    }

    // scale, softcap, then the mask (whole tiles the mask shows to every
    // row skip it; keys past S always take -inf).  With CAP the score is
    // hi + lo: s[n][e] takes hi, small[n][e] lo
    const int q_hi = q0 + kBQ - 1;
    bool whole = k0 + BK <= S;
    if (causal) whole = whole && k0 + BK - 1 <= q0;
    if (kind == kLocal) whole = whole && q_hi - k0 < window;
    else if (kind == kChunked)
      whole = whole && q0 / window == q_hi / window && k0 / window == q0 / window &&
              (k0 + BK - 1) / window == q0 / window;
#pragma unroll
    for (int n = 0; n < KH / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = CAP ? s[n][e] : s[n][e] * scale, x_lo = CAP ? small[n][e] : 0.0f;
        if (!whole) {
          const int kp = k0 + kh * KH + 8 * n + 2 * t + (e & 1);
          const int qp = e < 2 ? qp0 : qp1;
          if (!visible(qp, kp, causal, kind, window)) x = kNegInf, x_lo = 0.0f;
          if (kp >= S) x = -INFINITY, x_lo = 0.0f;
        }
        s[n][e] = x;
        if constexpr (CAP) small[n][e] = x_lo;
      }
    }

    // online softmax: a row's four threads are lanes 4g .. 4g+3 of this
    // warp, its other half of the keys is the warp kRowGroups away
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < KH / 8; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    if (t == 0) {
      red[st][kh][rq] = mx0;
      red[st][kh][rq + 8] = mx1;
    }
    // the two warps of these rows meet (named barrier 1 + rg, 64 threads);
    // red[st] is written again two tiles later, after the next meeting
    asm volatile("bar.sync %0, 64;\n" ::"r"(1 + rg) : "memory");
    mx0 = fmaxf(mx0, red[st][kh ^ 1][rq]);
    mx1 = fmaxf(mx1, red[st][kh ^ 1][rq + 8]);
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    // expf, not exp2f of a product with log2(e): that product's rounding
    // would move p by some 2^-24 of |s - m|, up to 6e-6 at softcap 50
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    // (with CAP the exponent is (hi - m) + lo: hi - m is exact where p
    // matters, hi and m being within a factor of two)
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int n = 0; n < KH / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float d = s[n][e] - (e < 2 ? mn0 : mn1);
        s[n][e] = expf(CAP ? d + small[n][e] : d);
      }
      sum0 += s[n][0] + s[n][1];
      sum1 += s[n][2] + s[n][3];
    }
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
    l0 = l0 * al0 + sum0;
    l1 = l1 * al1 + sum1;
    m0 = mn0;
    m1 = mn1;

    // O = O alpha + P V over this warp's keys.  P's A fragment is the
    // score accumulator of keys 8n .. 8n+7 as it stands, reading logical
    // k = t as key 2t and k = t + 4 as key 2t + 1; V's B fragment takes
    // rows 2t and 2t + 1 to match.  Each column tile's product is summed
    // from zero on the tensor cores and folded into O in f32.
    uint32_t phi[KH / 8][4], plo[KH / 8][4];
#pragma unroll
    for (int n = 0; n < KH / 8; ++n) {
      split_tf32(s[n][0], phi[n][0], plo[n][0]);  // row rq,     key 2t
      split_tf32(s[n][2], phi[n][1], plo[n][1]);  // row rq + 8, key 2t
      split_tf32(s[n][1], phi[n][2], plo[n][2]);  // row rq,     key 2t + 1
      split_tf32(s[n][3], phi[n][3], plo[n][3]);  // row rq + 8, key 2t + 1
    }
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int n = 0; n < KH / 8; ++n) {
        const float* vr = vs + (8 * n + 2 * t) * RV + 8 * j + g;
        mma_3xtf32(part, phi[n], plo[n], vr[0], vr[RV]);
      }
      acc[j][0] = fmaf(acc[j][0], al0, part[0]);
      acc[j][1] = fmaf(acc[j][1], al0, part[1]);
      acc[j][2] = fmaf(acc[j][2], al1, part[2]);
      acc[j][3] = fmaf(acc[j][3], al1, part[3]);
    }

    // every warp is done with this stage before it is refilled
    __syncthreads();
  }

  // the second key half's O and l join the first's through shared memory
  // (the K/V ring is free): both scaled by the same running maxima
  float* xo = sk;  // [row group][Dv / 2 values][lane]
  float* xl = sk + kRowGroups * (DV / 2) * 32;
  static_assert(kRowGroups * (DV / 2 + 2) * 32 <= 2 * (L::kTile + L::kTileV),
                "the K/V ring holds the second key half's output and sums");
  if (kh == 1) {
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) xo[(rg * (DV / 2) + 4 * j + e) * 32 + lane] = acc[j][e];
    xl[(rg * 2) * 32 + lane] = l0;
    xl[(rg * 2 + 1) * 32 + lane] = l1;
  }
  __syncthreads();
  if (kh == 1) return;
#pragma unroll
  for (int j = 0; j < DV / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += xo[(rg * (DV / 2) + 4 * j + e) * 32 + lane];
  l0 += xl[(rg * 2) * 32 + lane];
  l1 += xl[(rg * 2 + 1) * 32 + lane];
  if (split_tiles > 0) {
    const long long rows = (long long)gridDim.x * S;  // BH * S
    const long long r = blockIdx.z * rows + (long long)bh * S;
    float* po = part + r * DV;
    float* pm = part + gridDim.z * rows * DV + r;
    float* pl = pm + gridDim.z * rows;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      const int c = 8 * j + 2 * t;
      if (qp0 < S)
        *reinterpret_cast<float2*>(po + (long long)qp0 * DV + c) =
            make_float2(acc[j][0], acc[j][1]);
      if (qp1 < S)
        *reinterpret_cast<float2*>(po + (long long)qp1 * DV + c) =
            make_float2(acc[j][2], acc[j][3]);
    }
    if (t == 0 && qp0 < S) {
      pm[qp0] = m0;
      pl[qp0] = l0;
    }
    if (t == 0 && qp1 < S) {
      pm[qp1] = m1;
      pl[qp1] = l1;
    }
    return;
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  if (lse != nullptr && t == 0) {  // each row's log-sum-exp, natural log
    if (qp0 < S) lse[(long long)bh * S + qp0] = m0 + logf(d0);
    if (qp1 < S) lse[(long long)bh * S + qp1] = m1 + logf(d1);
  }
  float* ob = o + (long long)bh * S * DV;
#pragma unroll
  for (int j = 0; j < DV / 8; ++j) {
    const int c = 8 * j + 2 * t;
    if (qp0 < S)
      *reinterpret_cast<float2*>(ob + (long long)qp0 * DV + c) =
          make_float2(acc[j][0] / d0, acc[j][1] / d0);
    if (qp1 < S)
      *reinterpret_cast<float2*>(ob + (long long)qp1 * DV + c) =
          make_float2(acc[j][2] / d1, acc[j][3] / d1);
  }
}

// The kv split's shares of each query row joined: o = sum_z e^(m_z - m)
// acc_z / max(sum_z e^(m_z - m) l_z, 1e-30), m the largest m_z, over the
// shares that held kv tiles.  One warp per row of DV outputs.
template <int BK>
__global__ void __launch_bounds__(256)
flash_tf32_combine(const float* __restrict__ part, float* __restrict__ o,
                   float* __restrict__ lse, int bh_rows, int S, int DV, int splits,
                   int split_tiles, int causal, int kind, int window) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;  // bh * S + qp
  const int lane = threadIdx.x % 32;
  if (row >= (long long)bh_rows * S) return;
  const int qp = (int)(row % S);
  int k_first, n_tiles;
  kv_tiles(qp / kBQ * kBQ, S, BK, causal, kind, window, k_first, n_tiles);
  const int n = min(splits, (n_tiles + split_tiles - 1) / split_tiles);
  const long long rows = (long long)bh_rows * S;
  const float* pm = part + splits * rows * DV + row;
  const float* pl = pm + splits * rows;
  float m = pm[0];
  for (int z = 1; z < n; ++z) m = fmaxf(m, pm[z * rows]);
  float l = 0.0f;
  for (int z = 0; z < n; ++z) l += expf(pm[z * rows] - m) * pl[z * rows];
  const float inv_den = 1.0f / fmaxf(l, 1e-30f);
  if (lse != nullptr && lane == 0) lse[row] = m + logf(fmaxf(l, 1e-30f));
  for (int c = lane; c < DV; c += 32) {
    float acc = 0.0f;
    for (int z = 0; z < n; ++z) acc += expf(pm[z * rows] - m) * part[(z * rows + row) * DV + c];
    o[row * DV + c] = acc * inv_den;
  }
}

// The kv tiles of the longest q tile, and the shares to cut each q tile's
// kv range into: enough that no block holds more than half of an SM's fair
// share of all the grid's kv tiles (the longest q tiles would otherwise run
// on alone: at S = 512, 80 blocks of 2 to 16 tiles on 132 SMs), at most 8.
template <int BK>
void plan(int bh, int s, int causal, int kind, int window, int& most, int& splits) {
  long long total = 0;
  most = 1;
  for (int q0 = 0; q0 < s; q0 += kBQ) {
    int k_first, n_tiles;
    kv_tiles(q0, s, BK, causal, kind, window, k_first, n_tiles);
    total += n_tiles;
    most = max(most, n_tiles);
  }
  const double share = fmax((double)bh * total / (2 * kSMs), 1.0);
  splits = min(kMaxSplits, max(1, (int)ceil(most / share)));
}

template <int D, int DV, int BK, bool CAP>
cudaError_t launch(const float* q, const float* k, const float* v, float* o, float* part,
                   float* lse, int bh, int s, int group, int causal, int kind, int window,
                   double softcap, int splits, cudaStream_t stream) {
  const int smem = (int)Layout<D, DV, BK>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_tf32_kernel<D, DV, BK, CAP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const float scale = (float)(1.0 / sqrt((double)D));
  const double cap_scale = CAP ? 1.0 / (sqrt((double)D) * softcap) : 0.0;
  const int n_q = (s + kBQ - 1) / kBQ;
  int most, planned;
  plan<BK>(bh, s, causal, kind, window, most, planned);
  if (splits != planned) return cudaErrorInvalidValue;  // the scratch was sized for it
  const int split_tiles = splits > 1 ? (most + splits - 1) / splits : 0;
  flash_tf32_kernel<D, DV, BK, CAP><<<dim3(bh, n_q, splits), kThreads, smem, stream>>>(
      q, k, v, o, s, group, scale, causal, kind, window, softcap, cap_scale, split_tiles,
      split_tiles > 0 ? part : nullptr, split_tiles > 0 ? nullptr : lse);
  err = cudaGetLastError();
  if (err != cudaSuccess || split_tiles == 0) return err;
  const long long rows = (long long)bh * s;
  flash_tf32_combine<BK><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      part, o, lse, bh, s, DV, splits, split_tiles, causal, kind, window);
  return cudaGetLastError();
}

// The head dims' kernel at kv tiles of BK keys, with or without the
// softcap.
template <bool CAP>
cudaError_t dispatch(const float* q, const float* k, const float* v, float* o, float* part,
                     float* lse, int bh, int s, int d, int group, int causal, int kind,
                     int window, double softcap, int splits, cudaStream_t st) {
  switch (d) {
    case 64:
      return launch<64, 64, 64, CAP>(q, k, v, o, part, lse, bh, s, group, causal, kind, window,
                                     softcap, splits, st);
    case 96:
      return launch<96, 96, 64, CAP>(q, k, v, o, part, lse, bh, s, group, causal, kind, window,
                                     softcap, splits, st);
    case 128:
      return launch<128, 128, 32, CAP>(q, k, v, o, part, lse, bh, s, group, causal, kind,
                                       window, softcap, splits, st);
    case 192:
      return launch<192, 128, 32, CAP>(q, k, v, o, part, lse, bh, s, group, causal, kind,
                                       window, softcap, splits, st);
    default:
      return launch<256, 256, 32, CAP>(q, k, v, o, part, lse, bh, s, group, causal, kind,
                                       window, softcap, splits, st);
  }
}

}  // namespace

// Keys per kv tile, by head dims: 32 at (256, 256), (192, 128) and (128,
// 128) (q and a two-stage ring take 195 KB at D = 256, 131 KB at MLA's
// (192, 128): one block an SM; 99 KB at D = 128: two), 64 at D = 64 and
// D = 96 (128 KB).

// The (D, Dv) pairs the kernel takes: D = Dv in {64, 96, 128, 256}, and
// MLA's (192, 128).
static bool takes(int d, int dv) {
  return (d == dv && (d == 64 || d == 96 || d == 128 || d == 256)) || (d == 192 && dv == 128);
}

// The number of kv shares flash_attention_tf32_fwd takes for this call
// (1: no split), or 0 for head dims it does not take.
extern "C" int flash_attention_tf32_splits(int bh, int s, int d, int dv, int causal, int kind,
                                           int window) {
  if (!takes(d, dv)) return 0;
  if (bh <= 0 || s <= 0) return 1;
  int most, splits;
  if (d == 64 || d == 96)
    plan<64>(bh, s, causal, kind, window, most, splits);
  else
    plan<32>(bh, s, causal, kind, window, most, splits);
  return splits;
}

// q: (bh, s, d) f32; k: (bh / group, s, d) f32; v: (bh / group, s, dv)
// f32; o: (bh, s, dv) f32; contiguous, 16-byte aligned, on the current
// device; (d, dv) in {(64, 64), (96, 96), (128, 128), (256, 256), (192,
// 128)}.  kind: 0 global, 1 local, 2 chunked; softcap > 0 caps the scores
// (in double, the CAP instantiations), 0 does not.  splits is
// flash_attention_tf32_splits' answer; above 1 each q tile's kv tiles
// are cut into that many shares, one block each, joined by a second
// launch, and `part` is scratch of splits * bh * s * (dv + 2) floats
// (else unused).  lse, (bh, s) f32 or null, takes each row's log-sum-exp
// m + log(max(l, 1e-30)) (natural log) for the backward: written by the
// main kernel, or by the join when split.
extern "C" int flash_attention_tf32_fwd(const void* q, const void* k, const void* v, void* o,
                                        void* part, void* lse, int bh, int s, int d, int dv,
                                        int group, int causal, int kind, int window,
                                        double softcap, int splits, void* stream) {
  if (bh <= 0 || s <= 0) return (int)cudaSuccess;
  if (group <= 0 || bh % group || !takes(d, dv)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  float* pf = static_cast<float*>(part);
  float* lf = static_cast<float*>(lse);
  return (int)(softcap > 0.0
                   ? dispatch<true>(qf, kf, vf, of, pf, lf, bh, s, d, group, causal, kind,
                                    window, softcap, splits, st)
                   : dispatch<false>(qf, kf, vf, of, pf, lf, bh, s, d, group, causal, kind,
                                     window, softcap, splits, st));
}
