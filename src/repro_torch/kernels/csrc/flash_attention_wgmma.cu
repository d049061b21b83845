// Forward attention with an online softmax on Hopper's tensor cores
// (sm_90a): the bf16 path for head dims 64, 128 and 256.
//
// Replaces, for bf16 inputs with D in {64, 128, 256}, the Pallas TPU kernel
// `flash_attention` (`_kernel`) of src/repro/kernels/flash_attention.py:
//   q (BH, S, D), k and v (BH / G, S, D), bf16 -> o (BH, S, D) bf16,
// with causal, `local` (sliding window) and `chunked` (aligned chunks of
// `window` keys) masks and an optional tanh softcap on the scores.  Query
// row bh reads kv row bh / G, so MQA and GQA need no repeat of k and v.
// f32 inputs and other head dims stay on the CUDA-core kernel of
// flash_attention.cu; the wrapper picks the path from dtype and D alone.
//
// Arithmetic, as the Pallas kernel does it: s = (q.k) * (1/sqrt(D)) with
// the bf16 products summed in f32 (bf16 x bf16 is exact in f32, so only
// the order of summation differs); softcap s = tanh(s / c) * c, before the
// mask; masked scores take the finite value -2.3819763e38 and keys past S
// take -inf; the running (m, l, acc) are f32, l sums the f32 p, p is
// rounded to bf16 before P.V, which accumulates in f32; o = acc / max(l,
// 1e-30) is written in bf16.
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
//     m64n{BK}k16 steps over D with Q and K in shared memory, and
//     O += P V as m64n{D}k16 steps over the BK keys of a tile, with P
//     taken from registers (S's accumulator layout is the A operand's
//     register layout, so p is rounded to bf16 in place) and V from shared
//     memory as the MN-major B operand (the transpose bit);
//   * O (64 x D f32), m and l live in the warpgroup's registers: D / 2
//     floats of O a thread, 128 at D = 256.  The register budget is met by
//     the tile sizes, not by setmaxnreg: a block is one warpgroup and
//     nothing else, so __launch_bounds__(128, 1) leaves each thread 255
//     registers for O, S (BK / 2), P (BK / 4) and the softmax state (ptxas
//     gives 180 at D = 256, so two blocks fit in an SM's 65,536);
//   * Q, K and V arrive by TMA (cp.async.bulk.tensor, 3-d tensor maps
//     encoded on the host with cuTensorMapEncodeTiled) with the 128-byte
//     swizzle that the wgmma descriptors name.  A row of D bf16 is cut
//     into D / 64 column blocks of 128 bytes, each stored as its own
//     rows x 128 B swizzled tile.  K and V go into a ring of two stages,
//     each with an mbarrier: the copy of tile j + 1 is in flight while
//     tile j's products run, and tile j + 2's copy starts as soon as
//     tile j's products are done;
//   * kv tiles that the mask hides from every row of the q tile are
//     skipped (as in the CUDA-core kernel), and tiles that it shows whole
//     to every row skip the per-element mask;
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

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block: one warpgroup's M
constexpr int kStages = 2;     // K/V ring
constexpr int kThreads = 128;  // one warpgroup
constexpr int kColBlock = 64;  // bf16 columns per 128-byte swizzled block
constexpr float kNegInf = -2.3819763e38f;
constexpr float kLog2e = 1.4426950408889634f;

enum Kind { kGlobal = 0, kLocal = 1, kChunked = 2 };

// Shared memory of one block: Q, then the K ring, then the V ring, then
// the barriers; every tile starts on a 1,024-byte boundary (the 128-byte
// swizzle repeats every 8 rows of 128 bytes).
template <int D, int BK>
struct Layout {
  static constexpr uint32_t kQBytes = kBQ * D * 2;
  static constexpr uint32_t kTileBytes = BK * D * 2;  // one K or V tile
  static constexpr uint32_t kK = kQBytes;
  static constexpr uint32_t kV = kK + kStages * kTileBytes;
  static constexpr uint32_t kBar = kV + kStages * kTileBytes;
  // kStages full barriers and the Q barrier, then slack to align the base
  static constexpr uint32_t kBytes = kBar + 8 * (kStages + 1) + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait for the barrier's phase of the given parity.  A phase that never
// completes (a copy that never lands) is a fault: after about ten
// seconds the kernel traps, so the launch fails instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - start > (1LL << 34)) __trap();
  } while (!done);
}

// One box of a 3-d tensor map (column, row, bh) into shared memory; the
// barrier counts its bytes.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor for a tile in the 128-byte swizzle:
// start address, leading and stride byte offsets (16-byte units), layout
// type 1 (SWIZZLE_128B) in bits 62-63.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the wait (and from reusing them early).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// S (64 x N) = A (64 x 16, shared, K-major) B^T (N x 16, shared, K-major),
// accumulated into d unless scale_d is 0.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int scale_d);

// O (64 x N) += A (64 x 16, registers) B (16 x N, shared, MN-major: the
// transpose bit set).
template <int N>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[N / 2], const uint32_t (&a)[4],
                                            uint64_t db);


template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t da, uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da, uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs_tb<64>(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_tb<128>(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_tb<256>(float (&d)[128], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Whether key kp is visible from query qp under the mask.
__device__ __forceinline__ bool visible(int qp, int kp, int causal, int kind, int window) {
  bool ok = !causal || qp >= kp;
  if (kind == kLocal) ok = ok && (qp - kp) < window;
  else if (kind == kChunked) ok = ok && (qp / window) == (kp / window);
  return ok;
}

template <int D, int BK>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                   int S, int group, float scale, int causal, int kind, int window,
                   float softcap) {
  using L = Layout<D, BK>;
  constexpr int kCols = D / kColBlock;  // 128-byte column blocks per row
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
    mbar_expect_tx(bar, 2 * L::kTileBytes);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      tma_load_3d(sk + st * L::kTileBytes + c * BK * 128, &tk, bar, c * kColBlock, k0, kvh);
      tma_load_3d(sv + st * L::kTileBytes + c * BK * 128, &tv, bar, c * kColBlock, k0, kvh);
    }
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
    for (int c = 0; c < kCols; ++c)
      tma_load_3d(sq + c * kBQ * 128, &tq, qbar, c * kColBlock, q0, bh);
    for (int st = 0; st < kStages && st < n_tiles; ++st) load_kv(st, k_first + st * BK);
  }

  // thread layout of a wgmma accumulator: warp w owns rows 16w .. 16w+15;
  // a thread holds rows r0 and r0 + 8, columns 8j + 2 * (lane % 4) + {0, 1}
  const int warp = tid / 32, lane = tid % 32;
  const int r0 = 16 * warp + lane / 4;
  const int cq = 2 * (lane % 4);
  const int qp0 = q0 + r0, qp1 = qp0 + 8;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;

  mbar_wait(qbar, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages;
    const int k0 = k_first + it * BK;
    mbar_wait(full + 8 * st, (it / kStages) & 1);

    // S = Q K^T over D in steps of 16: column block c, 32-byte step
    // within it (the swizzle is applied by the hardware to the address)
    float s[BK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      const uint64_t da = sw128_desc(sq + (kk / 4) * kBQ * 128 + off, 16, 1024);
      const uint64_t db =
          sw128_desc(sk + st * L::kTileBytes + (kk / 4) * BK * 128 + off, 16, 1024);
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
    for (int i = 0; i < D / 2; i += 4) {
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
      const uint64_t db = sw128_desc(sv + st * L::kTileBytes + kk * 16 * 128, BK * 128, 1024);
      wgmma_rs_tb<D>(acc, pa[kk], db);
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
  __nv_bfloat16* ob = o + (long long)bh * S * D;
  if (qp0 < S) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)qp0 * D + 8 * j + cq) =
          __floats2bfloat162_rn(acc[4 * j] / d0, acc[4 * j + 1] / d0);
    }
  }
  if (qp1 < S) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)qp1 * D + 8 * j + cq) =
          __floats2bfloat162_rn(acc[4 * j + 2] / d1, acc[4 * j + 3] / d1);
    }
  }
}

// cuTensorMapEncodeTiled, looked up with cudaGetDriverEntryPoint (no link
// against libcuda); null when it is not found.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A (rows, s, d) bf16 tensor as a 3-d map (d, s, rows), read in boxes of
// 64 columns (128 bytes, the swizzle's span) by box_rows rows.
bool encode_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int rows, int s, int d,
                int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)rows};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)s * d * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kColBlock, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int BK>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int bh, int s,
                   int group, int causal, int kind, int window, float softcap,
                   cudaStream_t stream) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap mq, mk, mv;
  if (!encode_map(enc, &mq, q, bh, s, D, kBQ) ||
      !encode_map(enc, &mk, k, bh / group, s, D, BK) ||
      !encode_map(enc, &mv, v, bh / group, s, D, BK))
    return cudaErrorInvalidValue;
  const int smem = (int)Layout<D, BK>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<D, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const float scale = (float)(1.0 / sqrt((double)D));
  const dim3 grid(bh, (s + kBQ - 1) / kBQ);
  flash_wgmma_kernel<D, BK><<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), s, group, scale, causal, kind, window,
      softcap);
  return cudaGetLastError();
}

}  // namespace

// q, o: (bh, s, d) bf16; k, v: (bh / group, s, d) bf16; contiguous, 16-byte
// aligned, on the current device; d in {64, 128, 256}.  kind: 0 global, 1
// local, 2 chunked.
//
// Keys per kv tile, by head dim: 32 at D = 256 and 128 (at D = 256, Q and
// a two-stage ring of 32-key tiles take 97 KB, so two blocks share an SM,
// where 64-key tiles would take 161 KB and leave the SM one block), 64 at
// D = 64.  Both sizes were timed at the serving shape on the H100; these
// were the faster.
extern "C" int flash_attention_wgmma_fwd(const void* q, const void* k, const void* v,
                                         void* o, int bh, int s, int d, int group,
                                         int causal, int kind, int window, double softcap,
                                         void* stream) {
  if (bh <= 0 || s <= 0) return (int)cudaSuccess;
  if (group <= 0 || bh % group) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const float cap = (float)softcap;
  switch (d) {
    case 64:
      return (int)launch<64, 64>(q, k, v, o, bh, s, group, causal, kind, window, cap, st);
    case 128:
      return (int)launch<128, 32>(q, k, v, o, bh, s, group, causal, kind, window, cap, st);
    case 256:
      return (int)launch<256, 32>(q, k, v, o, bh, s, group, causal, kind, window, cap, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
