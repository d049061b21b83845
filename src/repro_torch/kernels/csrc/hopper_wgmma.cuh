// Hopper building blocks shared by the port's TMA-fed kernels
// (flash_attention_wgmma.cu, flash_attention_bwd_wgmma.cu,
// ssd_scan_wgmma.cu, ssd_scan_bwd_wgmma.cu, rglru_scan.cu) and the SSD
// scan's 3xTF32 kernels (ssd_scan_tf32.cu, ssd_scan_bwd_tf32.cu):
// mbarriers, TMA loads and stores through 3-d tensor maps, wgmma
// descriptors for the 128-byte swizzle and element access to such tiles,
// the bf16 warpgroup MMAs the tensor-core kernels issue, the split of f32
// values into bf16 high and low parts, the SSD chunk's warp scan of dA,
// and the attention softcap's tanh (fast_tanh).  Each kernel source is its own
// translation unit and library; this header is included by each
// (everything here has internal linkage).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kColBlock = 64;  // bf16 columns per 128-byte swizzled block

// The 128-byte column blocks a row of d bf16 columns takes in shared
// memory, and the columns they hold.  A head dim that is no multiple of
// 64 (hubert-xlarge's 80) is kept as whole blocks: its tensor map is d
// columns wide, so the TMA's out-of-bounds fill writes zeros past column
// d, and a box lands (and its barrier counts it) whole.
__host__ __device__ constexpr int col_blocks(int d) { return (d + kColBlock - 1) / kColBlock; }
__host__ __device__ constexpr int padded_cols(int d) { return col_blocks(d) * kColBlock; }

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

// One arrival on the barrier (no bytes).
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
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

// Shared memory -> global through a 3-d tensor map (bulk async group).
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Wait until at most N bulk stores still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// Make this thread's shared-memory writes visible to the async proxy (TMA).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of element (row r, column c) of a bf16 tile of 128-byte rows
// in the 128-byte swizzle.
__device__ __forceinline__ int sw_off(int r, int c) {
  return r * 128 + (((c >> 3) ^ (r & 7)) << 4) + (c & 7) * 2;
}

// Element (row r, column c) of a bf16 tile of 128-byte rows stored in the
// 128-byte swizzle: the 16-byte unit c / 8 of row r sits at unit
// (c / 8) ^ (r % 8).
__device__ __forceinline__ float sw_at(const uint8_t* tile, int r, int c) {
  return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(tile + sw_off(r, c)));
}

// Inclusive warp scan of the chunk's 64 dA values, two a lane (rows lane
// and 32 + lane); returns the chunk's total in every lane.
__device__ __forceinline__ float warp_cumsum(float& v0, float& v1, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float u0 = __shfl_up_sync(0xffffffffu, v0, d);
    const float u1 = __shfl_up_sync(0xffffffffu, v1, d);
    if (lane >= d) {
      v0 += u0;
      v1 += u1;
    }
  }
  v1 += __shfl_sync(0xffffffffu, v0, 31);
  return __shfl_sync(0xffffffffu, v1, 31);
}

// Sum over the four lanes that share a row of an accumulator (a fixed
// xor tree).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The SSD backward's per-row vectors of one head's chunk (the tensor-core
// backwards of ssd_scan_bwd_wgmma.cu and ssd_scan_bwd_tf32.cu), each
// kSsdChunk floats, and warp 0's step that turns them into ddt and ddA.
constexpr int kSsdChunk = 64;  // rows per SSD chunk


struct Rows {
  float *cum, *dt, *w, *ecum;  // cum, dt, e^{cum_L - cum} dt, e^{cum}
  float *rowq;                 // sum_{j<i} Q_ij
  float *v;                    // C_i . (dy_i h_in)
  float *s, *diag;             // sum_{i>j} Gm_ij, Gm_jj
  float *u;                    // B_j . (x_j g)
  float* gh;                   // <g, h_in>, one partial a warp of the row side
  __device__ explicit Rows(float* p)
      : cum(p), dt(p + kSsdChunk), w(p + 2 * kSsdChunk), ecum(p + 3 * kSsdChunk),
        rowq(p + 4 * kSsdChunk), v(p + 5 * kSsdChunk), s(p + 6 * kSsdChunk),
        diag(p + 7 * kSsdChunk), u(p + 8 * kSsdChunk), gh(p + 9 * kSsdChunk) {}
};

// Warp 0: ddt and ddA of a head's chunk from its rows' vectors.  Lane l
// takes rows l and l + 32; ddA's reverse cumulative sum is a warp scan of
// fixed order.
__device__ __forceinline__ void finish_rows(const Rows& rv, float* __restrict__ ddt,
                                            float* __restrict__ ddA, long long row0, int valid,
                                            int lane) {
  float d[2], wu = 0.0f;
  const float last = rv.cum[kSsdChunk - 1];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = lane + 32 * e;
    d[e] = rv.rowq[r] - rv.dt[r] * rv.s[r] + rv.ecum[r] * rv.v[r] - rv.w[r] * rv.u[r];
    if (r < valid) ddt[row0 + r] = (rv.diag[r] + rv.s[r]) + expf(last - rv.cum[r]) * rv.u[r];
    wu = fmaf(rv.w[r], rv.u[r], wu);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) wu += __shfl_xor_sync(0xffffffffu, wu, off);
  const float gh = ((rv.gh[0] + rv.gh[1]) + rv.gh[2]) + rv.gh[3];
  const float extra = wu + expf(last) * gh;  // dcum_L's own terms, at the last valid row
#pragma unroll
  for (int e = 0; e < 2; ++e)
    if (lane + 32 * e == valid - 1) d[e] += extra;
  // suffix sums: rows lane.. of each half, then the upper half's total
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float t0 = __shfl_down_sync(0xffffffffu, d[0], off);
    const float t1 = __shfl_down_sync(0xffffffffu, d[1], off);
    if (lane + off < 32) {
      d[0] += t0;
      d[1] += t1;
    }
  }
  d[0] += __shfl_sync(0xffffffffu, d[1], 0);
#pragma unroll
  for (int e = 0; e < 2; ++e)
    if (lane + 32 * e < valid) ddA[row0 + lane + 32 * e] = d[e];
}

// tanh of a softcapped score from the MUFU unit's two fast steps: with
// k2 = 2 log2(e) scale / softcap, y = s scale / softcap and
// r = 1 / (2^(|s| k2) + 1) (ex2.approx, rcp.approx: about 2^-22 relative
// each), tanh(y) = sign(s) (1 - 2 r); r is also returned, since the
// backward's 1 - tanh(y)^2 = 4 r (1 - r) has no cancellation that way.
// Its absolute error is about 1e-6 at most, for every s (2^(|s| k2)
// past f32's range gives r = 0 and tanh = +-1): two MUFU steps where
// tanhf and an IEEE division take some twenty instructions.
__device__ __forceinline__ float fast_tanh(float s, float k2, float& r) {
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(fabsf(s) * k2));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(e + 1.0f));
  return copysignf(fmaf(-2.0f, r, 1.0f), s);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (a, b) as bf16 high and low parts (v - hi rounded again), packed in
// pairs: hi + lo carries about 16 bits of each f32 value.
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
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
// 64 columns (128 bytes, the swizzle's span) by box_rows rows; d a
// multiple of 8 (a row's stride a multiple of 16 bytes), a box's columns
// past d read as zeros.
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

}  // namespace
