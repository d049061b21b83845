// 3xTF32 on the tensor cores' mma.sync, shared by the f32 kernels
// (flash_attention_tf32.cu, flash_attention_bwd_tf32.cu and the SSD
// kernels' ssd_scan_tf32.cuh): each f32 operand x goes in as hi = tf32(x)
// and lo = tf32(x - hi), and a product is lo_a hi_b + hi_a lo_b + hi_a
// hi_b summed in f32, the small terms first.  Every operand is rounded to
// TF32 here before the tensor core reads it, so how the hardware treats
// the low 13 bits does not matter.  Each kernel source is its own
// translation unit; everything here has internal linkage.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// f32 rounded to TF32 (the low 13 bits zero) to nearest, ties away from
// zero, as cvt.rna.tf32.f32 does, in two integer operations (the
// conversion instruction issues at a quarter of their rate)
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x as TF32 high and low parts: hi = tf32(x), lo = tf32(x - hi)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(x);
  lo = tf32_bits(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32, the small terms first
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4], float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(d, alo, bh0, bh1);
  mma_tf32(d, ahi, bl0, bl1);
  mma_tf32(d, ahi, bh0, bh1);
}

}  // namespace
