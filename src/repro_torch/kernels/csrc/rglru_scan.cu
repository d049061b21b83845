// RG-LRU linear recurrence for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `rglru_scan` (`_kernel`) of
// src/repro/kernels/rglru_scan.py:
//   a, b (B, S, W) f32, h0 (B, W) f32 or none -> h (B, S, W) f32,
//   h_t = a_t * h_{t-1} + b_t,  h_{-1} = h0 (zeros when absent).
// Each step is a multiply and then an add, each rounded to f32 (no fused
// multiply-add), in time order, so the result is bitwise the plain
// PyTorch loop's.
//
// What bounds it on this card: bytes.  A step does two flops per channel
// and moves 12 bytes (a and b read, h written), so the least time is
// 12*B*S*W bytes over the 3.35 TB/s of device memory: 27.5 us at
// (1, 3000, 2560).  The dependent chain of a channel, a multiply and an
// add a step (some 8-10 cycles), is 3,000 steps there: 15-18 us, under
// the bytes.  What keeps a simple kernel far from the bound is too few
// bytes in flight: by Little's law the card needs some 3 MB in flight
// (3.35 TB/s times ~1 us) to stream at its rate.
//
// The TMA kernel (rglru_tma_kernel, W % 4 == 0): one block per tile of 32
// channels of one batch row, 80 blocks at W = 2,560 (16 channels a block,
// 160 blocks, was the slower on the H100).  Its producer warp has one lane
// issue TMA loads of (32 channels x 64 steps) boxes of a and b into a ring
// of four stages in shared memory (64 KB: some 5 MB in flight across the
// card); its scan warp walks the sequence in time order, lane c owning
// channel c, reads each step's a and b from the ring, writes h straight to
// device memory (one coalesced row of 32 floats a step, off the dependent
// chain) and frees each stage with a second barrier.  The tensor map needs
// a row stride that is a multiple of 16 bytes; the ragged edges of W and S
// are read as zeros and never written.
//
// The first design (rglru_scan_kernel, every other W): one thread per
// channel walks the sequence with the loads of 8 steps in flight; at
// B = 1 and W = 2,560 that is 20 blocks of 128 threads, some 160 KB in
// flight across the card.
//
// The backward (rglru_scan_bwd, rglru_scan_tma_bwd).  The Pallas kernel
// has no backward: the reference trains through `lru_scan`
// (src/repro/models/rglru.py:69, `jax.lax.associative_scan` at :80), which
// XLA differentiates.  The port's train step runs the hand-written
// forward, so its gradient is a kernel here too.  With output h and the
// loss's gradient dh by h, the gradient is itself a linear scan, in
// reverse time:
//   g_t = dh_t + a_{t+1} g_{t+1}   (g_S = 0, a_S = 0)
//   db_t = g_t,  da_t = g_t h_{t-1}  (h_{-1} = h0 or zeros),  dh0 = a_0 g_0
//   a, h, dh (B, S, W) f32, h0 (B, W) f32 or none
//   -> da, db (B, S, W) f32, dh0 (B, W) f32 when asked for.
// Each step is a multiply and then an add, each rounded, in reverse time
// order: bitwise the plain loop (ref.rglru_scan_bwd_ref).  Bytes bound it
// too: 20 bytes a channel a step (a, h and dh read, da and db written),
// 45.8 us at (1, 3000, 2560).  rglru_bwd_tma_kernel (W % 4 == 0) is the
// TMA kernel run backwards: its producer loads boxes of a, h and dh, the
// last steps first, into a ring of four stages (96 KB); its scan warp
// walks each stage from its last step to its first, carrying g and
// a_{t+1} in registers, and writes da and db straight to device memory.
// h_{t-1} of a stage's first step lies in the stage before it in time,
// which arrives after it: the lane reads that one value from device
// memory when it starts the stage, and uses it 64 steps later.  Every box
// starts at a step in [0, S), so no coordinate is negative.
// rglru_bwd_kernel (every other W) is the first design run backwards.
//
// Interface: plain C, bound from Python with ctypes.  Each entry point
// launches on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() (0 on success).

#include <mutex>
#include <set>
#include <utility>

#include "hopper_wgmma.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ h, int S, int W,
                  long long channels) {
  const long long ch = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (ch >= channels) return;
  const long long bi = ch / W;
  const long long base = bi * S * W + ch % W;
  float hv = h0 != nullptr ? h0[ch] : 0.0f;
  for (int t0 = 0; t0 < S; t0 += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u < S) {
        const long long i = base + (long long)(t0 + u) * W;
        av[u] = a[i];
        bv[u] = b[i];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u < S) {
        hv = __fadd_rn(__fmul_rn(av[u], hv), bv[u]);
        h[base + (long long)(t0 + u) * W] = hv;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
rglru_bwd_kernel(const float* __restrict__ a, const float* __restrict__ h,
                 const float* __restrict__ dh, const float* __restrict__ h0,
                 float* __restrict__ da, float* __restrict__ db, float* __restrict__ dh0, int S,
                 int W, long long channels) {
  const long long ch = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (ch >= channels) return;
  const long long base = (ch / W) * S * W + ch % W;
  const float hinit = h0 != nullptr ? h0[ch] : 0.0f;
  float g = 0.0f, a_next = 0.0f;
  for (int t1 = S; t1 > 0; t1 -= kUnroll) {  // steps t1 - 1 down to t1 - kUnroll
    float av[kUnroll], dv[kUnroll], hv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t1 - 1 - u;
      if (t >= 0) {
        const long long i = base + (long long)t * W;
        av[u] = a[i];
        dv[u] = dh[i];
        hv[u] = t > 0 ? h[i - W] : hinit;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t1 - 1 - u;
      if (t >= 0) {
        const long long i = base + (long long)t * W;
        g = __fadd_rn(dv[u], __fmul_rn(a_next, g));
        db[i] = g;
        da[i] = __fmul_rn(g, hv[u]);
        a_next = av[u];
      }
    }
  }
  if (dh0 != nullptr) dh0[ch] = __fmul_rn(a_next, g);
}

// The TMA kernels' shared memory: a ring of stages, each (kSteps x kTile)
// of each of kArrays arrays in turn (a then b forward; a, h, dh backward),
// then a full and an empty barrier per stage; 128 bytes of slack to align
// the ring.
template <int kArrays>
struct Ring {
  static constexpr int kTile = 32;                // channels a block: one warp's lanes
  static constexpr int kSteps = 64;               // time steps a stage: the box's rows
  static constexpr int kStages = 4;               // 64 KB forward, 96 KB backward
  static constexpr int kFloats = kSteps * kTile;  // one array's share of a stage
  static constexpr uint32_t kStageBytes = kArrays * kFloats * 4;
  static constexpr uint32_t kBytes = kStages * kStageBytes + 2 * kStages * 8 + 128;
};

__global__ void __launch_bounds__(64)
rglru_tma_kernel(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mb,
                 const float* __restrict__ h0, float* __restrict__ h, int S, int W,
                 int tiles_w) {
  using L = Ring<2>;
  constexpr int C = L::kTile;
  extern __shared__ unsigned char raw[];
  float* ring = reinterpret_cast<float*>(raw + ((128 - (smem_u32(raw) & 127)) & 127));
  const uint32_t full = smem_u32(ring + L::kStages * 2 * L::kFloats);  // stage k at +8k
  const uint32_t empty = full + 8 * L::kStages;
  const int bi = blockIdx.x / tiles_w;
  const int w0 = (blockIdx.x % tiles_w) * C;
  const int n_stage = (S + L::kSteps - 1) / L::kSteps;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int k = 0; k < L::kStages; ++k) {
      mbar_init(full + 8 * k, 1);
      mbar_init(empty + 8 * k, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 32) {  // the producer warp: one lane issues every load
    if (lane == 0) {
      for (int i = 0; i < n_stage; ++i) {
        const int k = i % L::kStages;
        if (i >= L::kStages) mbar_wait(empty + 8 * k, (i / L::kStages - 1) & 1);
        const uint32_t dst = smem_u32(ring + k * 2 * L::kFloats);
        mbar_expect_tx(full + 8 * k, L::kStageBytes);
        tma_load_3d(dst, &ma, full + 8 * k, w0, i * L::kSteps, bi);
        tma_load_3d(dst + L::kFloats * 4, &mb, full + 8 * k, w0, i * L::kSteps, bi);
      }
    }
    return;
  }

  // the scan warp: lane c owns channel w0 + c, in time order
  const bool live = w0 + lane < W;
  float hv = h0 != nullptr && live ? h0[(long long)bi * W + w0 + lane] : 0.0f;
  float* hp = h + (long long)bi * S * W + w0 + lane;
  for (int i = 0; i < n_stage; ++i) {
    const int k = i % L::kStages;
    mbar_wait(full + 8 * k, (i / L::kStages) & 1);
    const float* as = ring + k * 2 * L::kFloats + lane;
    const float* bs = as + L::kFloats;
    float* hs = hp + (long long)i * L::kSteps * W;
    const int steps = S - i * L::kSteps < L::kSteps ? S - i * L::kSteps : L::kSteps;
    if (live) {
      if (steps == L::kSteps) {
#pragma unroll
        for (int t = 0; t < L::kSteps; ++t) {
          hv = __fadd_rn(__fmul_rn(as[t * C], hv), bs[t * C]);
          hs[(long long)t * W] = hv;
        }
      } else {
        for (int t = 0; t < steps; ++t) {
          hv = __fadd_rn(__fmul_rn(as[t * C], hv), bs[t * C]);
          hs[(long long)t * W] = hv;
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * k);  // every lane has read stage k
  }
}

__global__ void __launch_bounds__(64)
rglru_bwd_tma_kernel(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mh,
                     const __grid_constant__ CUtensorMap mdh, const float* __restrict__ h,
                     const float* __restrict__ h0, float* __restrict__ da,
                     float* __restrict__ db, float* __restrict__ dh0, int S, int W,
                     int tiles_w) {
  using L = Ring<3>;
  constexpr int C = L::kTile;
  extern __shared__ unsigned char raw[];
  float* ring = reinterpret_cast<float*>(raw + ((128 - (smem_u32(raw) & 127)) & 127));
  const uint32_t full = smem_u32(ring + L::kStages * 3 * L::kFloats);  // stage k at +8k
  const uint32_t empty = full + 8 * L::kStages;
  const int bi = blockIdx.x / tiles_w;
  const int w0 = (blockIdx.x % tiles_w) * C;
  const int n_stage = (S + L::kSteps - 1) / L::kSteps;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int k = 0; k < L::kStages; ++k) {
      mbar_init(full + 8 * k, 1);
      mbar_init(empty + 8 * k, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 32) {  // the producer warp: one lane issues every load, last steps first
    if (lane == 0) {
      for (int i = 0; i < n_stage; ++i) {
        const int k = i % L::kStages;
        const int t0 = (n_stage - 1 - i) * L::kSteps;
        if (i >= L::kStages) mbar_wait(empty + 8 * k, (i / L::kStages - 1) & 1);
        const uint32_t dst = smem_u32(ring + k * 3 * L::kFloats);
        mbar_expect_tx(full + 8 * k, L::kStageBytes);
        tma_load_3d(dst, &ma, full + 8 * k, w0, t0, bi);
        tma_load_3d(dst + L::kFloats * 4, &mh, full + 8 * k, w0, t0, bi);
        tma_load_3d(dst + 2 * L::kFloats * 4, &mdh, full + 8 * k, w0, t0, bi);
      }
    }
    return;
  }

  // the scan warp: lane c owns channel w0 + c, in reverse time order
  const bool live = w0 + lane < W;
  const long long col = (long long)bi * W + w0 + lane;
  const float hinit = h0 != nullptr && live ? h0[col] : 0.0f;
  const long long base = (long long)bi * S * W + w0 + lane;
  float g = 0.0f, a_next = 0.0f;
  for (int i = 0; i < n_stage; ++i) {
    const int k = i % L::kStages;
    const int t0 = (n_stage - 1 - i) * L::kSteps;
    // h_{t0 - 1}, used at the stage's last step in this order
    const float h_before = !live ? 0.0f : t0 > 0 ? h[base + (long long)(t0 - 1) * W] : hinit;
    mbar_wait(full + 8 * k, (i / L::kStages) & 1);
    const float* as = ring + k * 3 * L::kFloats + lane;
    const float* hs = as + L::kFloats;
    const float* dhs = hs + L::kFloats;
    const long long off = base + (long long)t0 * W;
    const int steps = S - t0 < L::kSteps ? S - t0 : L::kSteps;
    if (live) {
      if (steps == L::kSteps) {
#pragma unroll 16
        for (int t = L::kSteps - 1; t >= 0; --t) {
          g = __fadd_rn(dhs[t * C], __fmul_rn(a_next, g));
          db[off + (long long)t * W] = g;
          da[off + (long long)t * W] = __fmul_rn(g, t > 0 ? hs[(t - 1) * C] : h_before);
          a_next = as[t * C];
        }
      } else {
        for (int t = steps - 1; t >= 0; --t) {
          g = __fadd_rn(dhs[t * C], __fmul_rn(a_next, g));
          db[off + (long long)t * W] = g;
          da[off + (long long)t * W] = __fmul_rn(g, t > 0 ? hs[(t - 1) * C] : h_before);
          a_next = as[t * C];
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * k);  // every lane has read stage k
  }
  if (dh0 != nullptr && live) dh0[col] = __fmul_rn(a_next, g);
}

// A (batch, s, w) f32 tensor as a 3-d map (w, s, batch), read in boxes of
// (tile channels, steps rows); what lies past an edge reads as zero.
bool encode_f32(EncodeTiled enc, CUtensorMap* map, const float* ptr, int batch, int s, int w,
                int tile, int steps) {
  const cuuint64_t dims[3] = {(cuuint64_t)w, (cuuint64_t)s, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)w * 4, (cuuint64_t)s * w * 4};
  const cuuint32_t box[3] = {(cuuint32_t)tile, (cuuint32_t)steps, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(ptr), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The rings' shared memory is above the default 48 KB: opt each kernel in
// once per device.
std::mutex optin_mu;
std::set<std::pair<const void*, int>> opted_in;

cudaError_t opt_in_smem(const void* kernel, int bytes) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(optin_mu);
  if (opted_in.count({kernel, device})) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) opted_in.insert({kernel, device});
  return err;
}

}  // namespace

// a, b, h: (batch, s, w) f32 contiguous; h0: (batch, w) f32 contiguous or
// null; all on the current device.
extern "C" int rglru_scan_fwd(const float* a, const float* b, const float* h0, float* h,
                              int batch, int s, int w, void* stream) {
  const long long channels = (long long)batch * w;
  if (channels <= 0 || s <= 0) return (int)cudaSuccess;
  const long long blocks = (channels + kThreads - 1) / kThreads;
  rglru_scan_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      a, b, h0, h, s, w, channels);
  return (int)cudaGetLastError();
}

// The TMA kernel.  As rglru_scan_fwd, and a and b 16-byte aligned with
// w % 4 == 0.
extern "C" int rglru_scan_tma_fwd(const float* a, const float* b, const float* h0, float* h,
                                  int batch, int s, int w, void* stream) {
  using L = Ring<2>;
  if (batch <= 0 || s <= 0 || w <= 0) return (int)cudaSuccess;
  if (w % 4) return (int)cudaErrorInvalidValue;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap ma, mb;
  if (!encode_f32(enc, &ma, a, batch, s, w, L::kTile, L::kSteps) ||
      !encode_f32(enc, &mb, b, batch, s, w, L::kTile, L::kSteps))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = opt_in_smem((const void*)rglru_tma_kernel, (int)L::kBytes);
  if (err != cudaSuccess) return (int)err;
  const int tiles_w = (w + L::kTile - 1) / L::kTile;
  rglru_tma_kernel<<<batch * tiles_w, 64, L::kBytes, (cudaStream_t)stream>>>(ma, mb, h0, h, s,
                                                                            w, tiles_w);
  return (int)cudaGetLastError();
}

// a, h, dh, da, db: (batch, s, w) f32 contiguous; h0 and dh0: (batch, w)
// f32 contiguous or null (dh0 is written only when given); all on the
// current device.
extern "C" int rglru_scan_bwd(const float* a, const float* h, const float* dh, const float* h0,
                              float* da, float* db, float* dh0, int batch, int s, int w,
                              void* stream) {
  const long long channels = (long long)batch * w;
  if (channels <= 0 || s <= 0) return (int)cudaSuccess;
  const long long blocks = (channels + kThreads - 1) / kThreads;
  rglru_bwd_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      a, h, dh, h0, da, db, dh0, s, w, channels);
  return (int)cudaGetLastError();
}

// The TMA kernel.  As rglru_scan_bwd, and a, h and dh 16-byte aligned
// with w % 4 == 0.
extern "C" int rglru_scan_tma_bwd(const float* a, const float* h, const float* dh,
                                  const float* h0, float* da, float* db, float* dh0, int batch,
                                  int s, int w, void* stream) {
  using L = Ring<3>;
  if (batch <= 0 || s <= 0 || w <= 0) return (int)cudaSuccess;
  if (w % 4) return (int)cudaErrorInvalidValue;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap ma, mh, mdh;
  if (!encode_f32(enc, &ma, a, batch, s, w, L::kTile, L::kSteps) ||
      !encode_f32(enc, &mh, h, batch, s, w, L::kTile, L::kSteps) ||
      !encode_f32(enc, &mdh, dh, batch, s, w, L::kTile, L::kSteps))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = opt_in_smem((const void*)rglru_bwd_tma_kernel, (int)L::kBytes);
  if (err != cudaSuccess) return (int)err;
  const int tiles_w = (w + L::kTile - 1) / L::kTile;
  rglru_bwd_tma_kernel<<<batch * tiles_w, 64, L::kBytes, (cudaStream_t)stream>>>(
      ma, mh, mdh, h, h0, da, db, dh0, s, w, tiles_w);
  return (int)cudaGetLastError();
}
