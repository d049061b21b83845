// Random-forest inference for Hopper (sm_90a): the two kernels of the
// Jiagu control plane's predictor.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/rfr_inference.py:
//   * rfr_forest_apply   (Pallas `rfr_forest_apply`, `_kernel`/`_descend`)
//       x (N, F) f32 -> tree-mean prediction (N,) f32
//   * rfr_capacity_sweep (Pallas `rfr_capacity_sweep`, `_sweep_kernel`)
//       x (S, M, R, F) f32, bounds (S, M, R) f32 -> capacity (S,) int32:
//       the longest prefix of m = 1..M whose R rows all predict at or
//       under their QoS bound (+inf bound = padded row, passes; -inf =
//       m past the scenario's own m_max, fails), with the prediction
//       exponentiated first under log_target.
//
// The forest is the complete-tree layout feat/thr (T, 2^D-1), leaf
// (T, 2^D).  A prediction descends D levels of
//     idx = 2*idx + 1 + (x[feat[idx]] >= thr[idx])
// in each of the T trees and averages the T leaves.
//
// What bounds it on this card.  Counted by the bytes a call must move,
// the inputs read once, both kernels are memory-bound: the forest is
// 72 KiB at the control plane's 24 trees of depth 8, and a row is 124
// bytes.  What limits them in practice is latency: every level is a
// dependent chain (a shared-memory load of the split, a load of the
// row's feature, a compare), T*D of them per row, rows of a warp gather
// from unrelated nodes, and a block must copy the forest into shared
// memory before its first level.
//
// What the design does about that (both kernels share it):
//   * eight lanes per row: lane j walks trees j, j+8, j+16, ... in order,
//     which is exactly numpy's partial sum r[j]; an xor butterfly at
//     offsets 1, 2, 4 forms ((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7)) in every
//     lane (IEEE addition commutes, so each lane's bits are the same),
//     and the T mod 8 tail trees, one per lane, are added in order.  At
//     T = 24 and depth 8 a row's dependent chain is 24 levels, not 192.
//     Below 8 trees every partial sum is 0 and the tail is all the trees,
//     which is numpy's order there; above 128 the lanes sum each of
//     numpy's pairwise blocks;
//   * the forest is staged as 8-byte nodes (feature, threshold bits), so
//     each level is one shared load of its split, with eight loads of
//     each array in flight per thread (one at a time, a copy waits a
//     device-memory latency per element: some 25 us for the 73 KB
//     forest);
//   * a block of 512 threads takes 64 rows a pass; each pass's rows (F
//     floats each) are copied into shared memory (cp.async, coalesced)
//     while the previous pass descends, so each level's feature read is a
//     shared load;
//   * rfr_forest_apply walks its passes grid-stride, one block per pass
//     up to the blocks the card holds at once;
//   * rfr_capacity_sweep takes one scenario a block at a time and its
//     rows in ascending m, a pass at a time, and skips the rows that
//     cannot change the result.  A row whose bound is -inf fails without
//     a descent: !(pred <= -inf) holds for every pred, NaN included.  A
//     row whose m is at or past the scenario's first failure found so
//     far (read from shared memory after the previous pass's barrier) is
//     skipped, and the scenario ends once a whole pass would be: the
//     capacity is the smallest failing m, and a row at or past a failing
//     m cannot lower it.  Rows with +inf bounds still descend (a NaN
//     prediction fails them).  The device drain pads each scenario's m
//     past its own m_max with -inf rows, so the sweep stops at min(first
//     failure, m_max) instead of descending every padded row;
//   * launch planning (device attributes, the shared-memory opt-in and the
//     occupancy) is done once per device and per (kernel, shared-memory
//     size), not per call;
//   * forests above the shared memory a block can hold (depth 9 and up at
//     64 trees) are read from global memory by the same code: right, not
//     fast.  rfr_forest_apply is told which by its caller (the choice
//     depends on the forest's bytes alone); a forest kernel whose rows do
//     not fit beside the forest reads them from global memory.
//
// rfr_forest_apply_v1 is the first design, kept to be timed beside the
// new one: one thread per row walks all T*D levels, and each block copies
// the forest into shared memory one element at a time per thread.
//
// Numerics.  The T leaves are summed in numpy's pairwise order (eight
// interleaved partial sums per block of at most 128 values, halved
// recursively above that) and divided by T with IEEE division, so a
// prediction is bitwise the one the numpy host oracle makes.  A capacity
// table compares predictions against bounds, and one ulp can move a
// prediction that sits on its bound.  Build without --use_fast_math.
//
// Interface: plain C, bound from Python with ctypes.  Each entry point
// launches on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>
#include <utility>

namespace {

constexpr int kThreads = 256;      // a block of rfr_forest_apply_v1
constexpr int kPwBlock = 128;      // numpy's PW_BLOCKSIZE
constexpr int kLanes = 8;          // lanes per row of the lane-split kernels
constexpr int kDefaultSmemLimit = 48 * 1024;  // above it, opt in per kernel

struct Forest {
  const int* feat;    // (T, NN), NN = 2^D - 1
  const float* thr;   // (T, NN)
  const float* leaf;  // (T, NN + 1)
  int n_trees;
  int depth;
};

__host__ __device__ inline long long forest_floats(int n_trees, int depth) {
  const long long nn = (1LL << depth) - 1;
  return n_trees * (2 * nn + nn + 1);
}

// Leaf value of tree t for the row at xrow.
__device__ __forceinline__ float tree_leaf(const Forest& fo,
                                           const float* __restrict__ xrow,
                                           int t) {
  const int nn = (1 << fo.depth) - 1;
  const int* feat = fo.feat + (long long)t * nn;
  const float* thr = fo.thr + (long long)t * nn;
  int idx = 0;
  for (int d = 0; d < fo.depth; ++d) {
    const float xv = xrow[feat[idx]];
    idx = 2 * idx + 1 + (xv >= thr[idx] ? 1 : 0);
  }
  return fo.leaf[(long long)t * (nn + 1) + (idx - nn)];
}

// The forest with each split packed into one 8-byte node: (feature,
// threshold bits), so a level is one load of its split.
struct PackedForest {
  const int2* node;   // (T, NN)
  const float* leaf;  // (T, NN + 1)
  int n_trees;
  int depth;
};

__device__ __forceinline__ float packed_leaf(const PackedForest& pf,
                                             const float* __restrict__ xrow, int t) {
  const int nn = (1 << pf.depth) - 1;
  const int2* node = pf.node + t * nn;
  int idx = 0;
  for (int d = 0; d < pf.depth; ++d) {
    const int2 nd = node[idx];
    idx = 2 * idx + 1 + (xrow[nd.x] >= __int_as_float(nd.y) ? 1 : 0);
  }
  return pf.leaf[t * (nn + 1) + (idx - nn)];
}

// One row's trees: trees(t) is tree t's leaf value for the row.
struct GlobalTrees {
  const Forest& fo;
  const float* __restrict__ xrow;
  __device__ __forceinline__ float operator()(int t) const { return tree_leaf(fo, xrow, t); }
};
struct PackedTrees {
  const PackedForest& pf;
  const float* __restrict__ xrow;
  __device__ __forceinline__ float operator()(int t) const { return packed_leaf(pf, xrow, t); }
};

// numpy's pairwise_sum for n <= 128 over trees lo .. lo+n-1.
template <class Trees>
__device__ float block_sum(const Trees& trees, int lo, int n) {
  if (n < 8) {
    float res = 0.0f;
    for (int i = 0; i < n; ++i) res += trees(lo + i);
    return res;
  }
  float r[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) r[j] = trees(lo + j);
  int i = 8;
  const int stop = n - n % 8;
  for (; i < stop; i += 8) {
#pragma unroll
    for (int j = 0; j < 8; ++j) r[j] += trees(lo + i + j);
  }
  float res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]));
  for (; i < n; ++i) res += trees(lo + i);
  return res;
}

// numpy's pairwise_sum above one block: split at a multiple of 8.
template <class Trees>
__device__ float pairwise_sum(const Trees& trees, int lo, int n) {
  if (n <= kPwBlock) return block_sum(trees, lo, n);
  int n2 = n / 2;
  n2 -= n2 % 8;
  return pairwise_sum(trees, lo, n2) + pairwise_sum(trees, lo + n2, n - n2);
}

// The tree mean of one row, walked by one thread.
template <class Trees>
__device__ __forceinline__ float tree_mean(const Trees& trees, int n_trees) {
  const float sum = n_trees <= kPwBlock ? block_sum(trees, 0, n_trees)
                                        : pairwise_sum(trees, 0, n_trees);
  return sum / (float)n_trees;
}

// numpy's pairwise_sum for n <= 128 over trees lo .. lo+n-1, by the
// row's eight lanes: lane j keeps numpy's partial sum r[j] over trees
// lo+j, lo+j+8, ... below the last multiple of 8; the butterfly forms
// ((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7)) in every lane; the n mod 8 tail
// trees, one per lane, are then added in order.  For n < 8 every r[j] is
// 0 and the tail is the n trees added to 0 in order, as in numpy (and
// block_sum).  `mask` names the row's eight lanes, an aligned group of
// the warp.
template <class Trees>
__device__ __forceinline__ float lane_block_sum(const Trees& trees, int lo, int n, int lane,
                                                unsigned mask) {
  const int stop = n - n % 8;
  float r = lane < stop ? trees(lo + lane) : 0.0f;
  for (int t = lane + 8; t < stop; t += 8) r += trees(lo + t);
  r += __shfl_xor_sync(mask, r, 1);
  r += __shfl_xor_sync(mask, r, 2);
  r += __shfl_xor_sync(mask, r, 4);
  const int tail = n - stop;
  const float tv = lane < tail ? trees(lo + stop + lane) : 0.0f;
  for (int i = 0; i < tail; ++i) r += __shfl_sync(mask, tv, i, kLanes);
  return r;
}

// numpy's pairwise_sum above one block, by the row's eight lanes together.
template <class Trees>
__device__ float lane_pairwise_sum(const Trees& trees, int lo, int n, int lane,
                                   unsigned mask) {
  if (n <= kPwBlock) return lane_block_sum(trees, lo, n, lane, mask);
  int n2 = n / 2;
  n2 -= n2 % 8;
  return lane_pairwise_sum(trees, lo, n2, lane, mask) +
         lane_pairwise_sum(trees, lo + n2, n - n2, lane, mask);
}

// The tree mean of one row, walked by its eight lanes.
template <class Trees>
__device__ __forceinline__ float lane_mean(const Trees& trees, int n_trees, int lane,
                                           unsigned mask) {
  const float sum = n_trees <= kPwBlock ? lane_block_sum(trees, 0, n_trees, lane, mask)
                                        : lane_pairwise_sum(trees, 0, n_trees, lane, mask);
  return sum / (float)n_trees;
}

// --- the first design (rfr_forest_apply_v1), kept to be timed beside the
// new forest kernel: one thread per row ---

// Copy the forest into shared memory (when it fits) one element at a time
// per thread and return the copy; otherwise return the global arrays.
__device__ Forest stage_forest(const Forest& g, float* smem, bool in_smem) {
  if (!in_smem) return g;
  const int nn = (1 << g.depth) - 1;
  const int n_nodes = g.n_trees * nn;
  const int n_leaf = g.n_trees * (nn + 1);
  int* s_feat = reinterpret_cast<int*>(smem);
  float* s_thr = smem + n_nodes;
  float* s_leaf = s_thr + n_nodes;
  for (int i = threadIdx.x; i < n_nodes; i += blockDim.x) {
    s_feat[i] = g.feat[i];
    s_thr[i] = g.thr[i];
  }
  for (int i = threadIdx.x; i < n_leaf; i += blockDim.x) s_leaf[i] = g.leaf[i];
  __syncthreads();
  return Forest{s_feat, s_thr, s_leaf, g.n_trees, g.depth};
}

__global__ void __launch_bounds__(kThreads)
forest_apply_v1_kernel(const float* __restrict__ x, Forest g,
                       float* __restrict__ out, long long n, int f, bool in_smem) {
  extern __shared__ float smem[];
  const Forest fo = stage_forest(g, smem, in_smem);
  for (long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x; row < n;
       row += (long long)gridDim.x * blockDim.x) {
    out[row] = tree_mean(GlobalTrees{fo, x + row * f}, fo.n_trees);
  }
}

// --- the lane-split kernels ---

// A block: 512 threads, eight lanes a row, 64 rows a pass.
constexpr int kPassThreads = 512;
constexpr int kPassRows = kPassThreads / kLanes;

// Bytes of shared memory: the packed forest, and two buffers of one
// pass's rows (the sweep adds their bounds and the scenario's first
// failing m).
__host__ __device__ inline long long packed_forest_bytes(int n_trees, int depth) {
  const long long nn = (1LL << depth) - 1;
  return n_trees * (8 * nn + 4 * (nn + 1));
}
__host__ __device__ inline long long rows_bytes(int f) { return 2 * 4LL * kPassRows * f; }
__host__ __device__ inline long long sweep_extra_bytes(int f) {
  return rows_bytes(f) + 2 * 4LL * kPassRows + 16;
}

// Copy the forest into shared memory as packed nodes and leaves: kBatch
// loads of each array in flight per thread before their stores.
__device__ void stage_packed(const Forest& g, int2* s_node, float* s_leaf) {
  constexpr int kBatch = 8;
  const int nn = (1 << g.depth) - 1;
  const int n_nodes = g.n_trees * nn;
  const int n_leaf = g.n_trees * (nn + 1);
  for (int i0 = threadIdx.x; i0 < n_leaf; i0 += kBatch * kPassThreads) {
    int fv[kBatch];
    float tv[kBatch], lv[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kPassThreads;
      fv[u] = i < n_nodes ? g.feat[i] : 0;
      tv[u] = i < n_nodes ? g.thr[i] : 0.0f;
      lv[u] = i < n_leaf ? g.leaf[i] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kPassThreads;
      if (i < n_nodes) s_node[i] = make_int2(fv[u], __float_as_int(tv[u]));
      if (i < n_leaf) s_leaf[i] = lv[u];
    }
  }
}

// Asynchronous 4-byte copies from device to shared memory (cp.async):
// a pass's rows are copied while the previous pass descends.
__device__ __forceinline__ void copy_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void copy_async(float* dst, const float* src, int count) {
  for (int i = threadIdx.x; i < count; i += kPassThreads) copy_async4(dst + i, src + i);
}
__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One block walks passes blockIdx.x, blockIdx.x + gridDim.x, ... of 64
// rows; pass i + 1's rows are copied into the second buffer while pass i
// descends (when stage_rows; otherwise each lane reads its row's features
// from device memory).  PACKED: the forest is staged in shared memory.
template <bool PACKED>
__global__ void __launch_bounds__(kPassThreads)
forest_apply_kernel(const float* __restrict__ x, Forest g, float* __restrict__ out,
                    long long n, int f, bool stage_rows) {
  extern __shared__ float smem[];
  const int nn = (1 << g.depth) - 1;
  const int n_nodes = g.n_trees * nn;
  int2* s_node = reinterpret_cast<int2*>(smem);
  float* s_leaf = reinterpret_cast<float*>(s_node + n_nodes);
  float* s_rows = PACKED ? s_leaf + n_nodes + g.n_trees : smem;  // 2 buffers
  if (PACKED) stage_packed(g, s_node, s_leaf);
  const PackedForest pf{s_node, s_leaf, g.n_trees, g.depth};

  const int lr = threadIdx.x / kLanes;  // this thread's row in a pass
  const int lane = threadIdx.x % kLanes;
  const unsigned mask = 0xffu << ((threadIdx.x % 32) & ~7);
  const long long n_pass = (n + kPassRows - 1) / kPassRows;
  auto fetch = [&](long long p, int buf) {
    const long long p0 = p * kPassRows;
    const int n_rows = (int)(n - p0 < kPassRows ? n - p0 : kPassRows);
    copy_async(s_rows + buf * kPassRows * f, x + p0 * f, n_rows * f);
  };
  if (stage_rows) fetch(blockIdx.x, 0);  // the grid holds at most n_pass blocks
  int buf = 0;
  for (long long p = blockIdx.x; p < n_pass; p += gridDim.x, buf ^= 1) {
    if (stage_rows) copy_async_wait();
    __syncthreads();  // pass p (and the forest) landed; every thread left pass p - grid
    if (stage_rows && p + gridDim.x < n_pass) fetch(p + gridDim.x, buf ^ 1);
    const long long row = p * kPassRows + lr;
    if (row < n) {
      const float* xrow = stage_rows ? s_rows + (buf * kPassRows + lr) * f : x + row * f;
      float pred;
      if constexpr (PACKED)
        pred = lane_mean(PackedTrees{pf, xrow}, g.n_trees, lane, mask);
      else
        pred = lane_mean(GlobalTrees{g, xrow}, g.n_trees, lane, mask);
      if (lane == 0) out[row] = pred;
    }
  }
}

// One block takes one scenario at a time (grid-stride over scenarios)
// and its M*R rows in ascending (m, r) order, kPassRows rows a pass; pass
// p + 1's rows and bounds are copied into the second buffer while pass p
// descends.  A failing row lowers the scenario's first failing m with
// atomicMin; the capacity is that m.  The skips, and why each leaves the
// result unchanged:
//   * bound -inf: the row fails whatever it predicts (!(pred <= -inf)
//     holds for every pred, NaN included), so it needs no descent;
//   * m at or past the first failure found so far (read after the
//     previous pass's barrier, so every earlier atomicMin is visible):
//     atomicMin with such an m is a no-op, so the row need not be
//     evaluated; since rows come in ascending m, once the first row of a
//     pass is past it, so is every later row, and the scenario ends.
//     Every thread reads first_fail before the pass's second barrier and
//     no thread lowers it before that barrier, so all read the same value
//     and leave the loop together.
// Rows with +inf bounds still descend: a NaN prediction fails them.
template <bool PACKED>
__global__ void __launch_bounds__(kPassThreads)
capacity_sweep_kernel(const float* __restrict__ x,
                      const float* __restrict__ bounds, Forest g,
                      int* __restrict__ out, long long s, int m, int r, int f,
                      bool log_target) {
  constexpr int kRows = kPassRows;
  extern __shared__ float smem[];
  const int nn = (1 << g.depth) - 1;
  const int n_nodes = g.n_trees * nn;
  const int n_leaf = g.n_trees * (nn + 1);
  int2* s_node = reinterpret_cast<int2*>(smem);
  float* s_leaf = reinterpret_cast<float*>(s_node + n_nodes);
  float* s_rows = PACKED ? s_leaf + n_leaf : smem;  // 2 buffers of kRows * f
  float* s_bnd = s_rows + 2 * kRows * f;            // 2 buffers of kRows
  int* first_fail = reinterpret_cast<int*>(s_bnd + 2 * kRows);
  if (PACKED) stage_packed(g, s_node, s_leaf);
  const PackedForest pf{s_node, s_leaf, g.n_trees, g.depth};

  const int lr = threadIdx.x / kLanes;  // this thread's row in a pass
  const int lane = threadIdx.x % kLanes;
  const unsigned mask = 0xffu << ((threadIdx.x % 32) & ~7);
  const long long per_s = (long long)m * r;
  const long long n_pass = (per_s + kRows - 1) / kRows;
  for (long long sc = blockIdx.x; sc < s; sc += gridDim.x) {
    const float* xs = x + sc * per_s * f;
    const float* bs = bounds + sc * per_s;
    // copy pass p's rows and bounds into buffer p % 2
    auto fetch = [&](long long p) {
      const long long p0 = p * kRows;
      const int n_rows = (int)(per_s - p0 < kRows ? per_s - p0 : kRows);
      copy_async(s_rows + (p % 2) * kRows * f, xs + p0 * f, n_rows * f);
      copy_async(s_bnd + (p % 2) * kRows, bs + p0, n_rows);
    };
    if (threadIdx.x == 0) *first_fail = m;
    fetch(0);
    for (long long p = 0; p < n_pass; ++p) {
      copy_async_wait();
      __syncthreads();  // pass p has landed; pass p - 1's failures are visible
      const int ff = *first_fail;
      const long long p0 = p * kRows;
      // a barrier between every read of first_fail and this pass's atomicMin
      if (__syncthreads_or(p0 / r >= ff)) break;
      if (p + 1 < n_pass) fetch(p + 1);  // into the buffer pass p - 1 used
      const long long row = p0 + lr;
      if (row < per_s) {
        const int mi = (int)(row / r);
        bool fail = false;
        if (mi < ff) {
          const float bnd = s_bnd[(p % 2) * kRows + lr];
          if (bnd == -INFINITY) {
            fail = true;
          } else {
            const float* xrow = s_rows + (p % 2) * kRows * f + lr * f;
            float pred;
            if constexpr (PACKED)
              pred = lane_mean(PackedTrees{pf, xrow}, g.n_trees, lane, mask);
            else
              pred = lane_mean(GlobalTrees{g, xrow}, g.n_trees, lane, mask);
            if (log_target) pred = expf(pred);
            fail = !(pred <= bnd);
          }
        }
        if (fail && lane == 0) atomicMin(first_fail, mi);
      }
    }
    copy_async_wait();
    __syncthreads();  // every thread has read first_fail; no copy in flight
    if (threadIdx.x == 0) out[sc] = *first_fail;
  }
}

// An empty kernel: what a launch through this library costs the card.
__global__ void empty_kernel() {}

// Launch planning, cached: per device its SM count and shared-memory
// opt-in; per (kernel, device) the largest dynamic shared memory opted
// into so far (raised, never lowered, so every size planned before stays
// launchable); per (kernel, device, shared-memory size) the occupancy.
struct Plan {
  int optin = 0;
  int n_sm = 0;
};
std::mutex plan_mu;
std::map<int, Plan> device_plans;
std::map<std::pair<const void*, int>, size_t> kernel_optin;
std::map<std::tuple<const void*, int, size_t>, int> kernel_plans;  // -> blocks per SM

cudaError_t device_plan(int device, Plan* plan) {
  std::lock_guard<std::mutex> lock(plan_mu);
  auto it = device_plans.find(device);
  if (it != device_plans.end()) {
    *plan = it->second;
    return cudaSuccess;
  }
  Plan p;
  cudaError_t err =
      cudaDeviceGetAttribute(&p.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&p.n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  device_plans[device] = p;
  *plan = p;
  return cudaSuccess;
}

// The grid for `kernel` with `smem_bytes` of dynamic shared memory: every
// block that can be resident at once, at most one per work item.
template <typename Kernel>
cudaError_t plan_grid(Kernel kernel, int threads, int device, const Plan& plan,
                      size_t smem_bytes, long long work_items, int* grid) {
  int per_sm = 0;
  {
    std::lock_guard<std::mutex> lock(plan_mu);
    const auto key = std::make_tuple((const void*)kernel, device, smem_bytes);
    auto it = kernel_plans.find(key);
    if (it != kernel_plans.end()) {
      per_sm = it->second;
    } else {
      cudaError_t err;
      size_t& optin = kernel_optin[std::make_pair((const void*)kernel, device)];
      if (smem_bytes > (size_t)kDefaultSmemLimit && smem_bytes > optin) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem_bytes);
        if (err != cudaSuccess) return err;
        optin = smem_bytes;
      }
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                          smem_bytes);
      if (err != cudaSuccess) return err;
      kernel_plans[key] = per_sm;
    }
  }
  const long long resident = (long long)plan.n_sm * (per_sm > 0 ? per_sm : 1);
  *grid = (int)(work_items < resident ? work_items : resident);
  return cudaSuccess;
}

template <bool PACKED>
cudaError_t launch_forest(const float* x, const Forest& g, float* out, long long n, int f,
                          int device, const Plan& plan, cudaStream_t stream) {
  const long long forest = PACKED ? packed_forest_bytes(g.n_trees, g.depth) : 0;
  const bool stage_rows = forest + rows_bytes(f) <= plan.optin;
  const size_t smem = (size_t)(forest + (stage_rows ? rows_bytes(f) : 0));
  int grid = 0;
  cudaError_t err = plan_grid(forest_apply_kernel<PACKED>, kPassThreads, device, plan, smem,
                              (n + kPassRows - 1) / kPassRows, &grid);
  if (err != cudaSuccess) return err;
  forest_apply_kernel<PACKED><<<grid, kPassThreads, smem, stream>>>(x, g, out, n, f,
                                                                   stage_rows);
  return cudaGetLastError();
}

template <bool PACKED>
cudaError_t launch_sweep(const float* x, const float* bounds, const Forest& g, int* out,
                         long long s, int m, int r, int f, bool log_target, int device,
                         const Plan& plan, cudaStream_t stream) {
  const size_t smem = (size_t)((PACKED ? packed_forest_bytes(g.n_trees, g.depth) : 0) +
                               sweep_extra_bytes(f));
  int grid = 0;
  cudaError_t err = plan_grid(capacity_sweep_kernel<PACKED>, kPassThreads, device, plan,
                              smem, s, &grid);
  if (err != cudaSuccess) return err;
  capacity_sweep_kernel<PACKED><<<grid, kPassThreads, smem, stream>>>(x, bounds, g, out, s,
                                                                     m, r, f, log_target);
  return cudaGetLastError();
}

}  // namespace

// in_smem: stage the forest in shared memory (the caller's choice, by the
// forest's bytes; a forest above the block's opt-in fails to launch).
extern "C" int rfr_forest_apply(const float* x, const int* feat, const float* thr,
                                const float* leaf, float* out, long long n, int f,
                                int n_trees, int depth, int in_smem, int device,
                                void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  Plan plan;
  cudaError_t err = device_plan(device, &plan);
  if (err != cudaSuccess) return (int)err;
  const Forest g{feat, thr, leaf, n_trees, depth};
  const cudaStream_t st = (cudaStream_t)stream;
  if (in_smem)
    err = launch_forest<true>(x, g, out, n, f, device, plan, st);
  else
    err = launch_forest<false>(x, g, out, n, f, device, plan, st);
  return (int)err;
}

extern "C" int rfr_forest_apply_v1(const float* x, const int* feat, const float* thr,
                                   const float* leaf, float* out, long long n, int f,
                                   int n_trees, int depth, int device, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  Plan plan;
  cudaError_t err = device_plan(device, &plan);
  if (err != cudaSuccess) return (int)err;
  const long long forest_bytes = 4 * forest_floats(n_trees, depth);
  const bool in_smem = forest_bytes <= plan.optin;
  const size_t smem = in_smem ? (size_t)forest_bytes : 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  int grid = 0;
  err = plan_grid(forest_apply_v1_kernel, kThreads, device, plan, smem, blocks, &grid);
  if (err != cudaSuccess) return (int)err;
  const Forest g{feat, thr, leaf, n_trees, depth};
  forest_apply_v1_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(x, g, out, n, f,
                                                                         in_smem);
  return (int)cudaGetLastError();
}

extern "C" int rfr_empty(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

extern "C" int rfr_capacity_sweep(const float* x, const float* bounds, const int* feat,
                                  const float* thr, const float* leaf, int* out,
                                  long long s, int m, int r, int f, int n_trees,
                                  int depth, int log_target, int device, void* stream) {
  if (s <= 0 || (long long)m * r <= 0) return (int)cudaSuccess;
  Plan plan;
  cudaError_t err = device_plan(device, &plan);
  if (err != cudaSuccess) return (int)err;
  const Forest g{feat, thr, leaf, n_trees, depth};
  const cudaStream_t st = (cudaStream_t)stream;
  const bool packed =
      packed_forest_bytes(n_trees, depth) + sweep_extra_bytes(f) <= plan.optin;
  if (packed)
    err = launch_sweep<true>(x, bounds, g, out, s, m, r, f, log_target != 0, device, plan, st);
  else
    err = launch_sweep<false>(x, bounds, g, out, s, m, r, f, log_target != 0, device, plan, st);
  return (int)err;
}
