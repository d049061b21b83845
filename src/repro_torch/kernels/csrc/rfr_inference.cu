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
// dependent chain (shared-memory load of the split, a load of the row's
// feature, a compare), T*D of them per row, and rows of a warp gather
// from unrelated nodes, so the loads serialise on shared-memory banks.
//
// What the design does about that:
//   * each block copies the forest into shared memory once and keeps it
//     there while it walks many rows (grid-stride), so the forest is
//     read from device memory once per resident block, not per row;
//   * one thread owns one row and walks its trees in order, so many
//     independent chains are in flight per SM to hide the latency;
//   * forests above the 227 KB a block can hold in shared memory (depth
//     9 and up at 64 trees) are read from global memory by the same
//     code: right, not fast.
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

namespace {

constexpr int kThreads = 256;
constexpr int kPwBlock = 128;      // numpy's PW_BLOCKSIZE
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

// numpy's pairwise_sum for n <= 128 over trees lo .. lo+n-1.
__device__ float block_sum(const Forest& fo, const float* __restrict__ xrow,
                           int lo, int n) {
  if (n < 8) {
    float res = 0.0f;
    for (int i = 0; i < n; ++i) res += tree_leaf(fo, xrow, lo + i);
    return res;
  }
  float r[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) r[j] = tree_leaf(fo, xrow, lo + j);
  int i = 8;
  const int stop = n - n % 8;
  for (; i < stop; i += 8) {
#pragma unroll
    for (int j = 0; j < 8; ++j) r[j] += tree_leaf(fo, xrow, lo + i + j);
  }
  float res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]));
  for (; i < n; ++i) res += tree_leaf(fo, xrow, lo + i);
  return res;
}

// numpy's pairwise_sum above one block: split at a multiple of 8.
__device__ float pairwise_sum(const Forest& fo, const float* __restrict__ xrow,
                              int lo, int n) {
  if (n <= kPwBlock) return block_sum(fo, xrow, lo, n);
  int n2 = n / 2;
  n2 -= n2 % 8;
  return pairwise_sum(fo, xrow, lo, n2) + pairwise_sum(fo, xrow, lo + n2, n - n2);
}

__device__ __forceinline__ float predict_row(const Forest& fo,
                                             const float* __restrict__ xrow) {
  const float sum = fo.n_trees <= kPwBlock ? block_sum(fo, xrow, 0, fo.n_trees)
                                           : pairwise_sum(fo, xrow, 0, fo.n_trees);
  return sum / (float)fo.n_trees;
}

// Copy the forest into shared memory (when it fits) and return the copy;
// otherwise return the global arrays unchanged.
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
forest_apply_kernel(const float* __restrict__ x, Forest g,
                    float* __restrict__ out, long long n, int f, bool in_smem) {
  extern __shared__ float smem[];
  const Forest fo = stage_forest(g, smem, in_smem);
  for (long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x; row < n;
       row += (long long)gridDim.x * blockDim.x) {
    out[row] = predict_row(fo, x + row * f);
  }
}

// Each block iteration takes `per_iter` consecutive scenarios and scores
// all of their M*R rows, one row per thread.  A failing row lowers its
// scenario's first failing m with atomicMin; the capacity is that m.
// atomicMin is order-free, so the result does not depend on how the
// scenarios are split across blocks or iterations, and M may be any size.
__global__ void __launch_bounds__(kThreads)
capacity_sweep_kernel(const float* __restrict__ x,
                      const float* __restrict__ bounds, Forest g,
                      int* __restrict__ out, long long s, int m, int r, int f,
                      int per_iter, bool log_target, bool in_smem) {
  extern __shared__ float smem[];
  const Forest fo = stage_forest(g, smem, in_smem);
  int* first_fail =
      reinterpret_cast<int*>(smem + (in_smem ? forest_floats(g.n_trees, g.depth) : 0));
  const long long rows_per_s = (long long)m * r;
  for (long long s0 = (long long)blockIdx.x * per_iter; s0 < s;
       s0 += (long long)gridDim.x * per_iter) {
    const int n_s = (int)(s - s0 < per_iter ? s - s0 : per_iter);
    for (int i = threadIdx.x; i < n_s; i += blockDim.x) first_fail[i] = m;
    __syncthreads();
    const long long base = s0 * rows_per_s;
    const long long n_rows = n_s * rows_per_s;
    for (long long i = threadIdx.x; i < n_rows; i += blockDim.x) {
      const long long row = base + i;
      float pred = predict_row(fo, x + row * f);
      if (log_target) pred = expf(pred);
      if (!(pred <= bounds[row])) {
        const int local_s = (int)(i / rows_per_s);
        const int mi = (int)((i % rows_per_s) / r);
        atomicMin(&first_fail[local_s], mi);
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n_s; i += blockDim.x) out[s0 + i] = first_fail[i];
    __syncthreads();
  }
}

// Dynamic shared memory for a launch, whether the forest goes into it,
// and the grid: every block that can be resident at once, at most one
// per work item.
template <typename Kernel>
cudaError_t plan_launch(Kernel kernel, int device, int n_trees, int depth,
                        long long extra_bytes, long long work_items,
                        size_t* smem_bytes, bool* in_smem, int* grid) {
  int optin = 0, n_sm = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long forest_bytes = 4 * forest_floats(n_trees, depth);
  *in_smem = forest_bytes + extra_bytes <= optin;
  *smem_bytes = (size_t)((*in_smem ? forest_bytes : 0) + extra_bytes);
  if (*smem_bytes > (size_t)kDefaultSmemLimit) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)*smem_bytes);
    if (err != cudaSuccess) return err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                      *smem_bytes);
  if (err != cudaSuccess) return err;
  const long long resident = (long long)n_sm * (per_sm > 0 ? per_sm : 1);
  *grid = (int)(work_items < resident ? work_items : resident);
  return cudaSuccess;
}

}  // namespace

extern "C" int rfr_forest_apply(const float* x, const int* feat, const float* thr,
                                const float* leaf, float* out, long long n, int f,
                                int n_trees, int depth, int device, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  size_t smem = 0;
  bool in_smem = false;
  int grid = 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  cudaError_t err = plan_launch(forest_apply_kernel, device, n_trees, depth, 0,
                                blocks, &smem, &in_smem, &grid);
  if (err != cudaSuccess) return (int)err;
  const Forest g{feat, thr, leaf, n_trees, depth};
  forest_apply_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(x, g, out, n, f,
                                                                      in_smem);
  return (int)cudaGetLastError();
}

extern "C" int rfr_capacity_sweep(const float* x, const float* bounds, const int* feat,
                                  const float* thr, const float* leaf, int* out,
                                  long long s, int m, int r, int f, int n_trees,
                                  int depth, int log_target, int device, void* stream) {
  const long long rows_per_s = (long long)m * r;
  if (s <= 0 || rows_per_s <= 0) return (int)cudaSuccess;
  const int per_iter =
      rows_per_s >= kThreads ? 1 : (int)(kThreads / rows_per_s);
  size_t smem = 0;
  bool in_smem = false;
  int grid = 0;
  const long long work = (s + per_iter - 1) / per_iter;
  cudaError_t err = plan_launch(capacity_sweep_kernel, device, n_trees, depth,
                                4LL * per_iter, work, &smem, &in_smem, &grid);
  if (err != cudaSuccess) return (int)err;
  const Forest g{feat, thr, leaf, n_trees, depth};
  capacity_sweep_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, bounds, g, out, s, m, r, f, per_iter, log_target != 0, in_smem);
  return (int)cudaGetLastError();
}
