// Rollup window fold: per-window count, sum, min, max, first, last and
// the first/last timestamps of one series' time-sorted points, in float64.
//
// Replaces: the XLA fold of the JAX package's device checkpoint fold,
// opentsdb_tpu/rollup/summary.py _device_fold_fn / fold (a scatter add,
// a scatter min and a scatter max over w = rel_ts // res, plus scatter
// min/max of point indices for the first/last brackets), behind
// window_summaries_device. The TPU ran it in float32; this kernel runs it
// in float64 (the tier declares "device-f64").
//
// Input: rel_ts int32 [n], sorted ascending (the rollup fold's lexsorted,
// deduplicated columns), vals float64 [n]; windows w in [0, W) of res
// seconds. As in the JAX fold, window 0 also takes points below 0 and
// window W - 1 points at or past W * res (the clip).
//
// Design: one warp per window slot, eight warps a block, one launch a
// call, no atomics and no memset (every output slot is written).
// - Two binary searches over rel_ts give the window's [lo, hi): lo is the
//   first point >= w * res (0 for window 0), hi the first >= (w + 1) * res
//   (n for the last window). Neighbouring windows search the same key, so
//   on sorted input the ranges tile [0, n) exactly.
// - Lane l folds points lo + l, lo + l + 32, ... in index order; then a
//   fixed __shfl_xor_sync butterfly (offsets 16, 8, 4, 2, 1) combines the
//   lanes. The sum order is therefore fixed: per lane, a sequential sum
//   over its stride; across lanes, the butterfly tree. Two calls on the
//   same input give identical bits. It is not numpy's pairwise order, so
//   sums agree with the host fold to float64 associativity (rtol 1e-12),
//   and count, min, max, first, last and the brackets exactly.
// - min and max propagate NaN as numpy's minimum / maximum do.
// - Order check without a flag word: each warp checks every adjacent pair
//   (i, i + 1) with i in its [lo, hi), and that lo <= hi. On sorted input
//   that covers every pair once; if any check fails the window's count is
//   written as -1 and the wrapper raises.
//
// Bound: bytes. Each point is read once (4 B timestamp + 8 B value) and
// each window writes 3 int32 + 5 float64 (52 B; the record's 56 B less
// padding). At the rollup tier's shapes (a coarse window's series: ~100
// points, 24 windows) a call is a few hundred bytes, far below the launch
// floor, so the call's cost is the launch and the copies around it.
// A long series (604,800 points, 168 windows) keeps 168 warps busy on 21
// SMs: each lane's loop is unrolled four deep so several loads are in
// flight; a block per window would spread wider, at the cost of a shared
// memory combine (later work).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ int64_t lower_bound(const int32_t* __restrict__ a,
                                               int64_t n, int64_t key) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (static_cast<int64_t>(a[mid]) < key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// numpy's minimum / maximum: NaN wins from either side.
__device__ __forceinline__ double nan_min(double a, double b) {
  return (isnan(a) || a < b) ? a : b;
}
__device__ __forceinline__ double nan_max(double a, double b) {
  return (isnan(a) || a > b) ? a : b;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
window_fold_kernel(const int32_t* __restrict__ rel,
                   const double* __restrict__ vals, int64_t n, int32_t W,
                   int32_t res, int32_t* __restrict__ icol,
                   double* __restrict__ fcol) {
  const int lane = threadIdx.x & 31;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) +
                    (threadIdx.x >> 5);
  if (w >= W) return;
  const int64_t lo =
      w == 0 ? 0 : lower_bound(rel, n, w * static_cast<int64_t>(res));
  const int64_t hi =
      w == W - 1 ? n
                 : lower_bound(rel, n, (w + 1) * static_cast<int64_t>(res));
  bool bad = lo > hi;
  double s = 0.0, mn = INFINITY, mx = -INFINITY;
  if (!bad) {
#pragma unroll 4
    for (int64_t i = lo + lane; i < hi; i += 32) {
      const double v = vals[i];
      s += v;
      mn = nan_min(mn, v);
      mx = nan_max(mx, v);
      if (i + 1 < n && rel[i + 1] < rel[i]) bad = true;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(kFull, s, off);
    mn = nan_min(mn, __shfl_xor_sync(kFull, mn, off));
    mx = nan_max(mx, __shfl_xor_sync(kFull, mx, off));
  }
  bad = __any_sync(kFull, bad);
  if (lane == 0) {
    const int32_t cnt = bad ? -1 : static_cast<int32_t>(hi - lo);
    const bool some = cnt > 0;
    icol[w] = cnt;
    icol[W + w] = some ? rel[lo] : 0;
    icol[2 * static_cast<int64_t>(W) + w] = some ? rel[hi - 1] : 0;
    fcol[w] = s;
    fcol[W + w] = mn;
    fcol[2 * static_cast<int64_t>(W) + w] = mx;
    fcol[3 * static_cast<int64_t>(W) + w] = some ? vals[lo] : 0.0;
    fcol[4 * static_cast<int64_t>(W) + w] = some ? vals[hi - 1] : 0.0;
  }
}

}  // namespace

// icol: int32 [3, W] (count, t_first, t_last); fcol: float64 [5, W] (sum,
// min, max, first, last). Returns the launch's cudaError_t (0 = launched).
extern "C" int rollup_window_fold_f64(const int32_t* rel, const double* vals,
                                      int64_t n, int32_t W, int32_t res,
                                      int32_t* icol, double* fcol,
                                      cudaStream_t stream) {
  if (W <= 0) return 0;
  const int64_t blocks =
      (static_cast<int64_t>(W) + kWarpsPerBlock - 1) / kWarpsPerBlock;
  window_fold_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                       stream>>>(rel, vals, n, W, res, icol, fcol);
  return static_cast<int>(cudaGetLastError());
}
