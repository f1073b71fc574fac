// Rollup window fold: per-window count, sum, min, max, first, last and
// the first/last timestamps of many series' time-sorted points at several
// resolutions, in float64, in one launch.
//
// Replaces: the XLA fold of the JAX package's device checkpoint fold,
// opentsdb_tpu/rollup/summary.py _device_fold_fn / fold (a scatter add,
// a scatter min and a scatter max over w = rel_ts // res, plus scatter
// min/max of point indices for the first/last brackets), behind
// window_summaries_device, which the JAX tier calls once a (series,
// resolution). The TPU ran it in float32; this kernel runs it in float64
// (the tier declares "device-f64").
//
// Input: S segments (series) of one coarse window, concatenated:
// rel_ts int32 [n] (timestamps less the group's origin, sorted ascending
// within each segment: the rollup fold's lexsorted, deduplicated
// columns), vals float64 [n], offsets int64 [S + 1]. Up to kMaxRes
// resolutions; resolution i has W_i windows of res_i seconds from the
// origin. As in the JAX fold, window 0 also takes points below 0 and
// window W_i - 1 points at or past W_i * res_i (the clip).
//
// Output: a dense grid of slots (resolution, series, window), slot
// slot0[i] + j * W_i + w, every slot written: icol int32 [3, N] (count,
// t_first, t_last) and fcol float64 [5, N] (sum, min, max, first, last).
//
// Design: one warp per slot, eight warps a block, one launch for the
// whole group, no atomics and no memset.
// - Two binary searches over the slot's series give the window's
//   [lo, hi): lo is the first point >= w * res (the series' start for
//   window 0), hi the first >= (w + 1) * res (its end for the last
//   window). Neighbouring windows search the same key, so on sorted input
//   the ranges tile each series exactly.
// - Lane l folds points lo + l, lo + l + 32, ... in index order; then a
//   fixed __shfl_xor_sync butterfly (offsets 16, 8, 4, 2, 1) combines the
//   lanes. The sum order is therefore fixed: per lane, a sequential sum
//   over its stride; across lanes, the butterfly tree. It is the order of
//   the one-call-a-(series, resolution) kernel this one replaced, so a
//   record's bytes are the ones that kernel wrote and a tier folded by
//   it opens without a rebuild (the kind stays "device-f64"). Keep the
//   order: a faster one would put records of two orders in one stored
//   row, which is what a fold-kind change exists to forbid. The plain
//   version (ops/rollup_fold.py) reproduces it, so the two agree bit for
//   bit; against numpy's pairwise sums the records agree to float64
//   associativity (rtol 1e-12), count, min, max, first, last and the
//   brackets exactly.
// - min and max propagate NaN as numpy's minimum / maximum do.
// - Order check without a flag word: each warp checks every adjacent pair
//   (i, i + 1) of its series with i in its [lo, hi), and that lo <= hi.
//   If the searches' ranges are monotone they tile the series and every
//   pair is checked; if not, some lo > hi. A slot that sees a violation
//   writes count -1, and the wrapper raises after its one read-back.
//
// Bound: bytes. Each point is read once (4 B timestamp + 8 B value), the
// offsets once, and each slot writes 3 int32 + 5 float64 (52 B). The
// tier's group (2,500 series x one day, 143 points each, resolutions 1 h
// and 1 d: 25 slots a series) is ~4.3 MB in and ~3.3 MB out: ~2.3 us at
// the card's 3.35 TB/s. The kernel it replaced ran once a (series,
// resolution) at ~1.7 KB a call, so each call cost the launch floor
// (~1.8 us on the card) and the wrapper's host work around it (two
// uploads, a sync, a read-back: ~0.2-0.3 ms); a group is now one launch,
// two uploads and one read-back.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;
constexpr int kMaxRes = 8;

}  // namespace

// The slot grid: resolution i has W_i = windows[i] windows of res[i]
// seconds, its slots start at slot0[i]; slot0[nres] is the grid's size.
struct FoldGrid {
  int32_t nres;
  int32_t res[kMaxRes];
  int32_t windows[kMaxRes];
  int64_t slot0[kMaxRes + 1];
};

namespace {

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
                   const double* __restrict__ vals,
                   const int64_t* __restrict__ offs, const FoldGrid g,
                   int32_t* __restrict__ icol, double* __restrict__ fcol) {
  const int lane = threadIdx.x & 31;
  const int64_t N = g.slot0[g.nres];
  const int64_t slot = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                       (threadIdx.x >> 5);
  if (slot >= N) return;  // warp-uniform: a warp owns one slot
  int i = 0;
  while (slot >= g.slot0[i + 1]) ++i;
  const int64_t W = g.windows[i];
  const int64_t res = g.res[i];
  const int64_t local = slot - g.slot0[i];
  const int64_t series = local / W;
  const int64_t w = local - series * W;
  const int64_t a = offs[series], b = offs[series + 1];
  const int64_t n = b - a;
  bool bad = n < 0;
  int64_t lo = a, hi = a;
  if (!bad) {
    const int32_t* const r = rel + a;
    lo = a + (w == 0 ? 0 : lower_bound(r, n, w * res));
    hi = a + (w == W - 1 ? n : lower_bound(r, n, (w + 1) * res));
    bad = lo > hi;
  }
  double s = 0.0, mn = INFINITY, mx = -INFINITY;
  if (!bad) {
#pragma unroll 4
    for (int64_t k = lo + lane; k < hi; k += 32) {
      const double v = vals[k];
      s += v;
      mn = nan_min(mn, v);
      mx = nan_max(mx, v);
      if (k + 1 < b && rel[k + 1] < rel[k]) bad = true;
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
    icol[slot] = cnt;
    icol[N + slot] = some ? rel[lo] : 0;
    icol[2 * N + slot] = some ? rel[hi - 1] : 0;
    fcol[slot] = s;
    fcol[N + slot] = mn;
    fcol[2 * N + slot] = mx;
    fcol[3 * N + slot] = some ? vals[lo] : 0.0;
    fcol[4 * N + slot] = some ? vals[hi - 1] : 0.0;
  }
}

}  // namespace

// icol: int32 [3, N] (count, t_first, t_last); fcol: float64 [5, N] (sum,
// min, max, first, last), N = grid->slot0[grid->nres]. Returns the
// launch's cudaError_t (0 = launched); 1 (cudaErrorInvalidValue) for a
// grid the kernel does not take.
extern "C" int rollup_window_fold_f64(const int32_t* rel, const double* vals,
                                      const int64_t* offs,
                                      const FoldGrid* grid, int32_t* icol,
                                      double* fcol, cudaStream_t stream) {
  if (grid->nres < 1 || grid->nres > kMaxRes)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t N = grid->slot0[grid->nres];
  if (N <= 0) return 0;
  const int64_t blocks = (N + kWarpsPerBlock - 1) / kWarpsPerBlock;
  window_fold_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                       stream>>>(rel, vals, offs, *grid, icol, fcol);
  return static_cast<int>(cudaGetLastError());
}
