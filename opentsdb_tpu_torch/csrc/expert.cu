// The finish of an expert-parallel dashboard shard (parallel/expert.py).
//
// Replaces no Pallas kernel. It is the per-slot tail of the JAX package's
// dashboard body, opentsdb_tpu/parallel/expert.py: moment_slot and
// pct_slot (:400-418) from the series stage's segment moments on, that
// is _dash_series_stage's finish (:376-388, _finish_switch :279-283),
// gap_fill, group_moments and _finish_switch again
// (opentsdb_tpu/ops/kernels.py). XLA runs those as a chain of
// elementwise, scan and reduction ops a slot; here one launch finishes
// every slot of a shard.
//
// dash_finish_f32 -- for slot q of Q over the series stage's [Q, S * B]
// float32 moment planes (count, sum, centred m2, min, max; each plane a
// strided view, read in place), with the slot's downsampler ds[q] and
// group aggregator agg[q] in DASH_AGGS order (sum, min, max, avg, dev,
// count):
//   1. the series finish: v = _finish(ds[q]) of each (s, b), as
//        sum: total; min: min; max: max; avg: total / max(count, 1);
//        dev: sqrt(max(m2, 0) / max(count, 1)); count: count,
//      and the series mask count > 0;
//   2. the gap fill of each series row (gap_fill without carries): a
//      bucket between two non-empty ones takes the lerp
//      prev + frac * (next - prev), frac = (b - prev_b) / max(next_b -
//      prev_b, 1); in_range = a non-empty bucket at or before it and one
//      at or after it; filled = 0 outside the range;
//   3. a moment shard: over the S series of each bucket, n = the
//      in-range count, total, mean = total / max(n, 1), the centred m2 =
//      sum((filled - mean)^2) in a second pass around the group mean,
//      min and max (NaN propagates), then _finish(agg[q]): values [Q, B];
//   4. fill mode (a percentile shard; agg absent): filled [Q, S, B] and
//      in_range [Q, S, B] instead of step 3;
//   and gm [Q, B] = any over s of the series mask, in both modes.
//   A slot reads count and the planes its downsampler needs; a plane no
// slot of the launch needs may be null.
//
// finish_cells_f32 -- step 1 alone over [Q, cells] planes: the per-cell
// finish that the dashboard ran twice a moment slot before the fused
// kernel (over the series stage, and over the group moments). It is kept
// to time that chain beside the fused kernel and to hold step 1's
// arithmetic: no path launches it.
//
// Design (dash_finish_f32). A slot's S rows split over a thread-block
// cluster of P <= 8 blocks (P = ceil(S / 16), at most 8), so that a shard
// of 15 slots puts 120 blocks on the card's 132 SMs; B splits into tiles
// of 32 K buckets (K = 1, 2, 4 or 8 chunks, the fewest that hold B, up
// to 8), a cluster each. A warp takes R = 8 / K of its rows a step, 32
// buckets a chunk, and issues all R K chunks' loads before it uses any:
// at the day (B = 32) eight rows at once, at the week (B = 256) a row's
// eight chunks.
//   - __ballot_sync of the non-empty buckets gives each chunk's mask; a
//     bucket's previous and next non-empty bucket in the chunk are the
//     highest set bit at or below its lane (__clz) and the lowest at or
//     above it (__ffs), their values fetched with __shfl_sync;
//   - the last non-empty (index, value) carries left to right across the
//     chunks, and a backward pass over the masks gives each chunk the
//     first non-empty one after it; a row whose tile lacks a neighbour
//     searches the buckets outside the tile chunk by chunk, only then
//     (B past 256);
//   - each lane keeps its buckets' group partials (count, sum, min, max,
//     any) in registers over the warp's rows; the warps' partials meet in
//     shared memory in warp order, the blocks' through distributed shared
//     memory in rank order, so every sum runs in a fixed order;
//   - dev takes a second pass: every block reads the cluster's sums for
//     the group mean, recomputes its rows' fill from the planes (in L2
//     since the first pass; [S, 256] floats of a slot would not fit a
//     block's shared memory at S = 1,024) and sums the centred squares;
//     rank 0 finishes the tile's buckets.
//   Count and sum come from one stacked segment sum, so their planes
// interleave (stride 2 or 3): a warp's chunk is one 256- or 384-byte
// span that both planes' loads share, and 16-byte vector loads do not
// apply.
//   Bound: bytes. Each slot reads count and its downsampler's planes once
// (4 S B bytes each: count for count, two for sum, min, max, avg and dev)
// and writes values and gm (5 B bytes), or in fill mode filled, in_range
// and gm (5 S B + B bytes); the codes are 8 Q bytes. The smoke's day
// dashboard (10,000 series in 10 dc groups: S = 1,024, B = 32, 15 slots a
// shard) reads 1.97 MB a plane, the week (B = 256) 15.7 MB; a moment
// shard of avg slots moves 3.9 MB (1.2 us at 3.35 TB/s) and 31.5 MB
// (9.4 us), under the launch floor at the day.
//   What limits it: latency, not bytes. A warp step is a chain (its
// loads, then the ballots, shuffles, carries and two IEEE divisions a
// bucket); a warp holds 8 rows of a slot at S = 1,024, one step at the
// day and eight at the week, then the block and cluster combines and,
// for dev, the whole second pass. On the H100 one slot alone takes about
// as long as fifteen side by side, and dev's pass doubles the time, so a
// slot's chain sets the time at 7.6-21% of the bound (PERF.md's kernel
// table).
//
// Rounding: the series finish divides and takes the square root with the
// correctly rounded _rn intrinsics, as torch does, and the lerp is
// __fsub_rn, __fmul_rn, __fadd_rn with the index difference converted by
// __int2float_rn, so nvcc contracts nothing into an FMA: filled, in_range,
// the masks, count, min and max equal the plain version (ops/
// expert_finish.py) bit for bit. The group sums and the centred m2 add in
// the kernel's order (lanes over rows, then warps, then blocks), the
// plain version in torch's, so they agree to float32 tolerance. Never
// build this file with nvcc's fast-math flag: it flushes denormals to
// zero, and the bit-for-bit contract keeps them.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;          // finish_cells
constexpr int kSlab = 8;               // chunks x rows a warp step
constexpr int kMaxTile = 32 * kSlab;   // buckets a cluster, at most
constexpr int kWarps = 16;             // warps a block
constexpr int kBlock = 32 * kWarps;
constexpr int kMaxCluster = 8;         // the portable cluster size
constexpr unsigned kFull = 0xffffffffu;
constexpr int32_t kNone = 2147483647;  // no next non-empty bucket

enum Agg { kSum = 0, kMin = 1, kMax = 2, kAvg = 3, kDev = 4, kCount = 5 };

// _finish of one cell. clamp(m2, min=0) keeps a NaN, as torch.clamp does.
__device__ __forceinline__ float finish(int32_t agg, float n, float total,
                                        float m2, float mn, float mx) {
  switch (agg) {
    case kSum:
      return total;
    case kMin:
      return mn;
    case kMax:
      return mx;
    case kAvg:
      return __fdiv_rn(total, fmaxf(n, 1.0f));
    case kDev: {
      const float m = m2 < 0.0f ? 0.0f : m2;
      return __fsqrt_rn(__fdiv_rn(m, fmaxf(n, 1.0f)));
    }
    default:
      return n;
  }
}

__global__ void __launch_bounds__(kThreads)
finish_cells_kernel(const float* __restrict__ count,
                    const float* __restrict__ total,
                    const float* __restrict__ m2,
                    const float* __restrict__ mn,
                    const float* __restrict__ mx,
                    const int32_t* __restrict__ code, int64_t cells,
                    float* __restrict__ out) {
  const int64_t q = blockIdx.y;
  const int32_t agg = code[q];
  const int64_t base = q * cells;
  for (int64_t c = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       c < cells; c += (int64_t)gridDim.x * blockDim.x) {
    const int64_t i = base + c;
    float v;
    switch (agg) {
      case kSum:
        v = total[i];
        break;
      case kMin:
        v = mn[i];
        break;
      case kMax:
        v = mx[i];
        break;
      case kAvg:
        v = finish(kAvg, count[i], total[i], 0.0f, 0.0f, 0.0f);
        break;
      case kDev:
        v = finish(kDev, count[i], 0.0f, m2[i], 0.0f, 0.0f);
        break;
      default:
        v = count[i];
        break;
    }
    out[i] = v;
  }
}

// The series stage's planes: plane i's cell (q, c) is at
// p[i][q * qs[i] + c * cs[i]] (count, sum, m2, min, max).
struct Planes {
  const float* p[5];
  int64_t qs[5];
  int64_t cs[5];
};

__device__ __forceinline__ float ld(const Planes& P, int i, int64_t q,
                                    int64_t c) {
  return __ldg(P.p[i] + q * P.qs[i] + c * P.cs[i]);
}

// One chunk of a row: lane j's bucket b0 + j (cell row0 + b0 + j) through
// the series finish; returns the chunk's non-empty mask.
__device__ __forceinline__ uint32_t load_chunk(const Planes& P, int32_t ds,
                                               int64_t q, int64_t row0,
                                               int32_t b0, int32_t B,
                                               int lane, float& v) {
  const int32_t b = b0 + lane;
  bool ne = false;
  v = 0.0f;
  if (b < B) {
    const int64_t c = row0 + b;
    const float n = ld(P, 0, q, c);
    float total = 0.0f, m2 = 0.0f, mn = 0.0f, mx = 0.0f;
    if (ds == kSum || ds == kAvg) total = ld(P, 1, q, c);
    if (ds == kDev) m2 = ld(P, 2, q, c);
    if (ds == kMin) mn = ld(P, 3, q, c);
    if (ds == kMax) mx = ld(P, 4, q, c);
    v = finish(ds, n, total, m2, mn, mx);
    ne = n > 0.0f;
  }
  return __ballot_sync(kFull, ne);
}

// R series rows of slot q, s0 + r * step (rows past S are empty), over
// the tile [t0, t0 + 32 K): lane j's filled value of row r's bucket
// t0 + 32 k + j in f[r][k], its in-range and non-empty flags in bit k of
// inr[r] and ne[r]. Every row's loads are issued before any is used.
// Chunks past B are left unset.
template <int K, int R>
__device__ __forceinline__ void fill_rows(const Planes& P, int32_t ds,
                                          int64_t q, int32_t s0,
                                          int32_t step, int32_t S,
                                          int32_t B, int32_t t0, int lane,
                                          float (&f)[R][K],
                                          uint32_t (&inr)[R],
                                          uint32_t (&ne)[R]) {
  float v[R][K];
  uint32_t m[R][K];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int32_t s = s0 + r * step;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      m[r][k] = 0;
      v[r][k] = 0.0f;
      if (s < S && t0 + 32 * k < B) {
        m[r][k] = load_chunk(P, ds, q, (int64_t)s * B, t0 + 32 * k, B, lane,
                             v[r][k]);
      }
    }
  }
  const int32_t t1 = B - t0 < 32 * K ? B : t0 + 32 * K;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int32_t s = s0 + r * step;
    inr[r] = 0;
    ne[r] = 0;
    if (s >= S) continue;
    const int64_t row0 = (int64_t)s * B;
    int32_t first = kNone, last = -1;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (m[r][k]) {
        if (first == kNone) first = t0 + 32 * k + __ffs(m[r][k]) - 1;
        last = t0 + 32 * k + 31 - __clz(m[r][k]);
      }
    }
    // The nearest non-empty buckets outside the tile, searched only when
    // a bucket of the tile lies before its first or after its last one.
    int32_t pidx = -1;
    float pval = 0.0f;
    if (t0 > 0 && first > t0) {
      for (int32_t b0 = t0 - 32; b0 >= 0; b0 -= 32) {
        float x;
        const uint32_t mm = load_chunk(P, ds, q, row0, b0, B, lane, x);
        if (mm) {
          const int l = 31 - __clz(mm);
          pidx = b0 + l;
          pval = __shfl_sync(kFull, x, l);
          break;
        }
      }
    }
    int32_t nidx = kNone;
    float nval = 0.0f;
    if (t1 < B && last < t1 - 1) {
      for (int32_t b0 = t1; b0 < B; b0 += 32) {
        float x;
        const uint32_t mm = load_chunk(P, ds, q, row0, b0, B, lane, x);
        if (mm) {
          const int l = __ffs(mm) - 1;
          nidx = b0 + l;
          nval = __shfl_sync(kFull, x, l);
          break;
        }
      }
    }
    // Each chunk's first non-empty bucket after it.
    int32_t na_i[K];
    float na_v[K];
#pragma unroll
    for (int k = K - 1; k >= 0; --k) {
      na_i[k] = nidx;
      na_v[k] = nval;
      if (m[r][k]) {
        const int l = __ffs(m[r][k]) - 1;
        nidx = t0 + 32 * k + l;
        nval = __shfl_sync(kFull, v[r][k], l);
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int32_t base = t0 + 32 * k;
      if (base >= B) break;
      const int32_t b = base + lane;
      const uint32_t mk = m[r][k];
      const uint32_t below = mk & (kFull >> (31 - lane));
      const uint32_t above = mk & (kFull << lane);
      const int pl = below ? 31 - __clz(below) : 0;
      const int nl = above ? __ffs(above) - 1 : 0;
      const float y0 = __shfl_sync(kFull, v[r][k], pl);
      const float y1 = __shfl_sync(kFull, v[r][k], nl);
      const int32_t pi = below ? base + pl : pidx;
      const float pv = below ? y0 : pval;
      const int32_t ni = above ? base + nl : na_i[k];
      const float nv = above ? y1 : na_v[k];
      const bool here = (mk >> lane) & 1u;
      const bool in = b < B && pi >= 0 && ni != kNone;
      float out = 0.0f;
      if (in) {
        if (here) {
          out = v[r][k];
        } else {
          const float dx = fmaxf(__int2float_rn(ni - pi), 1.0f);
          const float frac = __fdiv_rn(__int2float_rn(b - pi), dx);
          out = __fadd_rn(pv, __fmul_rn(frac, __fsub_rn(nv, pv)));
        }
      }
      f[r][k] = out;
      inr[r] |= (uint32_t)in << k;
      ne[r] |= (uint32_t)here << k;
      if (mk) {
        const int l = 31 - __clz(mk);
        pidx = base + l;
        pval = __shfl_sync(kFull, v[r][k], l);
      }
    }
  }
}

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float take_min(float a, float b) {
  return (b < a || isnan(b)) ? b : a;
}
__device__ __forceinline__ float take_max(float a, float b) {
  return (b > a || isnan(b)) ? b : a;
}
__device__ __forceinline__ float either(float a, float b) {
  return (a != 0.0f || b != 0.0f) ? 1.0f : 0.0f;
}

enum Stat { kN = 0, kTotal = 1, kMn = 2, kMx = 3, kAny = 4, kM2 = 5 };

__device__ __forceinline__ float combine(int stat, float a, float b) {
  switch (stat) {
    case kMn:
      return take_min(a, b);
    case kMx:
      return take_max(a, b);
    case kAny:
      return either(a, b);
    default:
      return add(a, b);
  }
}

// The block's partials of NS statistics, stat0 + i for row i of x, over
// a tile of 32 K buckets in one round: each warp's rows into red, then
// thread j combines row j / (32 K) at bucket j % (32 K) over the warps,
// in warp order, into part.
template <int K, int NS>
__device__ __forceinline__ void block_combine(const float (&x)[NS][K],
                                              int stat0, float* red,
                                              float (*part)[kMaxTile],
                                              int warp, int lane) {
#pragma unroll
  for (int i = 0; i < NS; ++i) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      red[(i * kWarps + warp) * 32 * K + 32 * k + lane] = x[i][k];
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < NS * 32 * K; j += kBlock) {
    const int i = j / (32 * K), t = j % (32 * K);
    const float* row = red + i * kWarps * 32 * K + t;
    float acc = row[0];
    for (int w = 1; w < kWarps; ++w) {
      acc = combine(stat0 + i, acc, row[w * 32 * K]);
    }
    part[stat0 + i][t] = acc;
  }
  __syncthreads();
}

// The block combine's buffer: kWarps rows of each statistic a round
// combines (five in a moment shard's first pass).
__host__ __device__ constexpr int red_bytes(int K, bool fill) {
  return (fill ? 1 : 5) * kWarps * 32 * K * 4;
}

// Grid: x = P blocks a cluster x the tiles of B (32 K buckets each), y =
// the slots; a warp takes R rows a step. kFill: filled and in_range
// [Q, S, B] and gm; else values and gm [Q, B].
template <int K, int R, bool kFill>
__global__ void __launch_bounds__(kBlock, 1)
dash_finish_kernel(Planes P, const int32_t* __restrict__ codes, int32_t Q,
                   int32_t S, int32_t B, float* __restrict__ out,
                   uint8_t* __restrict__ in_range, uint8_t* __restrict__ gm) {
  extern __shared__ float red[];
  __shared__ float part[6][kMaxTile];
  __shared__ float mean[kMaxTile];
  const cg::cluster_group cluster = cg::this_cluster();
  const int nblk = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int64_t q = blockIdx.y;
  const int32_t t0 = (int32_t)(blockIdx.x / nblk) * 32 * K;
  const int32_t width = B - t0 < 32 * K ? B - t0 : 32 * K;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int32_t ds = codes[q];
  const int32_t agg = kFill ? kSum : codes[Q + q];
  const int32_t first_row = rank * kWarps + warp;
  const int32_t row_step = nblk * kWarps;

  float n[K], total[K], mn[K], mx[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    n[k] = 0.0f;
    total[k] = 0.0f;
    mn[k] = __int_as_float(0x7f800000);    // +inf
    mx[k] = __int_as_float(0xff800000);    // -inf
  }
  uint32_t any = 0;
  for (int32_t s0 = first_row; s0 < S; s0 += R * row_step) {
    float f[R][K];
    uint32_t inr[R], ne[R];
    fill_rows<K, R>(P, ds, q, s0, row_step, S, B, t0, lane, f, inr, ne);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int32_t s = s0 + r * row_step;
      any |= ne[r];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (t0 + 32 * k >= B) break;
        const bool in = (inr[r] >> k) & 1u;
        if (kFill) {
          const int32_t b = t0 + 32 * k + lane;
          if (s < S && b < B) {
            const int64_t o = ((int64_t)q * S + s) * B + b;
            out[o] = f[r][k];
            in_range[o] = in ? 1 : 0;
          }
        } else if (in) {
          n[k] = __fadd_rn(n[k], 1.0f);
          total[k] = __fadd_rn(total[k], f[r][k]);
          mn[k] = take_min(mn[k], f[r][k]);
          mx[k] = take_max(mx[k], f[r][k]);
        }
      }
    }
  }
  if (kFill) {
    float a[1][K];
#pragma unroll
    for (int k = 0; k < K; ++k) a[0][k] = (any >> k) & 1u ? 1.0f : 0.0f;
    block_combine<K, 1>(a, kAny, red, part, warp, lane);
  } else {
    // Rows in Stat order: n, total, min, max, any.
    float a[5][K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      a[kN][k] = n[k];
      a[kTotal][k] = total[k];
      a[kMn][k] = mn[k];
      a[kMx][k] = mx[k];
      a[kAny][k] = (any >> k) & 1u ? 1.0f : 0.0f;
    }
    block_combine<K, 5>(a, kN, red, part, warp, lane);
  }
  cluster.sync();
  if (!kFill && agg == kDev) {
    // The group mean from every block's sums, in rank order (all the
    // remote loads issued before the first add).
    for (int t = threadIdx.x; t < width; t += kBlock) {
      float rn[kMaxCluster], rt[kMaxCluster];
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        if (r < nblk) {
          const float* rp = cluster.map_shared_rank(&part[0][0], r);
          rn[r] = rp[kN * kMaxTile + t];
          rt[r] = rp[kTotal * kMaxTile + t];
        }
      }
      float gn = rn[0], gt = rt[0];
#pragma unroll
      for (int r = 1; r < kMaxCluster; ++r) {
        if (r < nblk) {
          gn = __fadd_rn(gn, rn[r]);
          gt = __fadd_rn(gt, rt[r]);
        }
      }
      mean[t] = __fdiv_rn(gt, fmaxf(gn, 1.0f));
    }
    __syncthreads();
    float m2[K];
#pragma unroll
    for (int k = 0; k < K; ++k) m2[k] = 0.0f;
    for (int32_t s0 = first_row; s0 < S; s0 += R * row_step) {
      float f[R][K];
      uint32_t inr[R], ne[R];
      fill_rows<K, R>(P, ds, q, s0, row_step, S, B, t0, lane, f, inr, ne);
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (t0 + 32 * k >= B) break;
          if ((inr[r] >> k) & 1u) {
            const float d = __fsub_rn(f[r][k], mean[32 * k + lane]);
            m2[k] = __fadd_rn(m2[k], __fmul_rn(d, d));
          }
        }
      }
    }
    float m2x[1][K];
#pragma unroll
    for (int k = 0; k < K; ++k) m2x[0][k] = m2[k];
    block_combine<K, 1>(m2x, kM2, red, part, warp, lane);
    cluster.sync();
  }
  if (rank == 0) {
    // The blocks' partials in rank order, every remote load issued first.
    constexpr int kRead = kFill ? 1 : 6;
    for (int t = threadIdx.x; t < width; t += kBlock) {
      float x[kMaxCluster][kRead];
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        if (r < nblk) {
          const float* rp = cluster.map_shared_rank(&part[0][0], r);
#pragma unroll
          for (int i = 0; i < kRead; ++i) {
            x[r][i] = rp[(kFill ? kAny : i) * kMaxTile + t];
          }
        }
      }
      float g[kRead];
#pragma unroll
      for (int i = 0; i < kRead; ++i) g[i] = x[0][i];
#pragma unroll
      for (int r = 1; r < kMaxCluster; ++r) {
        if (r < nblk) {
#pragma unroll
          for (int i = 0; i < kRead; ++i) {
            g[i] = combine(kFill ? kAny : i, g[i], x[r][i]);
          }
        }
      }
      const int64_t o = (int64_t)q * B + t0 + t;
      gm[o] = g[kFill ? 0 : kAny] != 0.0f ? 1 : 0;
      if (!kFill) {
        out[o] = finish(agg, g[kN], g[kTotal], g[kM2], g[kMn], g[kMx]);
      }
    }
  }
  // No block leaves while rank 0 may still read its shared memory.
  cluster.sync();
}

template <int K, int R>
cudaError_t launch_dash(cudaLaunchConfig_t* cfg, int32_t fill,
                        const Planes& P, const int32_t* codes, int32_t Q,
                        int32_t S, int32_t B, float* out, uint8_t* in_range,
                        uint8_t* gm) {
  const int32_t nblk = (int32_t)cfg->gridDim.x;
  cfg->gridDim.x = (unsigned)(nblk * ((B + 32 * K - 1) / (32 * K)));
  const auto kernel = fill ? dash_finish_kernel<K, R, true>
                           : dash_finish_kernel<K, R, false>;
  cfg->dynamicSmemBytes = (size_t)red_bytes(K, fill != 0);
  if (cfg->dynamicSmemBytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)cfg->dynamicSmemBytes);
    if (err != cudaSuccess) return err;
  }
  return cudaLaunchKernelEx(cfg, kernel, P, codes, Q, S, B, out, in_range,
                            gm);
}

}  // namespace

// Planes [Q, cells] row-major float32 (a plane no slot's code reads may
// be null), code [Q] int32 in [0, 6), out [Q, cells] float32. Q <=
// 65,535. Returns the CUDA error of the launch (0 = cudaSuccess), or
// cudaErrorInvalidValue past 65,535 slots.
extern "C" int finish_cells_f32(const float* count, const float* total,
                                const float* m2, const float* mn,
                                const float* mx, const int32_t* code,
                                int32_t Q, int64_t cells, float* out,
                                void* stream) {
  if (Q > 65535 || Q < 0) return (int)cudaErrorInvalidValue;
  if (Q > 0 && cells > 0) {
    int64_t bx = (cells + kThreads - 1) / kThreads;
    if (bx > 4096) bx = 4096;
    dim3 grid((unsigned)bx, (unsigned)Q);
    finish_cells_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        count, total, m2, mn, mx, code, cells, out);
  }
  return (int)cudaGetLastError();
}

// planes[5] (count, sum, m2, min, max; count always, the others where a
// slot's downsampler reads them, else null) and strides[10] (each
// plane's slot stride, then each plane's cell stride, in elements) on
// the host, describing [Q, S * B] views; codes [2, Q] int32 on the card
// (the downsamplers, then the group aggregators, in DASH_AGGS order).
// fill = 0: out [Q, B] float32 values and gm [Q, B] uint8; fill = 1:
// out [Q, S, B] float32 filled, in_range [Q, S, B] uint8 and gm. Q <=
// 65,535, S, B >= 1, S * B < 2^31. Returns the CUDA error of the launch,
// or cudaErrorInvalidValue past those limits.
extern "C" int dash_finish_f32(const float* const* planes,
                               const int64_t* strides,
                               const int32_t* codes, int32_t Q, int32_t S,
                               int32_t B, int32_t fill, float* out,
                               uint8_t* in_range, uint8_t* gm,
                               void* stream) {
  if (Q < 0 || Q > 65535 || S < 1 || B < 1 ||
      (int64_t)S * B >= 2147483648LL || planes[0] == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  if (Q == 0) return (int)cudaSuccess;
  Planes P;
  for (int i = 0; i < 5; ++i) {
    P.p[i] = planes[i];
    P.qs[i] = strides[i];
    P.cs[i] = strides[5 + i];
  }
  int32_t nblk = (S + kWarps - 1) / kWarps;
  if (nblk > kMaxCluster) nblk = kMaxCluster;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)nblk;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3{(unsigned)nblk, (unsigned)Q, 1};
  cfg.blockDim = dim3{(unsigned)kBlock, 1, 1};
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // A tile of 32 K buckets, R = 8 / K rows a warp step: a narrow grid
  // issues several rows' loads at once, a wide one a row's chunks.
  cudaError_t err;
  if (B <= 32) {
    err = launch_dash<1, 8>(&cfg, fill, P, codes, Q, S, B, out, in_range, gm);
  } else if (B <= 64) {
    err = launch_dash<2, 4>(&cfg, fill, P, codes, Q, S, B, out, in_range, gm);
  } else if (B <= 128) {
    err = launch_dash<4, 2>(&cfg, fill, P, codes, Q, S, B, out, in_range, gm);
  } else {
    err = launch_dash<8, 1>(&cfg, fill, P, codes, Q, S, B, out, in_range, gm);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
