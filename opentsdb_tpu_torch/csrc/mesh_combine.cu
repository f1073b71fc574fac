// Cross-shard combines of the mesh execution plane (parallel/compile.py):
// the steps where the JAX package's mesh bodies meet across chips.
//
// Replaces no Pallas kernel: the JAX package does these steps with XLA
// collectives inside shard_map bodies. In the port the shards of a mesh
// run in one process, one after another, and their partials meet on the
// mesh's first device; each step below is one fused pass where the plain
// tensor composite is 10-15 small launches.
//
// moment_combine_f32 -- the psum / pmin / pmax fan-in of
// opentsdb_tpu/parallel/sharded.py _sharded_group_body (:114-141) and
// _sharded_multigroup_body (:234-278), with the body's _finish:
//   per cell c of C, over the D shards' partials [D, C] (count n, sum,
//   centered m2, min, max as float32; an int32 any-real flag):
//     g_n = sum_d n_d, g_total = sum_d total_d (shard order),
//     g_mean = g_total / max(g_n, 1),
//     g_m2 = sum_d (m2_d + n_d * (mean_d - g_mean)^2), mean_d =
//       total_d / max(n_d, 1) (Chan et al.'s pairwise update),
//     g_min / g_max over the shards (NaN propagates; a strict compare in
//       shard order decides ties, so -0.0 vs +0.0 follows the order),
//     mask = any_d != 0 for some d,
//   then _finish(agg) writes the group value. Only the planes the
//   aggregator reads are read, and the others may be null: n for avg,
//   dev and count; total for sum, avg and dev; m2 for dev; min or max.
//   One thread a cell; the loop over D reads each plane's [D, C] rows at
//   stride C, so a warp's loads are 32 neighbouring words.
//   Bound: bytes. Each plane the aggregator reads, and any, is read once
//   (4 D C bytes each; the m2 leg reads n and total a second time, from
//   L2), the value and mask written once (5 C bytes); at the {host=*}
//   week, C = 16,384 x 256 and D = 4, a sum reads total and any, 134 MB,
//   and writes 21 MB (~46 us at 3.35 TB/s).
//
// tile_carries_i32f32 -- the carry selection of
// opentsdb_tpu/parallel/timeshard.py _cross_tile_edges (:79-122) and of
// _timeshard_rate_body (:253-324), after the all_gather of the per-tile
// summaries [D, S, 4] int32 (float values ride as their bits):
//   mode 0, edges: row (last idx, last value, first idx, first value);
//     for tile d and series s, the nearest nonempty bucket on an earlier
//     tile (the largest last idx of tiles d' < d; -1 = none) and on a
//     later tile (the smallest first idx of tiles d' > d; 2^31-1 = none),
//     with their values: planes (left_idx, left_val, right_idx,
//     right_val);
//   mode 1, rate: row (has, last ts, last value, unused); the nearest
//     earlier tile holding the series: planes (has_carry, carry_ts,
//     carry_val, 0).
//   Selections are argmax / argmin with the first extreme winning (the
//   JAX argmax), so with no candidate the value of tile 0 is taken, as
//   there. It only selects, so it equals its plain version bit for bit.
//   One thread a (tile, series); output [4, D, S] int32.
//   Bound: bytes, 16 D S in and 16 D S out.
//
// hybrid_moment_combine_f32 -- the two-level merge of
// opentsdb_tpu/parallel/multihost.py _hybrid_group_body (:97-128) on the
// hybrid (host, series) mesh, over [H, C, cells] partials (count n, sum,
// centered m2, mean, min, max as float32; an int32 any-real flag):
//   level 1, per host row h over its C chips in chip order (JAX's chan
//     over the series axis with the shipped chip means):
//       h_n = sum_c n, h_total = sum_c total,
//       h_mean = h_total / max(h_n, 1),
//       h_m2 = sum_c (m2 + n * (mean - h_mean)^2),
//       h_min / h_max over the chips (NaN propagates, a strict compare
//       in chip order decides ties), h_any = any chip's flag;
//   level 2, the same over the H rows in row order with each row's
//     h_mean, then _finish(agg) and the mask.
//   A level over one member (C == 1 or H == 1) takes that member's
//   partials as they are: a sum of one term is the term, and its centred
//   term is n * 0 wherever the mean is finite, as in the JAX body.
//   emit = 1 stops after level 1 and writes each row's partials [H, cells]
//   (n, total, m2, mean, min, max, any): what a process ships across the
//   mesh plane. A finish over the gathered rows, [H, 1, cells], then
//   gives the bits of the finish over [H, C, cells] in one launch, since
//   its level 1 is the identity.
//   Only the planes the aggregator reads are read and emitted (the others
//   may be null): n for avg, dev and count; total for sum, avg and dev;
//   m2 and mean for dev; min or max.
//   Design. A block takes cb <= 32 cells: its threads load every
//   member's needed planes for those cells once, consecutive threads on
//   consecutive cells, into shared memory; then one thread a (row, cell)
//   folds level 1 from there in chip order (dev's centred pass reads the
//   shared copy again) and writes the row's partials to shared memory;
//   then one thread a cell folds level 2 in row order and finishes, the
//   plain version's operations in its order. cb halves until
//   the staged members fit 48 KB (one cell of all members must fit the
//   block's opt-in shared memory, else the launch is refused). The
//   week's 256 cells make 8 blocks. No array is indexed at run time
//   outside shared memory: ptxas reports a 0-byte stack frame (registers
//   in PERF.md's kernel table, from nvcc -Xptxas -v).
//   Bound: bytes. Each plane the aggregator reads, and any, is read once
//   (4 H C cells bytes each), the value and mask written once (5 cells
//   bytes), or the emitted planes (4 H cells bytes each). At the week
//   (2 x 2 x 256, dev: 5 planes) that is 21.8 KB, far under the launch
//   floor, which bounds the kernel: a cell's load, two barriers and two
//   folds are one chain under the launch (about 2.5 floors on the H100).
//
// Rounding: every operation is an _rn intrinsic, so nvcc never contracts
// a multiply and an add into an FMA and the division and square root are
// the correctly rounded ones; the plain versions (ops/mesh_combine.py)
// round each operation the same way, so the two agree bit for bit.
// Never build this file with --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int32_t kBig = 2147483647;

enum Agg { kSum = 0, kMin = 1, kMax = 2, kAvg = 3, kDev = 4, kCount = 5 };

__global__ void __launch_bounds__(kThreads)
moment_combine_kernel(const float* __restrict__ n,
                      const float* __restrict__ total,
                      const float* __restrict__ m2,
                      const float* __restrict__ mn,
                      const float* __restrict__ mx,
                      const int32_t* __restrict__ any, int32_t D,
                      int64_t C, int32_t agg, float* __restrict__ out,
                      uint8_t* __restrict__ mask) {
  for (int64_t c = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; c < C;
       c += (int64_t)gridDim.x * blockDim.x) {
    bool g_any = any[c] != 0;
    for (int32_t d = 1; d < D; ++d) g_any |= any[d * C + c] != 0;
    // Only avg, dev and count read the counts: sum, min and max take
    // their value from total, min or max and their mask from any.
    float g_n = 0.0f;
    if (agg == kAvg || agg == kDev || agg == kCount) {
      g_n = n[c];
      for (int32_t d = 1; d < D; ++d) g_n = __fadd_rn(g_n, n[d * C + c]);
    }
    const float safe = fmaxf(g_n, 1.0f);
    float v = g_n;
    if (agg == kSum || agg == kAvg || agg == kDev) {
      float g_t = total[c];
      for (int32_t d = 1; d < D; ++d) g_t = __fadd_rn(g_t, total[d * C + c]);
      v = agg == kAvg ? __fdiv_rn(g_t, safe) : g_t;
      if (agg == kDev) {
        const float g_mean = __fdiv_rn(g_t, safe);
        float acc = 0.0f;
        for (int32_t d = 0; d < D; ++d) {
          const float nd = n[d * C + c];
          const float mean_d = __fdiv_rn(total[d * C + c], fmaxf(nd, 1.0f));
          const float dd = __fsub_rn(mean_d, g_mean);
          const float term =
              __fadd_rn(m2[d * C + c], __fmul_rn(nd, __fmul_rn(dd, dd)));
          acc = d == 0 ? term : __fadd_rn(acc, term);
        }
        // clamp(m2, min=0) keeps a NaN, as torch.clamp does.
        const float m = acc < 0.0f ? 0.0f : acc;
        v = __fsqrt_rn(__fdiv_rn(m, safe));
      }
    } else if (agg == kMin) {
      v = mn[c];
      for (int32_t d = 1; d < D; ++d) {
        const float x = mn[d * C + c];
        if (x < v || isnan(x)) v = x;
      }
    } else if (agg == kMax) {
      v = mx[c];
      for (int32_t d = 1; d < D; ++d) {
        const float x = mx[d * C + c];
        if (x > v || isnan(x)) v = x;
      }
    }
    out[c] = v;
    mask[c] = g_any ? 1 : 0;
  }
}

__global__ void __launch_bounds__(kThreads)
tile_carries_kernel(const int4* __restrict__ rows, int32_t D, int64_t S,
                    int32_t mode, int32_t* __restrict__ out) {
  const int64_t cells = (int64_t)D * S;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       i < cells; i += (int64_t)gridDim.x * blockDim.x) {
    const int32_t d = (int32_t)(i / S);
    const int64_t s = i - (int64_t)d * S;
    int32_t o0, o1, o2, o3;
    if (mode == 0) {
      // Left: argmax over d' of (d' < d and last >= 0 ? last : -1).
      int32_t lbest = 0, lsel = 0, rbest = 0, rsel = 0;
      for (int32_t e = 0; e < D; ++e) {
        const int4 r = rows[(int64_t)e * S + s];
        const int32_t lc = (e < d && r.x >= 0) ? r.x : -1;
        const int32_t rc = (e > d && r.z < kBig) ? r.z : kBig;
        if (e == 0 || lc > lbest) { lbest = lc; lsel = e; }
        if (e == 0 || rc < rbest) { rbest = rc; rsel = e; }
      }
      o0 = lbest;
      o1 = rows[(int64_t)lsel * S + s].y;
      o2 = rbest;
      o3 = rows[(int64_t)rsel * S + s].w;
    } else {
      int32_t best = 0, sel = 0;
      for (int32_t e = 0; e < D; ++e) {
        const int4 r = rows[(int64_t)e * S + s];
        const int32_t c = (e < d && r.x > 0) ? e : -1;
        if (e == 0 || c > best) { best = c; sel = e; }
      }
      const int4 r = rows[(int64_t)sel * S + s];
      o0 = best >= 0 ? 1 : 0;
      o1 = r.y;
      o2 = r.z;
      o3 = 0;
    }
    out[i] = o0;
    out[cells + i] = o1;
    out[2 * cells + i] = o2;
    out[3 * cells + i] = o3;
  }
}

struct Partial {
  float n, total, m2, mean, mn, mx;
  bool any;
};

// The hybrid combine's shared memory: the staged members' planes,
// slot j of HybridPlanes::slot at stage[(j * members + m) * cb + cell],
// then the level-1 rows, field f (n, total, m2, mean, min, max, any) at
// rows[(f * H + h) * cb + cell].
constexpr int kHybridThreads = 256;
constexpr int kHybridCells = 32;      // cells a block, at most
constexpr int kFields = 7;
constexpr int kMaxHosts = 16;

struct HybridPlanes {
  const float* p[6];      // n, total, m2, mean, min, max (null: absent)
  const int32_t* any;
  int32_t slot[6];        // staged slot of each plane, -1 when absent
  int32_t nslots;         // staged slots, any included (the last)
};

__device__ __forceinline__ Partial staged(const HybridPlanes& in,
                                          const float* stage,
                                          int32_t members, int32_t cb,
                                          int32_t m, int32_t cell) {
  auto at = [&](int i) {
    const int32_t j = in.slot[i];
    return j < 0 ? 0.0f : stage[((int64_t)j * members + m) * cb + cell];
  };
  Partial p;
  p.n = at(0);
  p.total = at(1);
  p.m2 = at(2);
  p.mean = at(3);
  p.mn = at(4);
  p.mx = at(5);
  p.any = stage[((int64_t)(in.nslots - 1) * members + m) * cb + cell] != 0.0f;
  return p;
}

__device__ __forceinline__ Partial row_at(const float* rows, int32_t H,
                                          int32_t cb, int32_t h,
                                          int32_t cell) {
  auto at = [&](int f) { return rows[((int64_t)f * H + h) * cb + cell]; };
  Partial p;
  p.n = at(0);
  p.total = at(1);
  p.m2 = at(2);
  p.mean = at(3);
  p.mn = at(4);
  p.mx = at(5);
  p.any = at(6) != 0.0f;
  return p;
}

// One chan level over k members: get(i) is member i's partials, read
// from shared memory (twice for dev: the sums, then the centred pass).
template <typename Get>
__device__ __forceinline__ Partial chan_level(Get get, int32_t k,
                                              bool dev) {
  Partial acc = get(0);
  if (k == 1) return acc;
  for (int32_t i = 1; i < k; ++i) {
    const Partial p = get(i);
    acc.n = __fadd_rn(acc.n, p.n);
    acc.total = __fadd_rn(acc.total, p.total);
    if (p.mn < acc.mn || isnan(p.mn)) acc.mn = p.mn;
    if (p.mx > acc.mx || isnan(p.mx)) acc.mx = p.mx;
    acc.any = acc.any || p.any;
  }
  acc.mean = __fdiv_rn(acc.total, fmaxf(acc.n, 1.0f));
  if (dev) {
    float m2acc = 0.0f;
    for (int32_t i = 0; i < k; ++i) {
      const Partial p = get(i);
      const float d = __fsub_rn(p.mean, acc.mean);
      const float term = __fadd_rn(p.m2, __fmul_rn(p.n, __fmul_rn(d, d)));
      m2acc = i == 0 ? term : __fadd_rn(m2acc, term);
    }
    acc.m2 = m2acc;
  }
  return acc;
}

// A block stages cb cells of all H * C members, then folds level 1 a
// (row, cell) a thread and level 2 a cell a thread.
__global__ void __launch_bounds__(kHybridThreads)
hybrid_combine_kernel(HybridPlanes in, int32_t H, int32_t C, int64_t cells,
                      int32_t cb, int32_t agg, int32_t emit,
                      float* __restrict__ out, uint8_t* __restrict__ mask,
                      float* __restrict__ e_n, float* __restrict__ e_total,
                      float* __restrict__ e_m2, float* __restrict__ e_mean,
                      float* __restrict__ e_mn, float* __restrict__ e_mx,
                      int32_t* __restrict__ e_any) {
  extern __shared__ float smem[];
  const int32_t members = H * C;
  float* stage = smem;
  float* rows = smem + (int64_t)in.nslots * members * cb;
  const int64_t c0 = (int64_t)blockIdx.x * cb;
  const bool dev = agg == kDev;
  // Stage: consecutive threads take consecutive cells of one member.
  const int64_t staged_n = (int64_t)in.nslots * members * cb;
  for (int64_t i = threadIdx.x; i < staged_n; i += blockDim.x) {
    const int32_t cell = (int32_t)(i % cb);
    const int64_t jm = i / cb;
    const int32_t m = (int32_t)(jm % members);
    const int32_t j = (int32_t)(jm / members);
    const int64_t c = c0 + cell;
    float x = 0.0f;
    if (c < cells) {
      const int64_t o = (int64_t)m * cells + c;
      if (j == in.nslots - 1) {
        x = __ldg(in.any + o) != 0 ? 1.0f : 0.0f;
      } else {
#pragma unroll
        for (int f = 0; f < 6; ++f) {
          if (in.slot[f] == j) x = __ldg(in.p[f] + o);
        }
      }
    }
    stage[i] = x;
  }
  __syncthreads();
  // Level 1: row h over its C chips, in chip order.
  for (int32_t i = threadIdx.x; i < H * cb; i += blockDim.x) {
    const int32_t h = i / cb, cell = i % cb;
    const Partial r = chan_level(
        [&](int32_t k) {
          return staged(in, stage, members, cb, h * C + k, cell);
        },
        C, dev);
    const float f[kFields] = {r.n, r.total, r.m2, r.mean, r.mn, r.mx,
                              r.any ? 1.0f : 0.0f};
#pragma unroll
    for (int k = 0; k < kFields; ++k) {
      rows[((int64_t)k * H + h) * cb + cell] = f[k];
    }
    const int64_t c = c0 + cell;
    if (emit && c < cells) {
      const int64_t o = (int64_t)h * cells + c;
      if (e_n != nullptr) e_n[o] = r.n;
      if (e_total != nullptr) e_total[o] = r.total;
      if (e_m2 != nullptr) e_m2[o] = r.m2;
      if (e_mean != nullptr) e_mean[o] = r.mean;
      if (e_mn != nullptr) e_mn[o] = r.mn;
      if (e_mx != nullptr) e_mx[o] = r.mx;
      e_any[o] = r.any ? 1 : 0;
    }
  }
  if (emit) return;
  __syncthreads();
  // Level 2: the H rows, in row order, then the finish.
  for (int32_t cell = threadIdx.x; cell < cb; cell += blockDim.x) {
    const int64_t c = c0 + cell;
    if (c >= cells) continue;
    const Partial g = chan_level(
        [&](int32_t h) { return row_at(rows, H, cb, h, cell); }, H, dev);
    const float safe = fmaxf(g.n, 1.0f);
    float v = g.n;
    if (agg == kSum) {
      v = g.total;
    } else if (agg == kAvg) {
      v = __fdiv_rn(g.total, safe);
    } else if (agg == kDev) {
      // clamp(m2, min=0) keeps a NaN, as torch.clamp does.
      const float m = g.m2 < 0.0f ? 0.0f : g.m2;
      v = __fsqrt_rn(__fdiv_rn(m, safe));
    } else if (agg == kMin) {
      v = g.mn;
    } else if (agg == kMax) {
      v = g.mx;
    }
    out[c] = v;
    mask[c] = g.any ? 1 : 0;
  }
}

int blocks_for(int64_t cells) {
  int64_t b = (cells + kThreads - 1) / kThreads;
  if (b > 65535 * 8) b = 65535 * 8;
  return (int)(b < 1 ? 1 : b);
}

}  // namespace

// Planes are [D, C] row-major (shard-major); n, total, m2, mn and mx may
// be null when agg does not read them (see the kernel's comment). out [C] float32, mask [C] uint8 (0 / 1). Returns the CUDA error
// of the launch (0 = cudaSuccess).
extern "C" int moment_combine_f32(const float* n, const float* total,
                                  const float* m2, const float* mn,
                                  const float* mx, const int32_t* any,
                                  int32_t D, int64_t C, int32_t agg,
                                  float* out, uint8_t* mask, void* stream) {
  if (C > 0 && D > 0) {
    moment_combine_kernel<<<blocks_for(C), kThreads, 0,
                            (cudaStream_t)stream>>>(n, total, m2, mn, mx,
                                                    any, D, C, agg, out,
                                                    mask);
  }
  return (int)cudaGetLastError();
}

// rows [D, S, 4] int32 (16-byte aligned), out [4, D, S] int32.
extern "C" int tile_carries_i32f32(const int32_t* rows, int32_t D, int64_t S,
                                   int32_t mode, int32_t* out,
                                   void* stream) {
  if (S > 0 && D > 0) {
    tile_carries_kernel<<<blocks_for((int64_t)D * S), kThreads, 0,
                          (cudaStream_t)stream>>>(
        reinterpret_cast<const int4*>(rows), D, S, mode, out);
  }
  return (int)cudaGetLastError();
}

// Partials [H, C, cells] row-major; a plane agg does not read may be null
// (see the kernel's comment), and H <= 16. emit = 0: out [cells] float32
// and mask [cells] uint8. emit = 1: the row partials [H, cells] into the
// e_* planes (those agg reads, and e_any). Returns the CUDA error of the
// launch, or cudaErrorInvalidValue past 16 rows or when one cell of all
// H * C members does not fit a block's shared memory.
extern "C" int hybrid_moment_combine_f32(
    const float* n, const float* total, const float* m2, const float* mean,
    const float* mn, const float* mx, const int32_t* any, int32_t H,
    int32_t C, int64_t cells, int32_t agg, int32_t emit, float* out,
    uint8_t* mask, float* e_n, float* e_total, float* e_m2, float* e_mean,
    float* e_mn, float* e_mx, int32_t* e_any, void* stream) {
  if (H > kMaxHosts || H < 0 || C < 0) return (int)cudaErrorInvalidValue;
  if (cells <= 0 || H == 0 || C == 0) return (int)cudaGetLastError();
  HybridPlanes in;
  const float* planes[6] = {n, total, m2, mean, mn, mx};
  in.nslots = 0;
  for (int f = 0; f < 6; ++f) {
    in.p[f] = planes[f];
    in.slot[f] = planes[f] != nullptr ? in.nslots++ : -1;
  }
  in.any = any;
  ++in.nslots;
  const int64_t per_cell =
      4 * ((int64_t)in.nslots * H * C + (int64_t)kFields * H);
  int64_t cb = kHybridCells;
  while (cb > 1 && cb * per_cell > 48 * 1024) cb /= 2;
  if (cb > cells) cb = cells;
  const int64_t smem = cb * per_cell;
  if (smem > 48 * 1024) {
    int dev = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    if (smem > optin) return (int)cudaErrorInvalidValue;
    const cudaError_t err = cudaFuncSetAttribute(
        hybrid_combine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t blocks = (cells + cb - 1) / cb;
  hybrid_combine_kernel<<<(unsigned)blocks, kHybridThreads, (size_t)smem,
                          (cudaStream_t)stream>>>(
      in, H, C, cells, (int32_t)cb, agg, emit, out, mask, e_n, e_total, e_m2,
      e_mean, e_mn, e_mx, e_any);
  return (int)cudaGetLastError();
}
