// Masked rank selection: per-column quantiles across rows, hand-written for
// Hopper (sm_90a). Built by opentsdb_tpu_torch/ops/cuda_build.py with nvcc
// into a shared library with a plain C interface, loaded through ctypes;
// the wrapper lives in opentsdb_tpu_torch/ops/masked_select.py.
//
// What it replaces. Two jitted XLA functions of opentsdb_tpu/ops/kernels.py:
// - masked_quantile_axis0 (:818), a 32-pass MSB-first radix select: each
//   pass a masked count over all of [S, B], one bit of every column's
//   rank-k key per pass. Entry point masked_select_columns.
// - masked_quantile_groups (:878), a two-key sort of [S, B] along the rows
//   by (group, order key), then two gathers at each group's ranks. Entry
//   point masked_select_groups: the rows of group g are
//   order[offsets[g] .. offsets[g + 1]), a layout built once per group map.
// Both compute, for each column and quantile q, over the n valid entries:
// pos = (n - 1) * q in float32, the values of rank floor(pos) and ceil(pos)
// in ascending order (the IEEE total order of _order_key, so -0.0 < +0.0),
// and vlo + (pos - floor(pos)) * (vhi - vlo), written with __fadd_rn /
// __fmul_rn / __fsub_rn so that nvcc does not contract it into an FMA the
// CPU reference lacks. A column with no valid entry gives 0. Outputs are
// [K, G, B] (G = 1 for the columns entry).
//
// What bounds it: bytes. The least work reads every value (4 bytes) and
// mask byte once and writes the [K, G, B] outputs; the arithmetic per entry
// is a few integer compares. At the resident window's shape (S = 16384,
// B = 256) that is 21 MB, ~6 us at 3.35 TB/s.
//
// Design.
// - Large groups (more than kSmall rows): an MSB-first radix select on
//   8-bit digits, 4 histogram passes instead of 32 bit passes. A block owns
//   a tile of 32 adjacent columns of one group, or its share of the
//   group's rows when the rows are split over a thread-block cluster
//   (Hopper's distributed shared memory, DSMEM): lane l of every warp
//   handles column l, so each row read is one coalesced 128-byte line.
// - Rows read once. Each block first stages its share as order keys in
//   shared memory (a masked entry becomes 0xFFFFFFFF and never counts), 128
//   bytes a row; the digit passes then read shared memory, not L2. The
//   cluster widens until an average group's share fits, unless that costs
//   a wave the launch does not already take (cudaOccupancyMaxActiveClusters:
//   an H100 runs 7 clusters of 16 at once, so the window's 8 column tiles
//   take clusters of 8, whose 2,048-row shares count from L2 in each
//   pass), and beyond that only while each block keeps kMinRows rows and
//   the clusters still run in one wave. A block whose share does not fit
//   counts from device memory in every pass. Either way a thread issues
//   all kUnroll rows' loads (value, mask byte, row index) before it uses
//   any, through asm loads the compiler cannot sink into the mask test.
// - One selection per quantile: the floor rank's key. The ceil rank's key
//   is the floor key when the keys <= it outnumber the ceil rank, else the
//   least valid key above it (as the JAX reference takes it, kernels.py
//   :862-869): the last pass's histogram holds it when a later bin of the
//   same 24-bit prefix is not empty, and otherwise the last pass also
//   keeps, per column, the least key past the prefix.
// - The first pass needs no prefix, so one histogram serves every quantile,
//   and its total is the column's valid count: no count pass.
// - Histograms: [quantile][256 bins][33] counters, the 33rd word padding so
//   that lanes on different columns fall on different banks. Counters are
//   16 bits, two bins to a word, unless a block could count more than
//   65,535 rows; three quantiles' histograms then take 50 KB beside the
//   staged keys. In the first pass each thread adds runs of equal digits
//   in registers before one shared-memory atomic (the top digits of one
//   column barely vary); the counting loops are compiled for each number
//   of quantiles, so a key costs a compare and an atomic per quantile.
// - The scan: one warp per (quantile, column) of the cluster sums the
//   cluster's histograms through DSMEM in one round of loads (each lane 8
//   bins), finds the digit that holds the remaining rank with a warp scan,
//   and writes the new prefix into every block of the cluster: two
//   cluster barriers per pass. The last pass writes the output.
// - Small groups (at most kSmall rows: a {host=*} group-by holds thousands
//   of one-series groups) must not pay a histogram pass each: one warp per
//   (group, tile) loads the group's keys into registers and selects each
//   rank directly, the key with (keys below it) <= rank < (keys at or below
//   it), in fully unrolled loops of a size class (1, 4, 8, 16 or 32 rows)
//   that the whole warp shares, so that a one-row group costs a handful of
//   instructions. The kernel is held to 64 registers, so that an SM keeps
//   32 of its warps in flight; the 32-row class spills (groups of 17 to
//   32 rows are rare beside one-series ones).
// The selected keys are exact rank statistics, so the result matches a
// sort bit for bit before the lerp. (The one NaN whose key would be
// 0xFFFFFFFF takes the key below it: still a NaN, above every number.)

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 32;        // columns per block or warp
constexpr int kSmall = 32;       // rows of a group selected in registers
                                 // (SMALL_ROWS in ops/masked_select.py)
constexpr int kMaxQ = 3;         // quantiles per launch
constexpr int kBins = 256;
constexpr int kStride = kTile + 1;  // words per counter row
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kWidths = 5;        // cluster widths 1, 2, 4, 8, 16
constexpr int kUnroll = 16;       // rows in flight per thread
constexpr int kMinRows = 256;     // a block's rows, before a wider cluster
constexpr int kSmallWarps = 8;
constexpr int kSmallBlocks = 4;  // select_small blocks an SM holds, at least
constexpr int kNarrowMax = 65535;  // rows a block may count in 16 bits
constexpr int kSmemBytes = 224 * 1024;  // dynamic shared memory, at most
constexpr int64_t kMaxGridY = 65535;
constexpr uint32_t kInvalid = 0xFFFFFFFFu;
constexpr uint32_t kFull = 0xFFFFFFFFu;

struct Quantiles {
  float q[kMaxQ];
  int k;
};

// Counter words of one quantile's histogram.
__host__ __device__ constexpr int hist_words(bool wide) {
  return (wide ? kBins : kBins / 2) * kStride;
}

// The order of opentsdb_tpu/ops/kernels.py _order_key and its inverse.
__device__ __forceinline__ uint32_t order_key(float v) {
  const uint32_t b = __float_as_uint(v);
  return (b >> 31) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_to_float(uint32_t key) {
  return __uint_as_float((key >> 31) ? (key & 0x7FFFFFFFu) : ~key);
}

__device__ __forceinline__ uint32_t masked_key(float v, bool ok) {
  return ok ? min(order_key(v), kInvalid - 1) : kInvalid;
}

__device__ __forceinline__ float position(int n, float q) {
  return __fmul_rn((float)(n > 0 ? n - 1 : 0), q);
}

__device__ __forceinline__ float lerp(float vlo, float vhi, float pos,
                                      int lo) {
  return __fadd_rn(vlo, __fmul_rn(__fsub_rn(pos, (float)lo),
                                  __fsub_rn(vhi, vlo)));
}

// Loads that the compiler may neither drop nor sink into a branch: every
// load of a batch is in flight before any is used.
__device__ __forceinline__ float load_f32(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ uint32_t load_u8(const uint8_t* p) {
  uint32_t v;
  asm volatile("ld.global.nc.u8 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ int32_t load_s32(const int32_t* p) {
  int32_t v;
  asm volatile("ld.global.nc.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// The keys of kUnroll of a block's rows in column col: the group's rows
// first + i + u * kWarps (u < kUnroll) of those below first + n, where the
// group's rows are order[r0 ..] (r0 .. when order is null); kInvalid past
// n and for a column past B (live false). All loads are issued first.
__device__ __forceinline__ void load_keys(
    uint32_t (&key)[kUnroll], const float* __restrict__ vals,
    const uint8_t* __restrict__ mask, int64_t B,
    const int32_t* __restrict__ order, int64_t r0, int64_t col, bool live,
    int64_t first, int i, int n) {
  int64_t row[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int j = i + u * kWarps;
    row[u] = r0 + first + (j < n ? j : n - 1);
  }
  if (order) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) row[u] = load_s32(order + row[u]);
  }
  const int64_t c = live ? col : B - 1;
  float v[kUnroll];
  uint32_t ok[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    v[u] = load_f32(vals + row[u] * B + c);
    ok[u] = load_u8(mask + row[u] * B + c);
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    key[u] = live && i + u * kWarps < n ? masked_key(v[u], ok[u] != 0)
                                        : kInvalid;
  }
}

enum : int { kFirst = 0, kMiddle = 1, kLast = 2 };  // digit passes

// Counts one of a thread's keys (this lane's column) in a digit pass. The
// first pass has no prefix and one histogram: the top digits of one column
// barely vary, so runs of one digit are counted in registers (bin, run)
// before one shared-memory atomic. Later passes add each key whose high
// digits match a quantile's prefix to that quantile's histogram; the last
// also keeps, per quantile, the least key past the prefix.
template <int P, int NQ, int kKind>
__device__ __forceinline__ void count_key(
    uint32_t key, int shift, uint32_t high, const uint32_t (&pre)[kMaxQ],
    uint32_t (&above)[kMaxQ], int& bin, int& run, uint32_t* hist,
    int words) {
  if (key == kInvalid) return;
  const int d = (int)((key >> shift) & 0xFFu);
  if (kKind == kFirst) {
    if (d != bin) {
      if (run > 0) {
        atomicAdd(hist + (bin / P) * kStride,
                  (uint32_t)run << (16 * (bin % P)));
      }
      bin = d;
      run = 0;
    }
    ++run;
    return;
  }
  const uint32_t one = 1u << (16 * (d % P));
#pragma unroll
  for (int t = 0; t < NQ; ++t) {
    if ((key & high) == pre[t]) {
      atomicAdd(hist + t * words + (d / P) * kStride, one);
    }
    if (kKind == kLast && (key & ~0xFFu) > pre[t]) {
      above[t] = min(above[t], key);
    }
  }
}

// One digit pass over a thread's keys: from shared memory when staged,
// else from device memory.
template <int P, int NQ, int kKind>
__device__ __forceinline__ void count_pass(
    int shift, const uint32_t* s_prefix, uint32_t* s_above, uint32_t* hist,
    int words, bool staged, const uint32_t* keys,
    const float* __restrict__ vals, const uint8_t* __restrict__ mask,
    int64_t B, const int32_t* __restrict__ order, int64_t r0, int64_t col,
    int64_t first, int nmine) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t high = kKind == kFirst ? 0u : kInvalid << (shift + 8);
  uint32_t pre[kMaxQ], above[kMaxQ];
#pragma unroll
  for (int t = 0; t < kMaxQ; ++t) {
    pre[t] = t < NQ ? s_prefix[t * kTile + lane] : 0;
    above[t] = kInvalid;
  }
  int bin = 0, run = 0;
  hist += lane;
  if (staged) {
    for (int i = warp; i < nmine; i += kWarps) {
      count_key<P, NQ, kKind>(keys[i * kTile + lane], shift, high, pre,
                              above, bin, run, hist, words);
    }
  } else {
    for (int i = warp; i < nmine; i += kWarps * kUnroll) {
      uint32_t key[kUnroll];
      load_keys(key, vals, mask, B, order, r0, col, true, first, i, nmine);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        count_key<P, NQ, kKind>(key[u], shift, high, pre, above, bin, run,
                                hist, words);
      }
    }
  }
  if (kKind == kFirst && run > 0) {
    atomicAdd(hist + (bin / P) * kStride, (uint32_t)run << (16 * (bin % P)));
  }
#pragma unroll
  for (int t = 0; t < NQ; ++t) {
    if (kKind == kLast && above[t] != kInvalid) {
      atomicMin(&s_above[t * kTile + lane], above[t]);
    }
  }
}

template <int P, int kKind>
__device__ __forceinline__ void count_pass_q(
    int nq, int shift, const uint32_t* s_prefix, uint32_t* s_above,
    uint32_t* hist, int words, bool staged, const uint32_t* keys,
    const float* __restrict__ vals, const uint8_t* __restrict__ mask,
    int64_t B, const int32_t* __restrict__ order, int64_t r0, int64_t col,
    int64_t first, int nmine) {
  if (nq == 1) {
    count_pass<P, 1, kKind>(shift, s_prefix, s_above, hist, words, staged,
                            keys, vals, mask, B, order, r0, col, first,
                            nmine);
  } else if (nq == 2) {
    count_pass<P, 2, kKind>(shift, s_prefix, s_above, hist, words, staged,
                            keys, vals, mask, B, order, r0, col, first,
                            nmine);
  } else {
    count_pass<P, 3, kKind>(shift, s_prefix, s_above, hist, words, staged,
                            keys, vals, mask, B, order, r0, col, first,
                            nmine);
  }
}

// One block of a cluster of C: group groups[blockIdx.y] (blockIdx.y when
// groups is null), column tile blockIdx.x / C, the rank-th share of the
// group's rows. W: 32-bit counters (a share may exceed kNarrowMax rows).
// Dynamic shared memory: qs.k histograms, then stage_rows x kTile keys.
template <int C, bool W>
__global__ void __launch_bounds__(kThreads) select_large(
    const float* __restrict__ vals, const uint8_t* __restrict__ mask,
    int64_t S, int64_t B, const int32_t* __restrict__ order,
    const int32_t* __restrict__ offsets, const int32_t* __restrict__ groups,
    int64_t G, Quantiles qs, int stage_rows, float* __restrict__ out) {
  constexpr int P = W ? 1 : 2;            // bins per counter word
  constexpr int R = kBins / P / 32;       // counter words per lane in a scan
  constexpr int kWords = hist_words(W);
  extern __shared__ uint32_t smem[];
  uint32_t* hist = smem;                  // [qs.k][kBins / P][kStride]
  uint32_t* keys = smem + qs.k * kWords;  // [stage_rows][kTile]
  __shared__ uint32_t s_prefix[kMaxQ * kTile];  // selected high digits
  __shared__ uint32_t s_rank[kMaxQ * kTile];    // rank left (scanner's)
  __shared__ int s_n[kMaxQ * kTile];            // valid count (scanner's)
  __shared__ uint32_t s_above[kMaxQ * kTile];   // least key past prefix
  __shared__ int s_live;                        // any valid entry
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t tile0 = (int64_t)(blockIdx.x / C) * kTile;
  const int64_t col = tile0 + lane;
  const bool live = col < B;
  const int64_t g = groups ? groups[blockIdx.y] : blockIdx.y;
  const int64_t r0 = offsets ? offsets[g] : 0;
  const int64_t m = (offsets ? offsets[g + 1] : S) - r0;
  const int64_t share = (m + C - 1) / C;
  const int64_t mine0 = rank * share < m ? rank * share : m;
  const int nmine = (int)(mine0 + share < m ? share : m - mine0);
  const bool staged = share <= stage_rows;
  const int nq = qs.k;

  for (int i = threadIdx.x; i < kMaxQ * kTile; i += kThreads) {
    s_prefix[i] = 0;
    s_above[i] = kInvalid;
  }
  if (threadIdx.x == 0) s_live = 0;
  if (staged) {
    for (int i = warp; i < nmine; i += kWarps * kUnroll) {
      uint32_t key[kUnroll];
      load_keys(key, vals, mask, B, order, r0, col, live, mine0, i, nmine);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = i + u * kWarps;
        if (j < nmine) keys[j * kTile + lane] = key[u];
      }
    }
  }
  cluster.sync();  // s_live is cleared before any block of the cluster sets it

  for (int shift = 24; shift >= 0; shift -= 8) {
    // The first pass has no prefix: one histogram serves every quantile.
    const int nh = shift == 24 ? 1 : nq;
    for (int i = threadIdx.x; i < nh * kWords; i += kThreads) hist[i] = 0;
    __syncthreads();
    if (live) {
      if (shift == 24) {
        count_pass<P, 1, kFirst>(shift, s_prefix, s_above, hist, kWords,
                                 staged, keys, vals, mask, B, order, r0,
                                 col, mine0, nmine);
      } else if (shift > 0) {
        count_pass_q<P, kMiddle>(nq, shift, s_prefix, s_above, hist, kWords,
                                 staged, keys, vals, mask, B, order, r0,
                                 col, mine0, nmine);
      } else {
        count_pass_q<P, kLast>(nq, shift, s_prefix, s_above, hist, kWords,
                               staged, keys, vals, mask, B, order, r0, col,
                               mine0, nmine);
      }
    }
    cluster.sync();

    // One warp per (quantile, column) of the cluster, the same in every
    // pass: lane l holds the counts of bins ((j * 32 + l) * P + e).
    for (int p = rank * kWarps + warp; p < nq * kTile; p += C * kWarps) {
      const int t = p / kTile, c = p % kTile;
      const int th = shift == 24 ? 0 : t;
      const float q = t == 0 ? qs.q[0] : t == 1 ? qs.q[1] : qs.q[2];
      const uint32_t old = s_prefix[p];
      uint32_t cnt[R * P];
#pragma unroll
      for (int i = 0; i < R * P; ++i) cnt[i] = 0;
#pragma unroll
      for (int r = 0; r < C; ++r) {
        const uint32_t* h =
            cluster.map_shared_rank(hist, r) + th * kWords + c;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const uint32_t w = h[(j * 32 + lane) * kStride];
          if (P == 2) {
            cnt[2 * j] += w & 0xFFFFu;
            cnt[2 * j + 1] += w >> 16;
          } else {
            cnt[j] += w;
          }
        }
      }
      uint32_t mine = 0;
#pragma unroll
      for (int i = 0; i < R * P; ++i) mine += cnt[i];
      const uint32_t total = __reduce_add_sync(kFull, mine);
      uint32_t k;
      int n;
      if (shift == 24) {
        n = (int)total;
        k = (uint32_t)floorf(position(n, q));
        if (lane == 0) s_n[p] = n;
        if (n > 0 && lane < C) *cluster.map_shared_rank(&s_live, lane) = 1;
        if (n == 0 && lane == 0 && tile0 + c < B) {
          out[((int64_t)t * G + g) * B + tile0 + c] = 0.0f;
        }
      } else {
        n = s_n[p];
        k = s_rank[p];
      }
      if (k >= total) continue;  // no valid entry in this column
      // The digit whose bin holds rank k, round by round in bin order.
      uint32_t below = 0, rem = 0, hf = 0;
      int bin = 0, src = 0;
      bool found = false;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        uint32_t lt = 0;
#pragma unroll
        for (int e = 0; e < P; ++e) lt += cnt[j * P + e];
        uint32_t incl = lt;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const uint32_t o = __shfl_up_sync(kFull, incl, d);
          if (lane >= d) incl += o;
        }
        const uint32_t round = __shfl_sync(kFull, incl, 31);
        const bool now = !found && k < below + round;  // the same in the warp
        uint32_t run = below + incl - lt;
        const bool here = now && run <= k && k < run + lt;
#pragma unroll
        for (int e = 0; e < P; ++e) {
          const uint32_t h = cnt[j * P + e];
          if (here && k >= run && k < run + h) {
            bin = (j * 32 + lane) * P + e;
            rem = k - run;
            hf = h;
          }
          run += h;
        }
        const unsigned who = __ballot_sync(kFull, here);
        if (now) src = __ffs(who) - 1;
        found = found || now;
        if (!found) below += round;
      }
      bin = __shfl_sync(kFull, bin, src);
      rem = __shfl_sync(kFull, rem, src);
      hf = __shfl_sync(kFull, hf, src);
      const uint32_t prefix = old | ((uint32_t)bin << shift);
      __syncwarp();  // every lane has read s_prefix[p] and s_rank[p]
      if (shift > 0) {
        if (lane < C) cluster.map_shared_rank(s_prefix, lane)[p] = prefix;
        if (lane == 0) s_rank[p] = rem;
        continue;
      }
      // Last pass: prefix is the floor key. The next key above it: the
      // least non-empty bin past it, else the least key past the prefix.
      int next = kBins;
#pragma unroll
      for (int i = 0; i < R * P; ++i) {
        const int b = ((i / P) * 32 + lane) * P + i % P;
        if (b > bin && cnt[i] > 0) next = min(next, b);
      }
      next = __reduce_min_sync(kFull, next);
      uint32_t past = kInvalid;
      if (lane < C) past = cluster.map_shared_rank(s_above, lane)[p];
      past = __reduce_min_sync(kFull, past);
      if (lane == 0 && tile0 + c < B) {
        const float pos = position(n, q);
        const int lo = (int)floorf(pos);
        const uint32_t upto = (uint32_t)lo - rem + hf;  // keys <= floor key
        const uint32_t khi = (uint32_t)ceilf(pos) < upto ? prefix
                             : next < kBins ? (prefix & ~0xFFu) | next
                                            : past;
        out[((int64_t)t * G + g) * B + tile0 + c] =
            lerp(key_to_float(prefix), key_to_float(khi), pos, lo);
      }
    }
    cluster.sync();  // no block leaves or re-zeroes while another reads it
    if (!s_live) break;  // the same in every block of the cluster
  }
}

// The key of rank r (ascending, 0-based) among the first m <= M keys,
// fully unrolled so that the keys stay in registers.
template <int M>
__device__ __forceinline__ uint32_t rank_key(const uint32_t (&key)[M], int m,
                                             int r) {
  uint32_t found = kInvalid;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    int below = 0, upto = 0;
#pragma unroll
    for (int j = 0; j < M; ++j) {
      below += j < m && key[j] < key[i];
      upto += j < m && key[j] <= key[i];
    }
    if (i < m && below <= r && r < upto) found = key[i];
  }
  return found;
}

// The quantiles of one (group, column) of m <= M rows, selected in
// registers.
template <int M>
__device__ __forceinline__ void select_in_registers(
    const float* __restrict__ vals, const uint8_t* __restrict__ mask,
    int64_t B, const int32_t* __restrict__ order, int64_t r0, int m,
    int64_t col, int64_t g, int64_t G, const Quantiles& qs,
    float* __restrict__ out) {
  uint32_t key[M];
  int n = 0;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    key[i] = kInvalid;
    if (i < m) {
      const int64_t row = order ? order[r0 + i] : r0 + i;
      const int64_t at = row * B + col;
      if (mask[at]) {
        key[i] = order_key(vals[at]);
        ++n;
      }
    }
  }
  for (int j = 0; j < qs.k; ++j) {
    float v = 0.0f;
    if (n > 0) {
      const float pos =
          position(n, j == 0 ? qs.q[0] : j == 1 ? qs.q[1] : qs.q[2]);
      const int lo = (int)floorf(pos);
      v = lerp(key_to_float(rank_key<M>(key, m, lo)),
               key_to_float(rank_key<M>(key, m, (int)ceilf(pos))), pos, lo);
    }
    out[((int64_t)j * G + g) * B + col] = v;
  }
}

// One warp per (group, column tile); groups of more than kSmall rows are
// left to select_large.
__global__ void __launch_bounds__(kSmallWarps * 32, kSmallBlocks) select_small(
    const float* __restrict__ vals, const uint8_t* __restrict__ mask,
    int64_t S, int64_t B, const int32_t* __restrict__ order,
    const int32_t* __restrict__ offsets, int64_t G, Quantiles qs,
    float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t tiles = (B + kTile - 1) / kTile;
  const int64_t w = (int64_t)blockIdx.x * kSmallWarps + (threadIdx.x >> 5);
  if (w >= tiles * G) return;
  const int64_t g = w / tiles;
  const int64_t col = (w % tiles) * kTile + lane;
  const int64_t r0 = offsets ? offsets[g] : 0;
  const int64_t r1 = offsets ? offsets[g + 1] : S;
  const int m = (int)(r1 - r0);
  if (m > kSmall || col >= B) return;
  // Size classes, the same across the warp: a one-row group costs a
  // handful of instructions, a 32-row one ~2k compares per rank.
  if (m <= 1) {
    select_in_registers<1>(vals, mask, B, order, r0, m, col, g, G, qs, out);
  } else if (m <= 4) {
    select_in_registers<4>(vals, mask, B, order, r0, m, col, g, G, qs, out);
  } else if (m <= 8) {
    select_in_registers<8>(vals, mask, B, order, r0, m, col, g, G, qs, out);
  } else if (m <= 16) {
    select_in_registers<16>(vals, mask, B, order, r0, m, col, g, G, qs,
                            out);
  } else {
    select_in_registers<kSmall>(vals, mask, B, order, r0, m, col, g, G, qs,
                                out);
  }
}

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

constexpr int kMaxDevices = 64;

int current_device() {
  int dev = 0;
  return cudaGetDevice(&dev) == cudaSuccess && dev < kMaxDevices ? dev : -1;
}

using Kernel = void (*)(const float*, const uint8_t*, int64_t, int64_t,
                        const int32_t*, const int32_t*, const int32_t*,
                        int64_t, Quantiles, int, float*);

// select_large<1 << w, W>.
Kernel kernel(int w, bool wide) {
  switch (w) {
    case 4: return wide ? select_large<16, true> : select_large<16, false>;
    case 3: return wide ? select_large<8, true> : select_large<8, false>;
    case 2: return wide ? select_large<4, true> : select_large<4, false>;
    case 1: return wide ? select_large<2, true> : select_large<2, false>;
    default: return wide ? select_large<1, true> : select_large<1, false>;
  }
}

cudaLaunchConfig_t config(int64_t tiles, int64_t ng, int C, size_t smem,
                          cudaStream_t st, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(tiles * C), (unsigned)ng, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of 1 << w blocks that the card runs at once at smem bytes of
// dynamic shared memory (0: none, or the query failed).
int coresident(int w, size_t smem) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config(1, 1, 1 << w, smem, 0, attr);
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, (const void*)kernel(w, false),
                                     &cfg) != cudaSuccess) {
    clusters = 0;
  }
  cudaGetLastError();  // a refused query is not a launch's error
  return clusters;
}

struct Device {
  int sms;
  int widest;                  // log2 of the widest cluster
  int clusters[kWidths];       // co-resident clusters at kSmemBytes
};

// Every instantiation's attributes set, the SM count, the widest cluster
// select_large can run with (16 blocks where the card schedules such a
// cluster at the largest shared memory, else the portable 8) and how many
// clusters of each width run at once, once per device.
cudaError_t prepare(int dev, Device* out) {
  static std::atomic<int> known[kMaxDevices][2 + kWidths];
  if (dev >= 0 && known[dev][0].load(std::memory_order_acquire) > 0) {
    out->sms = known[dev][0].load(std::memory_order_relaxed);
    out->widest = known[dev][1].load(std::memory_order_relaxed);
    for (int w = 0; w < kWidths; ++w) {
      out->clusters[w] = known[dev][2 + w].load(std::memory_order_relaxed);
    }
    return cudaSuccess;
  }
  cudaError_t e = cudaSuccess;
  for (int w = 0; w < kWidths && e == cudaSuccess; ++w) {
    for (int wide = 0; wide < 2 && e == cudaSuccess; ++wide) {
      e = cudaFuncSetAttribute(kernel(w, wide),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    }
  }
  int n = 0;
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount,
                               dev < 0 ? 0 : dev);
  }
  if (e != cudaSuccess) return e;
  out->sms = n < 1 ? 1 : n;
  out->widest = 3;
  bool wide_ok = true;
  for (int wide = 0; wide < 2; ++wide) {
    wide_ok = wide_ok &&
              cudaFuncSetAttribute(kernel(4, wide),
                                   cudaFuncAttributeNonPortableClusterSizeAllowed,
                                   1) == cudaSuccess;
  }
  cudaGetLastError();
  for (int w = 0; w < kWidths; ++w) {
    out->clusters[w] = w < 4 || wide_ok ? coresident(w, kSmemBytes) : 0;
  }
  if (out->clusters[4] > 0) out->widest = 4;
  if (dev >= 0) {
    known[dev][1].store(out->widest, std::memory_order_relaxed);
    for (int w = 0; w < kWidths; ++w) {
      known[dev][2 + w].store(out->clusters[w], std::memory_order_relaxed);
    }
    known[dev][0].store(out->sms, std::memory_order_release);
  }
  return cudaSuccess;
}

// How select_large runs nq <= kMaxQ quantiles over n_big large groups of
// S rows between them.
struct Plan {
  int w;           // log2 of the cluster width
  bool wide;       // 32-bit counters
  int stage_rows;  // rows a block stages in shared memory, at most
  size_t smem;     // dynamic shared memory per block
};

Plan plan(const Device& d, int64_t S, int64_t B, int64_t n_big, int nq) {
  const int64_t pairs = cdiv(B, kTile) * n_big;
  const int64_t rows = n_big > 0 ? S / n_big : 0;  // an average group
  auto cap = [&](int w) {
    const bool wide = cdiv(S, (int64_t)1 << w) > kNarrowMax;
    return (int64_t)(kSmemBytes - nq * hist_words(wide) * 4) / (kTile * 4);
  };
  // Widen until an average group's share fits, unless that costs a wave
  // the launch does not already take; then only while a block keeps
  // kMinRows rows and the clusters still run in one wave.
  int w = 0;
  while (w < d.widest) {
    const bool one_wave = pairs <= d.clusters[w + 1];
    if (cdiv(rows, (int64_t)1 << w) <= cap(w)
            ? cdiv(rows, (int64_t)2 << w) >= kMinRows && one_wave
            : one_wave || pairs > d.clusters[w]) {
      ++w;
    } else {
      break;
    }
  }
  Plan p;
  p.w = w;
  p.wide = cdiv(S, (int64_t)1 << w) > kNarrowMax;
  const int64_t stage = cdiv(S, (int64_t)1 << w) < cap(w)
                            ? cdiv(S, (int64_t)1 << w) : cap(w);
  p.stage_rows = (int)stage;
  p.smem = (size_t)nq * hist_words(p.wide) * 4 + (size_t)stage * kTile * 4;
  return p;
}

// Launches for every chunk of kMaxQ quantiles: select_small over all G
// groups when with_small, select_large over the n_big groups listed in big
// (null: group blockIdx.y, for the columns entry).
cudaError_t run(const float* vals, const uint8_t* mask, int64_t S, int64_t B,
                const int32_t* order, const int32_t* offsets, int64_t G,
                bool with_small, const int32_t* big, int64_t n_big,
                const float* q, int32_t k, float* out, cudaStream_t st) {
  Device d;
  cudaError_t e = prepare(current_device(), &d);
  if (e != cudaSuccess) return e;
  const int64_t tiles = cdiv(B, kTile);
  for (int32_t q0 = 0; q0 < k; q0 += kMaxQ) {
    Quantiles qs;
    qs.k = k - q0 < kMaxQ ? k - q0 : kMaxQ;
    for (int i = 0; i < kMaxQ; ++i) qs.q[i] = i < qs.k ? q[q0 + i] : 0.0f;
    float* o = out + (int64_t)q0 * G * B;
    if (with_small) {
      select_small<<<(unsigned)cdiv(tiles * G, kSmallWarps),
                     kSmallWarps * 32, 0, st>>>(vals, mask, S, B, order,
                                                offsets, G, qs, o);
    }
    if (n_big == 0) continue;
    const Plan p = plan(d, S, B, n_big, qs.k);
    for (int64_t g0 = 0; g0 < n_big; g0 += kMaxGridY) {
      const int64_t ng = n_big - g0 < kMaxGridY ? n_big - g0 : kMaxGridY;
      const int32_t* groups = big ? big + g0 : nullptr;
      cudaLaunchAttribute attr[1];
      const cudaLaunchConfig_t cfg =
          config(tiles, ng, 1 << p.w, p.smem, st, attr);
      e = cudaLaunchKernelEx(&cfg, kernel(p.w, p.wide), vals, mask, S, B,
                             order, offsets, groups, G, qs, p.stage_rows, o);
      if (e != cudaSuccess) return e;
    }
  }
  return cudaSuccess;
}

}  // namespace

// vals [S, B] float32 and mask [S, B] bool (one byte each), row-major and
// contiguous; q: k host floats; out [k, B] float32. Returns the CUDA error
// code (0 = launched).
extern "C" int masked_select_columns(const float* vals, const uint8_t* mask,
                                     int64_t S, int64_t B, const float* q,
                                     int32_t k, float* out, void* stream) {
  if (S > 0 && B > 0 && k > 0) {
    const bool small = S <= kSmall;
    const cudaError_t e = run(vals, mask, S, B, nullptr, nullptr, 1, small,
                              nullptr, small ? 0 : 1, q, k, out,
                              (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

// The rows of group g are order[offsets[g] .. offsets[g + 1]) (order [S],
// offsets [G + 1] int32 on the device); big [n_big] lists every group of
// more than kSmall rows; out [k, G, B] float32.
extern "C" int masked_select_groups(const float* vals, const uint8_t* mask,
                                    int64_t S, int64_t B,
                                    const int32_t* order,
                                    const int32_t* offsets, int64_t G,
                                    const int32_t* big, int64_t n_big,
                                    const float* q, int32_t k, float* out,
                                    void* stream) {
  if (B > 0 && G > 0 && k > 0) {
    const cudaError_t e = run(vals, mask, S, B, order, offsets, G, true, big,
                              n_big, q, k, out, (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

// How the large-group kernel runs the first chunk of k quantiles over
// n_big groups of S rows between them (the columns entry: n_big = 1), on
// the current device: plan[0] the cluster width, plan[1] the clusters the
// card runs at once at that launch's shared memory, plan[2] the rows a
// block stages (a share above it counts from device memory), plan[3] 1 for
// 32-bit counters, plan[4] the dynamic shared memory in bytes.
extern "C" int masked_select_plan(int64_t S, int64_t B, int64_t n_big,
                                  int32_t k, int32_t* out) {
  Device d;
  const cudaError_t e = prepare(current_device(), &d);
  if (e != cudaSuccess) return (int)e;
  const Plan p = plan(d, S, B, n_big, k < kMaxQ ? k : kMaxQ);
  out[0] = 1 << p.w;
  out[1] = coresident(p.w, p.smem);
  out[2] = p.stage_rows;
  out[3] = p.wide;
  out[4] = (int32_t)p.smem;
  return 0;
}
