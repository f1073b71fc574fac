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
// B = 256) that is 21 MB, ~6 us at 3.35 TB/s. The select reads its group's
// rows five times (one count pass and four digit passes); the input fits
// in the 50 MB L2, so the repeats come from there.
//
// Design.
// - Large groups (more than kSmall rows): an MSB-first radix select on
//   8-bit digits, 4 histogram passes instead of 32 bit passes. A block owns
//   one group x a tile of 32 adjacent columns: lane l of every warp reads
//   column l, so each row read is one coalesced 128-byte line of values and
//   one 32-byte sector of mask. Per pass each block counts, in shared
//   memory, the digits of the valid keys that still match each selection's
//   prefix, for both ranks (floor and ceil) of up to kMaxQ quantiles at
//   once: [selections][256 bins][33] words, the 33rd word padding so that
//   the scan's reads across bins and the counting's atomics across columns
//   both fall on distinct banks. A warp per (selection, column) then scans
//   the 256 bins (8 rounds of a warp prefix sum) to the digit that holds the
//   remaining rank.
// - One group of the resident window holds up to 16384 rows, and B = 256
//   gives only 8 tiles: 8 blocks cannot fill 132 SMs. When there are few
//   (group, tile) pairs and many rows each, the rows are split over a
//   thread-block cluster of 2 to 16 blocks (16 only where the card
//   schedules such a cluster; Hopper's distributed shared memory), as wide
//   as keeps kRowsPerWarp rows per warp per pass: each block counts its
//   share of the rows into its own histograms, and the scan sums the
//   cluster's histograms through DSMEM (the cluster size is a template
//   parameter, so those loads are in flight together) and writes each new
//   prefix into every block of the cluster. Many pairs (an un-downsampled
//   percentile over tens of thousands of grid columns) or short groups (a
//   {dc=*} group-by) launch clusters of one.
// - Small groups (at most kSmall rows: a {host=*} group-by holds thousands
//   of one-series groups) must not pay a histogram pass each: one warp per
//   (group, tile) loads the group's keys into registers and selects each
//   rank directly, the key with (keys below it) <= rank < (keys at or below
//   it), in fully unrolled loops of a size class (1, 4, 8, 16 or 32 rows)
//   that the whole warp shares, so that a one-row group costs a handful of
//   instructions and nothing spills.
// Masked entries take the key 0xFFFFFFFF and never count; the selected
// keys are exact rank statistics, so the result matches a sort bit for bit
// before the lerp.

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
constexpr int kMaxSel = 2 * kMaxQ;
constexpr int kBins = 256;
constexpr int kStride = kTile + 1;  // words per histogram bin row
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kClusterWide = 16;  // non-portable: where the card allows it
constexpr int kClusterPortable = 8;
constexpr int kUnroll = 8;       // rows in flight per thread
constexpr int kRowsPerWarp = 64;  // per pass, before a wider cluster pays
constexpr int kSmallWarps = 8;
constexpr int64_t kMaxGridY = 65535;
constexpr uint32_t kInvalid = 0xFFFFFFFFu;
constexpr int kMaxHistBytes = kMaxSel * kBins * kStride * 4;

struct Quantiles {
  float q[kMaxQ];
  int k;
};

// The order of opentsdb_tpu/ops/kernels.py _order_key and its inverse.
__device__ __forceinline__ uint32_t order_key(float v) {
  const uint32_t b = __float_as_uint(v);
  return (b >> 31) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_to_float(uint32_t key) {
  return __uint_as_float((key >> 31) ? (key & 0x7FFFFFFFu) : ~key);
}

__device__ __forceinline__ float position(int n, float q) {
  return __fmul_rn((float)(n > 0 ? n - 1 : 0), q);
}

__device__ __forceinline__ float lerp(float vlo, float vhi, float pos,
                                      int lo) {
  return __fadd_rn(vlo, __fmul_rn(__fsub_rn(pos, (float)lo),
                                  __fsub_rn(vhi, vlo)));
}

// One block of a cluster of C: group groups[blockIdx.y] (blockIdx.y when
// groups is null), column tile blockIdx.x / C. C is a template parameter so
// that the loops over the cluster's blocks unroll and their distributed
// shared-memory loads are in flight together.
template <int C>
__global__ void __launch_bounds__(kThreads) select_large(
    const float* __restrict__ vals, const uint8_t* __restrict__ mask,
    int64_t S, int64_t B, const int32_t* __restrict__ order,
    const int32_t* __restrict__ offsets, const int32_t* __restrict__ groups,
    int64_t G, Quantiles qs, float* __restrict__ out) {
  extern __shared__ uint32_t hist[];  // [nsel][kBins][kStride]
  __shared__ uint32_t s_count[kTile];  // this block's valid entries
  __shared__ int s_n[kTile];           // the group's valid entries
  __shared__ uint32_t s_prefix[kMaxSel][kTile];
  __shared__ uint32_t s_rank[kMaxSel][kTile];  // rank left within prefix
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t col = (int64_t)(blockIdx.x / C) * kTile + lane;
  const bool live = col < B;
  const int64_t g = groups ? groups[blockIdx.y] : blockIdx.y;
  const int64_t r0 = offsets ? offsets[g] : 0;
  const int64_t r1 = offsets ? offsets[g + 1] : S;
  const int nsel = 2 * qs.k;
  // This block's rows: every (kWarps * C)-th of the group.
  const int64_t first = r0 + warp * C + rank;
  const int64_t step = (int64_t)kWarps * C;

  if (threadIdx.x < kTile) s_count[threadIdx.x] = 0;
  __syncthreads();
  uint32_t cnt = 0;
  if (live) {
    for (int64_t i = first; i < r1; i += step * kUnroll) {
      uint8_t m[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t at = i + u * step;
        m[u] = at < r1 ? mask[(order ? order[at] : at) * B + col] : 0;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) cnt += m[u];
    }
  }
  atomicAdd(&s_count[lane], cnt);
  cluster.sync();
  if (threadIdx.x < kTile) {
    uint32_t n = 0;
#pragma unroll
    for (int r = 0; r < C; ++r) {
      n += cluster.map_shared_rank(s_count, r)[threadIdx.x];
    }
    s_n[threadIdx.x] = (int)n;
  }
  __syncthreads();
  if (threadIdx.x < nsel * kTile) {
    const int t = threadIdx.x / kTile, c = threadIdx.x % kTile;
    const float pos = position(s_n[c], qs.q[t >> 1]);
    s_rank[t][c] = (uint32_t)((t & 1) ? ceilf(pos) : floorf(pos));
    s_prefix[t][c] = 0;
  }
  // The same in every block of the cluster: its counts are summed.
  const bool any = __syncthreads_or(live && s_n[lane] > 0);
  cluster.sync();  // no block leaves while another reads its s_count

  for (int shift = 24; any && shift >= 0; shift -= 8) {
    for (int i = threadIdx.x; i < nsel * kBins * kStride; i += kThreads) {
      hist[i] = 0;
    }
    __syncthreads();
    const uint32_t high = shift == 24 ? 0u : (kInvalid << (shift + 8));
    uint32_t pre[kMaxSel];
#pragma unroll
    for (int t = 0; t < kMaxSel; ++t) pre[t] = t < nsel ? s_prefix[t][lane] : 0;
    if (live) {
      // kUnroll rows' loads issued together, then counted.
      for (int64_t i = first; i < r1; i += step * kUnroll) {
        uint32_t key[kUnroll];
        bool ok[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int64_t idx = i + u * step;
          ok[u] = false;
          key[u] = 0;
          if (idx < r1) {
            const int64_t at = (order ? order[idx] : idx) * B + col;
            ok[u] = mask[at] != 0;
            key[u] = order_key(vals[at]);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (!ok[u]) continue;
          uint32_t* h =
              hist + ((key[u] >> shift) & 0xFFu) * kStride + lane;
#pragma unroll
          for (int t = 0; t < kMaxSel; ++t) {
            if (t < nsel && (key[u] & high) == pre[t]) {
              atomicAdd(h + t * kBins * kStride, 1u);
            }
          }
        }
      }
    }
    cluster.sync();
    // One warp per (selection, column) across the cluster: the digit whose
    // bin holds the remaining rank, in ascending bin order.
    for (int p = rank * kWarps + warp; p < nsel * kTile; p += C * kWarps) {
      const int t = p / kTile, c = p % kTile;
      const uint32_t k = s_rank[t][c];
      uint32_t below = 0;  // entries in the bins of earlier rounds
      for (int j = 0; j < kBins / 32; ++j) {
        const int bin = j * 32 + lane;
        const int at = (t * kBins + bin) * kStride + c;
        uint32_t h = 0;
#pragma unroll
        for (int r = 0; r < C; ++r) h += cluster.map_shared_rank(hist, r)[at];
        uint32_t incl = h;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const uint32_t o = __shfl_up_sync(0xFFFFFFFFu, incl, d);
          if (lane >= d) incl += o;
        }
        const uint32_t lo_b = below + incl - h;
        const bool here = h > 0 && lo_b <= k && k < below + incl;
        if (here) {
          const uint32_t prefix = s_prefix[t][c] | ((uint32_t)bin << shift);
#pragma unroll
          for (int r = 0; r < C; ++r) {
            cluster.map_shared_rank(&s_prefix[0][0], r)[t * kTile + c] = prefix;
            cluster.map_shared_rank(&s_rank[0][0], r)[t * kTile + c] = k - lo_b;
          }
        }
        if (__ballot_sync(0xFFFFFFFFu, here)) break;
        below += __shfl_sync(0xFFFFFFFFu, incl, 31);
      }
    }
    cluster.sync();
  }

  if (rank == 0 && live && warp < qs.k) {
    const int n = s_n[lane];
    float v = 0.0f;
    if (n > 0) {
      const float pos = position(n, qs.q[warp]);
      v = lerp(key_to_float(s_prefix[2 * warp][lane]),
               key_to_float(s_prefix[2 * warp + 1][lane]), pos,
               (int)floorf(pos));
    }
    out[((int64_t)warp * G + g) * B + col] = v;
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
      const float pos = position(n, qs.q[j]);
      const int lo = (int)floorf(pos);
      v = lerp(key_to_float(rank_key<M>(key, m, lo)),
               key_to_float(rank_key<M>(key, m, (int)ceilf(pos))), pos, lo);
    }
    out[((int64_t)j * G + g) * B + col] = v;
  }
}

// One warp per (group, column tile); groups of more than kSmall rows are
// left to select_large.
__global__ void __launch_bounds__(kSmallWarps * 32) select_small(
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

template <int C>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(select_large<C>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kMaxHistBytes);
}

// The SM count and the widest cluster select_large can run with (16
// blocks where the card schedules such a cluster at the largest shared
// memory, else the portable 8), with every instantiation's attributes set,
// once per device; 0 means not known yet.
cudaError_t prepare(int dev, int* sms, int* widest) {
  static std::atomic<int> known_sms[kMaxDevices];
  static std::atomic<int> known_widest[kMaxDevices];
  int n = dev >= 0 ? known_sms[dev].load(std::memory_order_relaxed) : 0;
  int c = dev >= 0 ? known_widest[dev].load(std::memory_order_relaxed) : 0;
  if (n == 0 || c == 0) {
    cudaError_t e = allow_smem<1>();
    if (e == cudaSuccess) e = allow_smem<2>();
    if (e == cudaSuccess) e = allow_smem<4>();
    if (e == cudaSuccess) e = allow_smem<8>();
    if (e == cudaSuccess) e = allow_smem<16>();
    if (e == cudaSuccess) {
      e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount,
                                 dev < 0 ? 0 : dev);
    }
    if (e != cudaSuccess) return e;
    if (n < 1) n = 1;
    c = kClusterPortable;
    if (cudaFuncSetAttribute(select_large<kClusterWide>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1) == cudaSuccess) {
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(kClusterWide, 1, 1);
      cfg.blockDim = dim3(kThreads, 1, 1);
      cfg.dynamicSmemBytes = kMaxHistBytes;
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = kClusterWide;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      int clusters = 0;
      if (cudaOccupancyMaxActiveClusters(&clusters,
                                         select_large<kClusterWide>,
                                         &cfg) == cudaSuccess &&
          clusters > 0) {
        c = kClusterWide;
      }
    }
    cudaGetLastError();  // a refused probe is not the launch's error
    if (dev >= 0) {
      known_sms[dev].store(n, std::memory_order_relaxed);
      known_widest[dev].store(c, std::memory_order_relaxed);
    }
  }
  *sms = n;
  *widest = c;
  return cudaSuccess;
}

template <int C>
cudaError_t launch_large(int64_t tiles, int64_t ng, size_t smem,
                         cudaStream_t st, const float* vals,
                         const uint8_t* mask, int64_t S, int64_t B,
                         const int32_t* order, const int32_t* offsets,
                         const int32_t* groups, int64_t G,
                         const Quantiles& qs, float* out) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(tiles * C), (unsigned)ng, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, select_large<C>, vals, mask, S, B, order,
                            offsets, groups, G, qs, out);
}

// Launches for every chunk of kMaxQ quantiles: select_small over all G
// groups when with_small, select_large over the n_big groups listed in big
// (null: group blockIdx.y, for the columns entry).
cudaError_t run(const float* vals, const uint8_t* mask, int64_t S, int64_t B,
                const int32_t* order, const int32_t* offsets, int64_t G,
                bool with_small, const int32_t* big, int64_t n_big,
                const float* q, int32_t k, float* out, cudaStream_t st) {
  int sms = 1, widest = 1;
  cudaError_t e = prepare(current_device(), &sms, &widest);
  if (e != cudaSuccess) return e;
  const int64_t tiles = cdiv(B, kTile);
  // Few (group, tile) pairs: split each group's rows over a cluster, as
  // wide as keeps ~kRowsPerWarp rows per warp per pass (on average: the
  // large groups hold at most S rows between them) and the pairs' blocks
  // within two waves of the card.
  int C = 1;
  const int64_t rows = n_big > 0 ? S / n_big : 0;
  while (C < widest && rows >= (int64_t)2 * C * kWarps * kRowsPerWarp &&
         tiles * n_big * 2 * C <= 2 * (int64_t)sms) {
    C *= 2;
  }
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
    for (int64_t g0 = 0; g0 < n_big; g0 += kMaxGridY) {
      const int64_t ng = n_big - g0 < kMaxGridY ? n_big - g0 : kMaxGridY;
      const int32_t* groups = big ? big + g0 : nullptr;
      const size_t smem = (size_t)2 * qs.k * kBins * kStride * 4;
      switch (C) {
        case 16:
          e = launch_large<16>(tiles, ng, smem, st, vals, mask, S, B, order,
                               offsets, groups, G, qs, o);
          break;
        case 8:
          e = launch_large<8>(tiles, ng, smem, st, vals, mask, S, B, order,
                              offsets, groups, G, qs, o);
          break;
        case 4:
          e = launch_large<4>(tiles, ng, smem, st, vals, mask, S, B, order,
                              offsets, groups, G, qs, o);
          break;
        case 2:
          e = launch_large<2>(tiles, ng, smem, st, vals, mask, S, B, order,
                              offsets, groups, G, qs, o);
          break;
        default:
          e = launch_large<1>(tiles, ng, smem, st, vals, mask, S, B, order,
                              offsets, groups, G, qs, o);
      }
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
