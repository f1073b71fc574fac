// Streaming-sketch kernels, hand-written for Hopper (sm_90a): the t-digest
// fold, the HyperLogLog fold, the HyperLogLog estimate and the merged
// t-digest quantile. Built by opentsdb_tpu_torch/ops/cuda_build.py with nvcc
// into a shared library with a plain C interface, loaded through ctypes;
// the wrappers and the plain PyTorch versions live in
// opentsdb_tpu_torch/ops/sketches.py.
//
// What they replace (the JAX package's XLA programs):
// - tdigest_fold_f32: opentsdb_tpu/stats/livesketch.py _fold_tdigests,
//   vmapped over opentsdb_tpu/ops/sketches.py tdigest_add / _compress (and
//   tdigest_merge, whose second digest is the batch). For each of R rows:
//   gather the row's K centroids, append its P batch entries, stably sort
//   the K + P entries by where(w > 0, mean, +inf), cumsum the weights,
//   assign k1 clusters floor(delta/pi * asin(2q - 1) + delta/2) with
//   q = (cum - w/2) / total, sum weight and mean * weight into delta
//   clusters, and write the row back in place.
// - hll_fold_i32: livesketch.py _fold_hlls over sketches.py hll_add /
//   hash32: murmur3 finalizer of each int32 item, register = top p bits,
//   rank = leading zeros of the low 32 - p bits + 1, max per register and
//   with the old row.
// - hll_estimate_f32: sketches.py hll_estimate, one estimate per row.
// - tdigest_merged_quantile_f32: livesketch.py _merged_quantile: one flat
//   compress of S selected rows x K centroids, then sketches.py
//   tdigest_quantile on the result.
//
// What bounds them. The HLL kernels and the merged quantile move few bytes
// per entry (4-16) and do a handful of integer or float operations on each:
// bytes bound them, as for every reduction of this port. The fold is a sort:
// a bitonic network over N2 = pow2(K + P) keys takes N2/2 * log2(N2) *
// (log2(N2) + 1) / 2 compare-exchanges, ~43 a byte of the row's input at
// the smoke's K + P = 1152 entries, so on paper operations bound it; in
// practice shared-memory latency and the block-wide barriers between the
// network's 66 steps do.
//
// Design.
// - tdigest_fold_f32: one block per row. The row's K centroids and P
//   batch entries land in shared memory with 64-bit sort keys: the
//   order-preserving uint32 image of the key float in the high half
//   (-0.0 read as +0.0, every NaN as the canonical one, which then sorts
//   after +inf: jnp.argsort's comparator), the entry's index in the low
//   half, so the keys are distinct and an unstable network gives the stable
//   order. A bitonic sort in shared memory (K + P <= 8192 entries, up to
//   160 KB with the dynamic shared-memory opt-in), a block-wide scan of the
//   sorted weights (each thread a contiguous chunk, then a scan of the chunk
//   totals), the cluster of each entry, and then thread c sums cluster c's
//   entries in sorted order, one after another: the order of XLA's
//   sequential segment_sum on the CPU, so weights match exactly and means
//   to the last bit wherever the cluster ids agree. Padded rows (idx
//   outside [0, C)) return at once.
// - hll_fold_i32: one block per register row: the row in shared memory
//   (16 KB at p = 12, 64 KB at p = 14, the opt-in again), shared-memory
//   atomicMax of each item's rank, the row written back. Integer registers:
//   bit-identical to the JAX package's.
// - hll_estimate_f32: one block per row; 2^-r is built from its exponent
//   bits (exact), summed in a fixed tree, then the JAX package's
//   corrections in float32.
// - tdigest_merged_quantile_f32: several launches. Keys for the S x K
//   entries (rows where valid is false weigh 0); a global bitonic sort
//   (tiles of 2048 keys sorted and merged in shared memory, the longer
//   strides in global passes); a scan of the sorted weights in tiles plus a
//   scan of the tile totals; per tile, each entry's cluster and, one warp a
//   cluster, the tile's sums for the clusters it touches (a fixed order:
//   the answer is the same on every run, so a restart that reloads the
//   same state answers bit for bit the same); the clusters' sums over tiles
//   in tile order; then one block sorts the delta centroids and
//   interpolates the quantiles.
//
// Arithmetic. Every float operation of the cluster and interpolation
// formulas is written as __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn in
// the JAX expression's order, so nvcc contracts none of them into an FMA.
// asinf, logf and log1pf are CUDA's (within 2 ulp, as XLA's are): an entry
// whose k lies within a few ulps of an integer may land in the next cluster.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kQLo = 1e-7f;
constexpr float kQHi = 0.99999988079071044921875f;  // float32(1 - 1e-7)
constexpr float kTiny = 1e-30f;
constexpr float kPiF = 3.14159274101257324219f;     // float32(pi)
constexpr int kMaxFoldThreads = 1024;

__device__ __forceinline__ uint32_t ord_key(float x) {
  if (x == 0.0f) return 0x80000000u;  // -0.0 and +0.0 are one key
  if (isnan(x)) return 0xFFC00000u;   // the canonical NaN, after +inf
  uint32_t u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ uint64_t entry_key(float mean, float w,
                                              uint32_t i) {
  float k = w > 0.0f ? mean : __int_as_float(0x7F800000);  // +inf
  return (static_cast<uint64_t>(ord_key(k)) << 32) | i;
}

// The k1 cluster of an entry of weight w > 0 at inclusive cumulative
// weight cum: sketches.py _compress, operation by operation.
__device__ __forceinline__ int cluster_of(float cum, float w, float total,
                                          float scale, float half_delta,
                                          int delta) {
  float q = __fdiv_rn(__fsub_rn(cum, __fmul_rn(w, 0.5f)), total);
  q = fminf(fmaxf(q, kQLo), kQHi);
  float t = __fsub_rn(__fmul_rn(2.0f, q), 1.0f);
  float k = __fadd_rn(__fmul_rn(scale, asinf(t)), half_delta);
  int c = __float2int_rz(k);
  return c < 0 ? 0 : (c > delta - 1 ? delta - 1 : c);
}

__host__ __device__ __forceinline__ int64_t pow2_at_least(int64_t n) {
  int64_t p = 1;
  while (p < n) p <<= 1;
  return p;
}

// The lower index of the p-th compare-exchange pair (i, i + j) of a
// bitonic step with stride j: every thread takes whole pairs, none idles.
__device__ __forceinline__ int64_t pair_low(int64_t p, int64_t j) {
  return ((p & ~(j - 1)) << 1) | (p & (j - 1));
}

__device__ __forceinline__ void compare_exchange(uint64_t* keys, int64_t i,
                                                 int64_t j, bool up) {
  uint64_t a = keys[i], b = keys[i + j];
  if ((a > b) == up) {
    keys[i] = b;
    keys[i + j] = a;
  }
}

// One compare-exchange step (k, j) of an ascending bitonic network over
// keys[0, n2) held by the block; direction from the global index.
__device__ __forceinline__ void bitonic_step_shared(uint64_t* keys,
                                                    int64_t n2, int64_t base,
                                                    int64_t k, int64_t j) {
  for (int64_t p = threadIdx.x; p < (n2 >> 1); p += blockDim.x) {
    int64_t i = pair_low(p, j);
    compare_exchange(keys, i, j, ((base + i) & k) == 0);
  }
  __syncthreads();
}

// Inclusive scan of vals[0, n) in place by the block: each thread sums a
// contiguous chunk in order, the chunk totals are scanned across each warp
// with shuffles and across the warps by warp 0, each chunk adds its offset.
// blockDim.x is a multiple of 32, at most 1024; tsum holds 32 floats.
// Returns the total to all.
__device__ float block_scan_inclusive(float* vals, int n, float* tsum) {
  const unsigned full = 0xFFFFFFFFu;
  const int T = blockDim.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = T >> 5;
  int per = (n + T - 1) / T;
  int lo = threadIdx.x * per;
  int hi = min(lo + per, n);
  float run = 0.0f;
  for (int i = lo; i < hi; ++i) {
    run = __fadd_rn(run, vals[i]);
    vals[i] = run;
  }
  float x = run;  // inclusive scan of the chunk totals within the warp
  for (int o = 1; o < 32; o <<= 1) {
    float y = __shfl_up_sync(full, x, o);
    if (lane >= o) x = __fadd_rn(x, y);
  }
  float excl = __shfl_up_sync(full, x, 1);
  if (lane == 0) excl = 0.0f;
  if (lane == 31) tsum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    float t = lane < nw ? tsum[lane] : 0.0f;
    for (int o = 1; o < 32; o <<= 1) {
      float y = __shfl_up_sync(full, t, o);
      if (lane >= o) t = __fadd_rn(t, y);
    }
    if (lane < nw) tsum[lane] = t;  // inclusive over the warps
  }
  __syncthreads();
  float off = __fadd_rn(warp ? tsum[warp - 1] : 0.0f, excl);
  for (int i = lo; i < hi; ++i) vals[i] = __fadd_rn(vals[i], off);
  float total = tsum[nw - 1];
  __syncthreads();
  return total;
}

// ---------------------------------------------------------------------------
// t-digest fold: one block per digest row
// ---------------------------------------------------------------------------

__global__ void tdigest_fold_kernel(float* __restrict__ means,
                                    float* __restrict__ weights, int64_t C,
                                    int K, const int32_t* __restrict__ idx,
                                    const float* __restrict__ batch,
                                    const uint8_t* __restrict__ valid,
                                    const float* __restrict__ bweights,
                                    int P, int n2, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float tsum[32];
  __shared__ int nonmono;
  const int64_t r = blockIdx.x;
  const int32_t slot = idx[r];
  if (slot < 0 || slot >= C) return;  // padding row: the whole block
  const int n = K + P;
  uint64_t* keys = reinterpret_cast<uint64_t*>(smem);    // [n2]
  float* vm = reinterpret_cast<float*>(keys + n2);       // [n] means
  float* vw = vm + n;                                    // [n] weights
  float* buf = vw + n;                                   // [n] cum, then ids
  int* cl = reinterpret_cast<int*>(buf);
  int* first = cl + n;                                   // [K] run starts
  for (int c = threadIdx.x; c < K; c += blockDim.x) first[c] = -1;
  if (threadIdx.x == 0) nonmono = 0;

  float* mrow = means + static_cast<int64_t>(slot) * K;
  float* wrow = weights + static_cast<int64_t>(slot) * K;
  for (int i = threadIdx.x; i < n2; i += blockDim.x) {
    if (i < n) {
      float m, w;
      if (i < K) {
        m = mrow[i];
        w = wrow[i];
      } else {
        int64_t b = r * P + (i - K);
        m = batch[b];
        w = valid ? (valid[b] ? 1.0f : 0.0f) : bweights[b];
      }
      vm[i] = m;
      vw[i] = w;
      keys[i] = entry_key(m, w, static_cast<uint32_t>(i));
    } else {
      keys[i] = ~0ull;  // padding sorts last
    }
  }
  __syncthreads();
  for (int64_t k = 2; k <= n2; k <<= 1)
    for (int64_t j = k >> 1; j > 0; j >>= 1)
      bitonic_step_shared(keys, n2, 0, k, j);

  for (int i = threadIdx.x; i < n; i += blockDim.x)
    buf[i] = vw[static_cast<uint32_t>(keys[i])];
  __syncthreads();
  float total = fmaxf(block_scan_inclusive(buf, n, tsum), kTiny);
  const float half_delta = static_cast<float>(K / 2) +
                           (K % 2 ? 0.5f : 0.0f);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float w = vw[static_cast<uint32_t>(keys[i])];
    float cum = buf[i];
    cl[i] = w > 0.0f ? cluster_of(cum, w, total, scale, half_delta, K) : K;
  }
  __syncthreads();
  // The ids are non-decreasing in sorted order (cumulative weights only
  // grow), so each cluster is one run: note where each run starts. Where
  // they are not (weight-0 entries interleaved with +inf or NaN means at
  // the end), every thread scans all entries instead.
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    int c = cl[i], prev = i ? cl[i - 1] : -1;
    if (c < prev) nonmono = 1;
    if (c != prev && c < K) first[c] = i;
  }
  __syncthreads();
  // Cluster c's entries in sorted order, one after another (XLA's
  // sequential segment_sum order).
  for (int c = threadIdx.x; c < K; c += blockDim.x) {
    float ws = 0.0f, ms = 0.0f;
    int i = 0, stop = n;
    if (!nonmono) {
      i = first[c];
      if (i < 0) i = stop = 0;  // no entry in cluster c
    }
    for (; i < stop; ++i) {
      if (cl[i] == c) {
        uint32_t e = static_cast<uint32_t>(keys[i]);
        float w = vw[e];
        ws = __fadd_rn(ws, w);
        ms = __fadd_rn(ms, __fmul_rn(vm[e], w));
      } else if (!nonmono) {
        break;  // the end of c's run
      }
    }
    mrow[c] = ws > 0.0f ? __fdiv_rn(ms, fmaxf(ws, kTiny)) : 0.0f;
    wrow[c] = ws;
  }
}

// ---------------------------------------------------------------------------
// HyperLogLog fold and estimate
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t hash32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__global__ void hll_fold_kernel(int32_t* __restrict__ regs, int64_t C,
                                int p, const int32_t* __restrict__ idx,
                                const int32_t* __restrict__ items,
                                const uint8_t* __restrict__ valid, int U) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* row = reinterpret_cast<int*>(smem);
  const int64_t r = blockIdx.x;
  const int32_t slot = idx[r];
  if (slot < 0 || slot >= C) return;
  const int m = 1 << p;
  int32_t* g = regs + static_cast<int64_t>(slot) * m;
  for (int i = threadIdx.x; i < m; i += blockDim.x) row[i] = g[i];
  __syncthreads();
  const int bits = 32 - p;
  const uint32_t low = (bits == 32) ? 0xFFFFFFFFu : ((1u << bits) - 1u);
  for (int j = threadIdx.x; j < U; j += blockDim.x) {
    int64_t b = r * U + j;
    if (!valid[b]) continue;
    uint32_t h = hash32(static_cast<uint32_t>(items[b]));
    int reg = static_cast<int>(h >> bits);
    uint32_t w = h & low;
    int rank;
    if (w > 0) {
      // floor(log2(float32(w))): the JAX package's frexp exponent - 1,
      // rounding of w to float32 included.
      int lg = static_cast<int>((__float_as_uint(__uint2float_rn(w)) >> 23)
                                & 0xFF) - 127;
      rank = bits - lg;
    } else {
      rank = bits + 1;
    }
    atomicMax(&row[reg], rank);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < m; i += blockDim.x) g[i] = row[i];
}

constexpr int kEstThreads = 256;

__global__ void hll_estimate_kernel(const int32_t* __restrict__ regs, int m,
                                    float* __restrict__ out) {
  __shared__ float ssum[kEstThreads];
  __shared__ int szero[kEstThreads];
  const int32_t* row = regs + static_cast<int64_t>(blockIdx.x) * m;
  float s = 0.0f;
  int z = 0;
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    int r = row[i];
    // 2^-r exactly (r <= 33 here).
    s = __fadd_rn(s, __int_as_float((127 - r) << 23));
    z += (r == 0);
  }
  ssum[threadIdx.x] = s;
  szero[threadIdx.x] = z;
  __syncthreads();
  for (int off = blockDim.x / 2; off > 0; off >>= 1) {
    if (static_cast<int>(threadIdx.x) < off) {
      ssum[threadIdx.x] = __fadd_rn(ssum[threadIdx.x],
                                    ssum[threadIdx.x + off]);
      szero[threadIdx.x] += szero[threadIdx.x + off];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    double alpha = 0.7213 / (1.0 + 1.079 / m);
    float amm = static_cast<float>(alpha * m * m);
    float fm = static_cast<float>(m);
    float raw = __fdiv_rn(amm, ssum[0]);
    float zeros = static_cast<float>(szero[0]);
    float small = __fmul_rn(fm, logf(__fdiv_rn(fm, fmaxf(zeros, 1.0f))));
    float est = (raw <= 2.5f * fm && zeros > 0.0f) ? small : raw;
    const float two32 = 4294967296.0f;
    if (est > __fdiv_rn(two32, 30.0f))
      est = __fmul_rn(-two32, log1pf(__fdiv_rn(-est, two32)));
    out[blockIdx.x] = est;
  }
}

// ---------------------------------------------------------------------------
// Merged quantile: keys, global sort, scan, cluster sums, interpolation
// ---------------------------------------------------------------------------

constexpr int kTile = 2048;        // keys a block sorts in shared memory
constexpr int kTileThreads = 1024;
constexpr int kScanTile = 2048;    // sorted entries a scan / bin block takes
constexpr int kScanThreads = 256;
constexpr int kFinalThreads = 256;

struct MqEntry {
  const float* means;
  const float* weights;
  int K;
  const int32_t* idx;
  const uint8_t* valid;
};

__device__ __forceinline__ void mq_load(const MqEntry& e, uint32_t i,
                                        float* m, float* w) {
  uint32_t s = i / static_cast<uint32_t>(e.K);
  uint32_t c = i - s * static_cast<uint32_t>(e.K);
  if (e.valid[s]) {
    int64_t off = static_cast<int64_t>(e.idx[s]) * e.K + c;
    *m = e.means[off];
    *w = e.weights[off];
  } else {
    *m = 0.0f;
    *w = 0.0f;
  }
}

__global__ void mq_keys_kernel(MqEntry e, int64_t n, int64_t n2,
                               uint64_t* __restrict__ keys) {
  int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n2) return;
  if (i < n) {
    float m, w;
    mq_load(e, static_cast<uint32_t>(i), &m, &w);
    keys[i] = entry_key(m, w, static_cast<uint32_t>(i));
  } else {
    keys[i] = ~0ull;
  }
}

// The network's steps (k, j) with kfrom <= k <= kto and j < tile, in shared
// memory over one tile: with kfrom == 2 and kto == tile the tile's whole
// sort; with kfrom == kto == k the tail (j < tile) of a longer stage k.
__global__ void mq_sort_tile_kernel(uint64_t* __restrict__ keys, int tile,
                                    int64_t kfrom, int64_t kto) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* s = reinterpret_cast<uint64_t*>(smem);
  int64_t base = static_cast<int64_t>(blockIdx.x) * tile;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) s[i] = keys[base + i];
  __syncthreads();
  for (int64_t k = kfrom; k <= kto; k <<= 1) {
    int64_t j0 = (k >> 1) < tile ? (k >> 1) : (tile >> 1);
    for (int64_t j = j0; j > 0; j >>= 1)
      bitonic_step_shared(s, tile, base, k, j);
  }
  for (int i = threadIdx.x; i < tile; i += blockDim.x) keys[base + i] = s[i];
}

__global__ void mq_sort_global_kernel(uint64_t* __restrict__ keys,
                                      int64_t n2, int64_t k, int64_t j) {
  int64_t p = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (p >= (n2 >> 1)) return;
  int64_t i = pair_low(p, j);
  compare_exchange(keys, i, j, (i & k) == 0);
}

// Tile-local inclusive scan of the sorted weights; tile totals out.
__global__ void mq_scan_tiles_kernel(MqEntry e,
                                     const uint64_t* __restrict__ keys,
                                     int64_t n, float* __restrict__ cum,
                                     float* __restrict__ tile_total) {
  __shared__ float vals[kScanTile];
  __shared__ float tsum[32];
  int64_t base = static_cast<int64_t>(blockIdx.x) * kScanTile;
  int cnt = static_cast<int>(n - base < kScanTile ? n - base : kScanTile);
  for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
    float m, w;
    mq_load(e, static_cast<uint32_t>(keys[base + i]), &m, &w);
    vals[i] = w;
  }
  __syncthreads();
  float total = block_scan_inclusive(vals, cnt, tsum);
  for (int i = threadIdx.x; i < cnt; i += blockDim.x) cum[base + i] = vals[i];
  if (threadIdx.x == 0) tile_total[blockIdx.x] = total;
}

// Exclusive prefix of the tile totals (in tile order) and the grand total
// at offs[ntiles]; one block.
__global__ void mq_scan_totals_kernel(const float* __restrict__ tile_total,
                                      int64_t ntiles,
                                      float* __restrict__ offs) {
  if (threadIdx.x != 0) return;
  float acc = 0.0f;
  for (int64_t t = 0; t < ntiles; ++t) {
    offs[t] = acc;
    acc = __fadd_rn(acc, tile_total[t]);
  }
  offs[ntiles] = acc;
}

// Per tile: each entry's cluster, then one warp a cluster in the tile's
// range: lanes sum every 32nd entry in order, a fixed shuffle tree joins
// them. partial[tile][c] = (weight sum, mean * weight sum).
__global__ void mq_bins_kernel(MqEntry e, const uint64_t* __restrict__ keys,
                               int64_t n, const float* __restrict__ cum,
                               const float* __restrict__ offs,
                               int64_t ntiles, int delta, float scale,
                               float half_delta,
                               float2* __restrict__ partial) {
  __shared__ float sm[kScanTile];
  __shared__ float sw[kScanTile];
  __shared__ int scl[kScanTile];
  __shared__ int crange[2];
  int64_t base = static_cast<int64_t>(blockIdx.x) * kScanTile;
  int cnt = static_cast<int>(n - base < kScanTile ? n - base : kScanTile);
  float total = fmaxf(offs[ntiles], kTiny);
  float off = offs[blockIdx.x];
  if (threadIdx.x == 0) {
    crange[0] = delta;
    crange[1] = -1;
  }
  __syncthreads();
  int lo = delta, hi = -1;
  for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
    float m, w;
    mq_load(e, static_cast<uint32_t>(keys[base + i]), &m, &w);
    int c = delta;
    if (w > 0.0f) {
      c = cluster_of(__fadd_rn(cum[base + i], off), w, total, scale,
                     half_delta, delta);
      lo = min(lo, c);
      hi = max(hi, c);
    }
    sm[i] = m;
    sw[i] = w;
    scl[i] = c;
  }
  atomicMin(&crange[0], lo);
  atomicMax(&crange[1], hi);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int c = crange[0] + warp; c <= crange[1]; c += nwarps) {
    float ws = 0.0f, ms = 0.0f;
    for (int i = lane; i < cnt; i += 32) {
      if (scl[i] == c) {
        ws = __fadd_rn(ws, sw[i]);
        ms = __fadd_rn(ms, __fmul_rn(sm[i], sw[i]));
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      ws = __fadd_rn(ws, __shfl_down_sync(0xFFFFFFFFu, ws, o));
      ms = __fadd_rn(ms, __shfl_down_sync(0xFFFFFFFFu, ms, o));
    }
    if (lane == 0)
      partial[static_cast<int64_t>(blockIdx.x) * delta + c] =
          make_float2(ws, ms);
  }
}

// One block: the delta clusters' sums over tiles (in tile order), the
// centroids sorted as tdigest_quantile sorts them, the quantiles.
__global__ void mq_final_kernel(const float2* __restrict__ partial,
                                int64_t ntiles, int delta,
                                const float* __restrict__ q, int Q,
                                float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* key = reinterpret_cast<uint64_t*>(smem);  // [delta] sort keys
  float* cm = reinterpret_cast<float*>(key + delta);  // cluster means
  float* cw = cm + delta;                             // cluster weights
  float* sm = cw + delta;                             // sorted means
  float* sw = sm + delta;                             // sorted weights
  float* centers = sw + delta;                        // [delta]
  __shared__ int nreal_s;
  for (int c = threadIdx.x; c < delta; c += blockDim.x) {
    float ws = 0.0f, ms = 0.0f;
    for (int64_t t = 0; t < ntiles; ++t) {
      float2 v = partial[t * delta + c];
      ws = __fadd_rn(ws, v.x);
      ms = __fadd_rn(ms, v.y);
    }
    float mean = ws > 0.0f ? __fdiv_rn(ms, fmaxf(ws, kTiny)) : 0.0f;
    cm[c] = mean;
    cw[c] = ws;
    key[c] = entry_key(mean, ws, static_cast<uint32_t>(c));
  }
  __syncthreads();
  for (int c = threadIdx.x; c < delta; c += blockDim.x) {
    int rank = 0;
    for (int j = 0; j < delta; ++j) rank += key[j] < key[c];
    sm[rank] = cm[c];
    sw[rank] = cw[c];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int nreal = 0;
    float total = 0.0f;
    for (int c = 0; c < delta; ++c) {
      nreal += cw[c] > 0.0f;
      total = __fadd_rn(total, sw[c]);
    }
    nreal = nreal > 1 ? nreal : 1;
    total = fmaxf(total, kTiny);
    float cum = 0.0f;
    for (int i = 0; i < delta; ++i) {
      cum = __fadd_rn(cum, sw[i]);
      centers[i] = i < nreal
                       ? __fdiv_rn(__fsub_rn(cum, __fmul_rn(sw[i], 0.5f)),
                                   total)
                       : __int_as_float(0x7F800000);
    }
    nreal_s = nreal;
  }
  __syncthreads();
  const int last = nreal_s - 1;
  for (int qi = threadIdx.x; qi < Q; qi += blockDim.x) {
    float target = fminf(fmaxf(q[qi], 0.0f), 1.0f);
    int idx = 0;  // searchsorted, side left
    for (int i = 0; i < delta; ++i) idx += centers[i] < target;
    int lo = min(max(idx - 1, 0), last);
    int hi = min(max(idx, 0), last);
    float c0 = centers[lo], c1 = centers[hi];
    float m0 = sm[lo], m1 = sm[hi];
    float frac = c1 > c0 ? __fdiv_rn(__fsub_rn(target, c0),
                                     fmaxf(__fsub_rn(c1, c0), kTiny))
                         : 0.0f;
    frac = fminf(fmaxf(frac, 0.0f), 1.0f);
    float est = __fadd_rn(m0, __fmul_rn(frac, __fsub_rn(m1, m0)));
    if (target <= centers[0]) est = sm[0];
    if (target >= centers[last]) est = sm[last];
    out[qi] = est;
  }
}

struct MqLayout {
  int64_t n2, ntiles, keys, cum, totals, offs, partial, bytes;
};

__host__ MqLayout mq_layout(int64_t n, int delta) {
  auto up = [](int64_t b) { return (b + 255) & ~int64_t(255); };
  MqLayout l;
  l.n2 = pow2_at_least(n < 2 ? 2 : n);
  l.ntiles = (n + kScanTile - 1) / kScanTile;
  l.keys = 0;
  l.cum = l.keys + up(l.n2 * 8);
  l.totals = l.cum + up(n * 4);
  l.offs = l.totals + up(l.ntiles * 4);
  l.partial = l.offs + up((l.ntiles + 1) * 4);
  l.bytes = l.partial + up(l.ntiles * delta * 8);
  return l;
}

cudaError_t set_smem(const void* fn, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace

extern "C" {

// Fold batch row r (P floats; weight valid[r, j] as 0/1, or bweights[r, j])
// into digest row idx[r] of the [C, K] stacks, in place. K + P <= 8192.
int tdigest_fold_f32(float* means, float* weights, int64_t C, int32_t K,
                     const int32_t* idx, int64_t R, const float* batch,
                     const uint8_t* valid, const float* bweights, int32_t P,
                     cudaStream_t stream) {
  if (R <= 0) return 0;
  const int n = K + P;
  const int n2 = static_cast<int>(pow2_at_least(n));
  int threads = n2 / 2;  // one compare-exchange pair a thread
  threads = threads < 128 ? 128 : (threads > kMaxFoldThreads
                                       ? kMaxFoldThreads : threads);
  const int smem = n2 * 8 + n * 12 + K * 4;
  cudaError_t err = set_smem(reinterpret_cast<const void*>(
                                 tdigest_fold_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = static_cast<float>(K) / kPiF;
  tdigest_fold_kernel<<<static_cast<unsigned>(R), threads, smem, stream>>>(
      means, weights, C, K, idx, batch, valid, bweights, P, n2, scale);
  return static_cast<int>(cudaGetLastError());
}

// Fold item row r (U int32 items, valid[r, j]) into register row idx[r] of
// the [C, 2^p] stack, in place.
int hll_fold_i32(int32_t* regs, int64_t C, int32_t p, const int32_t* idx,
                 int64_t H, const int32_t* items, const uint8_t* valid,
                 int32_t U, cudaStream_t stream) {
  if (H <= 0) return 0;
  const int smem = (1 << p) * 4;
  cudaError_t err = set_smem(reinterpret_cast<const void*>(hll_fold_kernel),
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  hll_fold_kernel<<<static_cast<unsigned>(H), 512, smem, stream>>>(
      regs, C, p, idx, items, valid, U);
  return static_cast<int>(cudaGetLastError());
}

// One float32 estimate per [m] register row.
int hll_estimate_f32(const int32_t* regs, int64_t R, int32_t m, float* out,
                     cudaStream_t stream) {
  if (R <= 0) return 0;
  hll_estimate_kernel<<<static_cast<unsigned>(R), kEstThreads, 0, stream>>>(
      regs, m, out);
  return static_cast<int>(cudaGetLastError());
}

// Scratch bytes tdigest_merged_quantile_f32 needs for n = S * K entries.
int64_t tdigest_merged_quantile_scratch(int64_t n, int32_t delta) {
  return mq_layout(n, delta).bytes;
}

// Quantiles q[Q] of the merged digest of rows idx[s] (valid[s]) of the
// [*, K] stacks, compressed to delta centroids; out[Q].
int tdigest_merged_quantile_f32(const float* means, const float* weights,
                                int32_t K, const int32_t* idx,
                                const uint8_t* valid, int64_t S,
                                const float* q, int32_t Q, int32_t delta,
                                void* scratch, int64_t scratch_bytes,
                                float* out, cudaStream_t stream) {
  const int64_t n = S * K;
  if (n <= 0 || Q <= 0) return static_cast<int>(cudaErrorInvalidValue);
  MqLayout l = mq_layout(n, delta);
  if (scratch_bytes < l.bytes) return static_cast<int>(cudaErrorInvalidValue);
  unsigned char* base = static_cast<unsigned char*>(scratch);
  uint64_t* keys = reinterpret_cast<uint64_t*>(base + l.keys);
  float* cum = reinterpret_cast<float*>(base + l.cum);
  float* totals = reinterpret_cast<float*>(base + l.totals);
  float* offs = reinterpret_cast<float*>(base + l.offs);
  float2* partial = reinterpret_cast<float2*>(base + l.partial);
  MqEntry e{means, weights, K, idx, valid};
  const float scale = static_cast<float>(delta) / kPiF;
  const float half_delta = static_cast<float>(delta / 2) +
                           (delta % 2 ? 0.5f : 0.0f);
  cudaError_t err;

  const int64_t n2 = l.n2;
  mq_keys_kernel<<<static_cast<unsigned>((n2 + 255) / 256), 256, 0,
                   stream>>>(e, n, n2, keys);
  const int tile = static_cast<int>(n2 < kTile ? n2 : kTile);
  const int tthreads = tile / 2 < kTileThreads ? (tile / 2 < 32 ? 32
                                                                : tile / 2)
                                               : kTileThreads;
  const int tsmem = tile * 8;
  err = set_smem(reinterpret_cast<const void*>(mq_sort_tile_kernel), tsmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned tiles = static_cast<unsigned>(n2 / tile);
  mq_sort_tile_kernel<<<tiles, tthreads, tsmem, stream>>>(keys, tile, 2,
                                                         tile);
  for (int64_t k = 2 * static_cast<int64_t>(tile); k <= n2; k <<= 1) {
    for (int64_t j = k >> 1; j >= tile; j >>= 1)
      mq_sort_global_kernel<<<static_cast<unsigned>((n2 / 2 + 255) / 256),
                              256, 0, stream>>>(keys, n2, k, j);
    mq_sort_tile_kernel<<<tiles, tthreads, tsmem, stream>>>(keys, tile, k,
                                                           k);
  }
  mq_scan_tiles_kernel<<<static_cast<unsigned>(l.ntiles), kScanThreads, 0,
                         stream>>>(e, keys, n, cum, totals);
  mq_scan_totals_kernel<<<1, 32, 0, stream>>>(totals, l.ntiles, offs);
  err = cudaMemsetAsync(partial, 0, l.ntiles * delta * sizeof(float2),
                        stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  mq_bins_kernel<<<static_cast<unsigned>(l.ntiles), kScanThreads, 0,
                   stream>>>(e, keys, n, cum, offs, l.ntiles, delta, scale,
                             half_delta, partial);
  const int fsmem = delta * 8 + delta * 5 * 4;
  err = set_smem(reinterpret_cast<const void*>(mq_final_kernel), fsmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  mq_final_kernel<<<1, kFinalThreads, fsmem, stream>>>(partial, l.ntiles,
                                                       delta, q, Q, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
