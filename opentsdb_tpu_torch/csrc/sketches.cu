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
//   with the old row; a slot named by several rows takes the max over all
//   of them (.at[idx].max).
// - hll_estimate_f32: sketches.py hll_estimate, one estimate per row.
// - tdigest_merged_quantile_f32: livesketch.py _merged_quantile: one flat
//   compress of S selected rows x K centroids, then sketches.py
//   tdigest_quantile on the result.
//
// One fact shapes both t-digest kernels: an entry of weight +0.0 or -0.0
// can be dropped before the sort without changing a bit of the answer. Its
// key is +inf, it adds zero to every cumulative sum and to the total, and
// it lands in the trash cluster. So both kernels sort only the entries
// whose weight is not zero (an entry of NaN or negative weight stays: it
// enters cum and total), in index order, and a stable sort of their 32-bit
// order keys gives jnp.argsort's order: no index in the key, no padding to
// a power of two.
//
// What bounds them, and what the design does about it.
// - The merged quantile reads each live centroid once (8 bytes) and does
//   ~log2(n) comparisons' worth of work per entry: bytes and launches
//   bound it. It sorts with an LSD radix sort written here: four passes of
//   8 bits over the live entries, each pass a count (every block's digit
//   counts over its run of 2048-entry tiles), one scan per digit over the
//   blocks, and a scatter: each block ranks its tiles in order, stably
//   (per warp round, the lanes of equal digit found by ballots, warps in
//   tile order), stages a tile in shared memory in digit order and writes
//   it out as runs. The first pass reads the digests directly and drops
//   the zero-weight entries and invalid rows on the way (the compaction
//   costs no pass of its own); the payload (mean, weight) travels with the
//   key, so the weight scan and the cluster pass read it in sorted order
//   with coalesced loads. 15 kernel launches and a memset (the bitonic
//   network it replaces took ~71 launches over 2^21 padded 64-bit keys at
//   the daemon's 16,384 rows).
// - The fold sorts K + P <= 8192 entries a row in one block: four stable
//   8-bit passes, four block barriers a pass (66 and 91 network steps
//   before). The keys stay in registers (R a thread, R in {4, 8, 16}),
//   ranked per warp round as above; the block is sized to the row (at
//   most 16 warps) and holds 6 bytes a key while sorting, 14 after, so 3
//   to 4 rows share an SM even at the 4096-value chunk (1 before).
// - The HLL fold reads each item once (4 bytes and a mask byte) and does
//   ~10 integer operations on it, and the estimate reads each register
//   once: bytes bound both, and at the daemon's shapes (a few thousand
//   items, 8 x 4,096 registers) so does the launch. The fold runs one
//   thread per 4 items over the flattened [H, U] batch (16-byte loads) and
//   raises each register with a global atomicMax after a test through L2:
//   no register row is staged in shared memory, so it moves only the items
//   and the registers they touch, needs no barrier, and a slot that two
//   rows name is exact (max is order-free). The estimate sums 2^(33 - r)
//   in 64-bit integers (exact) with 16-byte loads and warp shuffles.
//
// Fixed orders. The fold sums each cluster's entries one after another in
// sorted order: the order of XLA's sequential segment_sum on the CPU, so
// weights match exactly and means to the last bit wherever the cluster ids
// agree. The merged quantile sums in a fixed order and never with float
// atomics (per tile, one warp a cluster over the tile's entries; over the
// tiles, 8 threads a cluster in turn and a fixed shuffle tree), so the
// same state answers the same bytes every time, across a restart too.
// Integer atomics (digit counts) give the same counts in any order.
//
// Arithmetic. Every float operation of the cluster and interpolation
// formulas is written as __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn in
// the JAX expression's order, so nvcc contracts none of them into an FMA.
// asinf, logf and log1pf are CUDA's (within 2 ulp, as XLA's are): an entry
// whose k lies within a few ulps of an integer may land in the next cluster.
// The total is clamped as jnp.maximum clamps it: a NaN total stays NaN.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kQLo = 1e-7f;
constexpr float kQHi = 0.99999988079071044921875f;  // float32(1 - 1e-7)
constexpr float kTiny = 1e-30f;
constexpr float kPiF = 3.14159274101257324219f;     // float32(pi)
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kDigits = 256;                        // 8-bit radix digits
constexpr int kPasses = 4;

__device__ __forceinline__ uint32_t ord_key(float x) {
  if (x == 0.0f) return 0x80000000u;  // -0.0 and +0.0 are one key
  if (isnan(x)) return 0xFFC00000u;   // the canonical NaN, after +inf
  uint32_t u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The 32-bit order key of an entry: where(w > 0, mean, +inf).
__device__ __forceinline__ uint32_t entry_key32(float mean, float w) {
  return ord_key(w > 0.0f ? mean : __int_as_float(0x7F800000));
}

// The final step's 64-bit key: order key, then the centroid's index.
__device__ __forceinline__ uint64_t entry_key(float mean, float w,
                                              uint32_t i) {
  return (static_cast<uint64_t>(entry_key32(mean, w)) << 32) | i;
}

// jnp.maximum(total, 1e-30): NaN stays NaN (fmaxf would drop it).
__device__ __forceinline__ float clamp_total(float total) {
  return isnan(total) ? total : fmaxf(total, kTiny);
}

// The k1 cluster of an entry of weight w > 0 at inclusive cumulative
// weight cum: sketches.py _compress, operation by operation. (A NaN q
// clamps to kQLo here and lands in cluster 0, where XLA's NaN -> int32
// conversion puts it too.)
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

// Stable rank of this lane's key among the warp's keys of the same digit:
// those of earlier rounds (wcnt, the warp's own digit counts) and of lower
// lanes in this round. Every lane of the warp calls it; a lane that holds
// no key (live false) takes part and gets no rank. The lanes holding the
// same digit are found with one ballot a digit bit (cheaper than
// __match_any_sync, which the card runs as a slow loop).
__device__ __forceinline__ uint32_t warp_rank(int digit, bool live,
                                              uint32_t* wcnt) {
  const int lane = threadIdx.x & 31;
  unsigned peers = __ballot_sync(kFull, live);
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const bool bit = (digit >> b) & 1;
    const unsigned votes = __ballot_sync(kFull, bit);
    peers &= bit ? votes : ~votes;
  }
  const unsigned lower = peers & ((1u << lane) - 1u);
  uint32_t pre = live ? wcnt[digit] : 0u;
  __syncwarp();
  if (live && lower == 0) wcnt[digit] = pre + __popc(peers);
  __syncwarp();
  return pre + __popc(lower);
}

// Exclusive scan of cnt[0, 256) in place by warp 0 (8 digits a lane);
// returns the sum to warp 0's lanes.
__device__ __forceinline__ uint32_t warp_scan_digits(uint32_t* cnt) {
  const int lane = threadIdx.x & 31;
  uint32_t v[8], s = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    v[j] = cnt[lane * 8 + j];
    s += v[j];
  }
  uint32_t x = s;
  for (int o = 1; o < 32; o <<= 1) {
    uint32_t y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  uint32_t run = x - s;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    cnt[lane * 8 + j] = run;
    run += v[j];
  }
  return __shfl_sync(kFull, x, 31);
}

// Inclusive scan of vals[0, n) in place by the block: each thread sums a
// contiguous chunk in order, the chunk totals are scanned across each warp
// with shuffles and across the warps by warp 0, each chunk adds its offset.
// blockDim.x is a multiple of 32, at most 1024; tsum holds 32 floats.
// Returns the total to all.
__device__ float block_scan_inclusive(float* vals, int n, float* tsum) {
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
    float y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x = __fadd_rn(x, y);
  }
  float excl = __shfl_up_sync(kFull, x, 1);
  if (lane == 0) excl = 0.0f;
  if (lane == 31) tsum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    float t = lane < nw ? tsum[lane] : 0.0f;
    for (int o = 1; o < 32; o <<= 1) {
      float y = __shfl_up_sync(kFull, t, o);
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

// Sum of x over the block in a fixed order (a shuffle tree per warp, then
// the warps in order); red holds 32 floats. Returns the sum to all.
__device__ float block_sum_fixed(float x, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) x = __fadd_rn(x, __shfl_down_sync(kFull, x, o));
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float s = 0.0f;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w)
    s = __fadd_rn(s, red[w]);
  __syncthreads();
  return s;
}

// ---------------------------------------------------------------------------
// t-digest fold: one block per digest row
// ---------------------------------------------------------------------------

constexpr uint32_t kNoRank = 0xFFFFFFFFu;

// Shared bytes of a fold block: W warps of R keys a thread for K + P = n
// entries. Sorting: keys (u32) and entry indices (u16), the warps' digit
// counts and the digit starts; after: sorted means (in the keys' place),
// weights, cumulative weights, cluster ids (in the indices' place) and the
// clusters' first and last entries.
__host__ __device__ inline int fold_smem(int n, int K, int W, int R) {
  const int cap = W * 32 * R;
  return cap * 4 + (W + 1) * kDigits * 4 + n * 8 + K * 8 + cap * 2;
}

template <int R>
__global__ void __launch_bounds__(512, 2) tdigest_fold_kernel(
    float* __restrict__ means, float* __restrict__ weights, int64_t C, int K,
    const int32_t* __restrict__ idx, const float* __restrict__ batch,
    const uint8_t* __restrict__ valid, const float* __restrict__ bweights,
    int P, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float tsum[32];
  __shared__ uint32_t nlive;
  const int64_t r = blockIdx.x;
  const int32_t slot = idx[r];
  if (slot < 0 || slot >= C) return;  // padding row: the whole block
  const int n = K + P;
  const int W = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int cap = W * 32 * R;
  uint32_t* skey = reinterpret_cast<uint32_t*>(smem);     // [cap]
  uint32_t* wcnt_all = skey + cap;                        // [W][256]
  uint32_t* dstart = wcnt_all + W * kDigits;              // [256]
  float* sw = reinterpret_cast<float*>(dstart + kDigits);  // [n] weights
  float* cum = sw + n;                                    // [n]
  int* first = reinterpret_cast<int*>(cum + n);           // [K] first entry
  int* last = first + K;                                  // [K] last entry
  uint16_t* sidx = reinterpret_cast<uint16_t*>(last + K);  // [cap]
  float* sm = reinterpret_cast<float*>(skey);             // sorted means
  uint16_t* cl = sidx;                                    // cluster ids
  uint32_t* wcnt = wcnt_all + warp * kDigits;
  for (int c = threadIdx.x; c < K; c += blockDim.x) {
    first[c] = 0x7FFFFFFF;
    last[c] = -1;
  }

  float* mrow = means + static_cast<int64_t>(slot) * K;
  float* wrow = weights + static_cast<int64_t>(slot) * K;
  const int64_t b0 = r * P;
  auto load = [&](int e, float* m, float* w) {
    if (e < K) {
      *m = mrow[e];
      *w = wrow[e];
    } else {
      *m = batch[b0 + e - K];
      *w = valid ? (valid[b0 + e - K] ? 1.0f : 0.0f) : bweights[b0 + e - K];
    }
  };

  // Four stable passes of 8 bits. Thread (warp, lane) holds the entries
  // warp * 32R + j * 32 + lane, j < R: a warp's entries are a contiguous
  // run in order, so ranking the warps' rounds in turn is stable. Pass 0
  // reads the row, drops the zero-weight entries, and leaves the live ones
  // (nlive of them) compacted at the front.
  // key[j] and, packed, the entry's index (low 16 bits) and its rank
  // within the warp (high 16), or kNoRank for no entry: two registers a
  // key, and no predicate array (Hopper has 7 predicate registers).
  uint32_t key[R], pr[R];
  uint32_t m = static_cast<uint32_t>(n);
  for (int pass = 0; pass < kPasses; ++pass) {
    const int shift = 8 * pass;
    for (int j = lane; j < kDigits; j += 32) wcnt[j] = 0;
    __syncwarp();
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const uint32_t p = warp * 32 * R + j * 32 + lane;
      key[j] = 0;
      pr[j] = kNoRank;
      if (p < m) {
        if (pass == 0) {
          float mv, wv;
          load(static_cast<int>(p), &mv, &wv);
          key[j] = entry_key32(mv, wv);
          if (!(wv == 0.0f)) pr[j] = p;  // NaN weights stay
        } else {
          key[j] = skey[p];
          pr[j] = sidx[p];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const bool live = pr[j] != kNoRank;
      const uint32_t rk = warp_rank((key[j] >> shift) & 0xFF, live, wcnt);
      if (live) pr[j] |= rk << 16;
    }
    __syncthreads();
    for (int d = threadIdx.x; d < kDigits; d += blockDim.x) {
      uint32_t run = 0;
      for (int w = 0; w < W; ++w) {
        const uint32_t c = wcnt_all[w * kDigits + d];
        wcnt_all[w * kDigits + d] = run;
        run += c;
      }
      dstart[d] = run;
    }
    __syncthreads();
    if (warp == 0) {
      const uint32_t t = warp_scan_digits(dstart);
      if (lane == 0) nlive = t;
    }
    __syncthreads();
    m = nlive;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (pr[j] == kNoRank) continue;
      const int d = (key[j] >> shift) & 0xFF;
      const uint32_t pos = dstart[d] + wcnt[d] + (pr[j] >> 16);
      skey[pos] = key[j];
      sidx[pos] = static_cast<uint16_t>(pr[j] & 0xFFFFu);
    }
    __syncthreads();
  }

  // The m live entries in sorted order: means, weights, their scan.
  const int nl = static_cast<int>(m);
  for (int i = threadIdx.x; i < nl; i += blockDim.x) {
    float mv, wv;
    load(sidx[i], &mv, &wv);
    sm[i] = mv;
    sw[i] = wv;
    cum[i] = wv;
  }
  __syncthreads();
  const float total = clamp_total(block_scan_inclusive(cum, nl, tsum));
  const float half_delta = static_cast<float>(K / 2) +
                           (K % 2 ? 0.5f : 0.0f);
  for (int i = threadIdx.x; i < nl; i += blockDim.x) {
    const float w = sw[i];
    cl[i] = static_cast<uint16_t>(
        w > 0.0f ? cluster_of(cum[i], w, total, scale, half_delta, K) : K);
  }
  __syncthreads();
  // Where each cluster's entries start and end in sorted order. The ids
  // are non-decreasing (cumulative weights only grow), so each cluster is
  // one run; where they are not (asinf is not monotone to the last ulp,
  // and weights may be negative or NaN), the range spans the strays.
  for (int i = threadIdx.x; i < nl; i += blockDim.x) {
    const int c = cl[i];
    if (c < K && (i == 0 || cl[i - 1] != c)) atomicMin(&first[c], i);
    if (c < K && (i == nl - 1 || cl[i + 1] != c)) atomicMax(&last[c], i);
  }
  __syncthreads();
  // Cluster c's entries in sorted order, one after another (XLA's
  // sequential segment_sum order).
  for (int c = threadIdx.x; c < K; c += blockDim.x) {
    float ws = 0.0f, ms = 0.0f;
    for (int i = first[c]; i <= last[c]; ++i) {
      if (cl[i] == c) {
        const float w = sw[i];
        ws = __fadd_rn(ws, w);
        ms = __fadd_rn(ms, __fmul_rn(sm[i], w));
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

// rank = leading zeros of the low `bits` bits of h, + 1, where the JAX
// package takes floor(log2(w)) from the float32 exponent of w (frexp - 1):
// w is rounded to float32 first, so a w just under a power of two counts as
// that power, as it does there.
__device__ __forceinline__ int hll_rank(uint32_t w, int bits) {
  if (w == 0) return bits + 1;
  const int lg =
      static_cast<int>(__float_as_uint(__uint2float_rn(w)) >> 23) - 127;
  return bits - lg;
}

// Raise register h >> bits of `row` to the item's rank. The register is
// read through L2 first (where the atomics resolve; L1 is not coherent
// with them) and the atomic is skipped when the rank raises nothing: a
// re-fold of values already seen costs one load. Registers only grow
// during the launch, so a stale read can only cost an atomic, never lose
// one.
__device__ __forceinline__ void hll_raise(int32_t* __restrict__ row,
                                          int32_t item, int bits) {
  const uint32_t h = hash32(static_cast<uint32_t>(item));
  const int rank = hll_rank(h & ((1u << bits) - 1u), bits);
  int32_t* r = row + (h >> bits);
  if (__ldcg(r) < rank) atomicMax(r, rank);
}

constexpr int kFoldThreads = 256;  // 4 items a thread, 1,024 a block

// The [H, U] items as one flat run of n = H * U; thread t takes items
// 4t .. 4t + 3. With kVec (U % 4 == 0, items 16-byte and the mask 4-byte
// aligned) the four lie in one row and come in one 16-byte and one 4-byte
// load, issued with the row's slot before any is used.
template <bool kVec>
__global__ void __launch_bounds__(kFoldThreads)
hll_fold_kernel(int32_t* __restrict__ regs, int64_t C, int p,
                const int32_t* __restrict__ idx,
                const int32_t* __restrict__ items,
                const uint8_t* __restrict__ valid, int64_t U, int64_t n) {
  const int64_t j0 =
      (static_cast<int64_t>(blockIdx.x) * kFoldThreads + threadIdx.x) * 4;
  if (j0 >= n) return;
  const int bits = 32 - p;
  if (kVec) {
    const int32_t slot = __ldg(idx + j0 / U);
    const uint32_t ok = __ldg(reinterpret_cast<const uint32_t*>(valid + j0));
    const int4 it = __ldg(reinterpret_cast<const int4*>(items + j0));
    if (slot < 0 || slot >= C || ok == 0) return;
    int32_t* row = regs + (static_cast<int64_t>(slot) << p);
    if (ok & 0xFFu) hll_raise(row, it.x, bits);
    if (ok & 0xFF00u) hll_raise(row, it.y, bits);
    if (ok & 0xFF0000u) hll_raise(row, it.z, bits);
    if (ok & 0xFF000000u) hll_raise(row, it.w, bits);
  } else {
    for (int64_t j = j0; j < j0 + 4 && j < n; ++j) {
      const int32_t slot = idx[j / U];
      if (slot < 0 || slot >= C || !valid[j]) continue;
      hll_raise(regs + (static_cast<int64_t>(slot) << p), items[j], bits);
    }
  }
}

// One term of the estimate's sum, 2^-r, counted exactly as 2^(33 - r) in
// 64 bits for r in [0, 33] (every register a fold writes: ranks reach at
// most 32 - p + 1 = 29), below 2^63 over a row of m <= 2^30. Any other
// value, which only a caller's own registers can hold, adds 2^-r in
// float32.
__device__ __forceinline__ void hll_term(int32_t r, unsigned long long& s,
                                         float& rest, int& zeros) {
  if (static_cast<uint32_t>(r) <= 33u)
    s += 1ull << (33 - r);
  else
    rest = __fadd_rn(rest, exp2f(-static_cast<float>(r)));
  zeros += (r == 0);
}

// One block a row: 16-byte loads, four a thread, each thread's sums
// reduced by shuffles within its warp and the warps' through shared memory
// after one barrier. The integer parts are order-free; the float32 rest is
// summed in a fixed tree, so a row's estimate is the same on every run.
__global__ void __launch_bounds__(1024)
hll_estimate_kernel(const int32_t* __restrict__ regs, int m, float amm,
                    float* __restrict__ out) {
  __shared__ unsigned long long ws[32];
  __shared__ float wr[32];
  __shared__ int wz[32];
  const int4* row = reinterpret_cast<const int4*>(
      regs + static_cast<int64_t>(blockIdx.x) * m);
  unsigned long long s = 0;
  float rest = 0.0f;
  int zeros = 0;
#pragma unroll 4
  for (int i = threadIdx.x; i < m / 4; i += blockDim.x) {
    const int4 v = __ldg(row + i);
    hll_term(v.x, s, rest, zeros);
    hll_term(v.y, s, rest, zeros);
    hll_term(v.z, s, rest, zeros);
    hll_term(v.w, s, rest, zeros);
  }
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(kFull, s, off);
    rest = __fadd_rn(rest, __shfl_xor_sync(kFull, rest, off));
    zeros += __shfl_xor_sync(kFull, zeros, off);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    ws[warp] = s;
    wr[warp] = rest;
    wz[warp] = zeros;
  }
  __syncthreads();
  if (warp != 0) return;
  const bool have = lane < static_cast<int>(blockDim.x / 32);
  s = have ? ws[lane] : 0;
  rest = have ? wr[lane] : 0.0f;
  zeros = have ? wz[lane] : 0;
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(kFull, s, off);
    rest = __fadd_rn(rest, __shfl_xor_sync(kFull, rest, off));
    zeros += __shfl_xor_sync(kFull, zeros, off);
  }
  if (lane != 0) return;
  // The tail in the JAX function's float32 operations and order.
  // 2^-33 scales the exact sum without rounding.
  const float inv =
      __fadd_rn(__fmul_rn(__ull2float_rn(s), 1.16415321826934814453125e-10f),
                rest);
  const float fm = static_cast<float>(m);
  const float raw = __fdiv_rn(amm, inv);
  const float fz = static_cast<float>(zeros);
  const float small = __fmul_rn(fm, logf(__fdiv_rn(fm, fmaxf(fz, 1.0f))));
  float est = (raw <= 2.5f * fm && fz > 0.0f) ? small : raw;
  const float two32 = 4294967296.0f;
  if (est > __fdiv_rn(two32, 30.0f))
    est = __fmul_rn(-two32, log1pf(__fdiv_rn(-est, two32)));
  out[blockIdx.x] = est;
}

// Nothing: the launch floor of this card through the wrappers' path.
__global__ void empty_kernel() {}

// ---------------------------------------------------------------------------
// Merged quantile: radix sort of the live entries, scan, cluster sums,
// interpolation
// ---------------------------------------------------------------------------

constexpr int kSortTile = 2048;     // entries a radix block ranks
constexpr int kSortThreads = 256;   // 8 warps, 8 rounds of 32 each
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kSortRounds = kSortTile / kSortThreads;
constexpr int kSortBlocks = 512;   // blocks of a scatter launch
constexpr int kCountSplit = 4;     // count blocks per scatter block
constexpr int kScanTile = 2048;     // sorted entries a scan / bin block takes
constexpr int kScanThreads = 256;
constexpr int kFinalThreads = 1024;

struct MqEntry {
  const float* means;
  const float* weights;
  int K;
  const int32_t* idx;
  const uint8_t* valid;
};

// Entry p of the flat [S * K] selection, in index order. False when it
// weighs zero: a row where valid is false, or a weight of +0.0 or -0.0.
__device__ __forceinline__ bool mq_input(const MqEntry& e, int64_t p,
                                         uint32_t* key, float2* mw) {
  const uint32_t pp = static_cast<uint32_t>(p);  // n < 2^32
  const uint32_t s = pp / static_cast<uint32_t>(e.K);
  if (!e.valid[s]) return false;
  const int64_t off = static_cast<int64_t>(e.idx[s]) * e.K +
                      (pp - s * static_cast<uint32_t>(e.K));
  const float w = e.weights[off];
  if (w == 0.0f) return false;  // NaN weights stay
  const float m = e.means[off];
  *key = entry_key32(m, w);
  *mw = make_float2(m, w);
  return true;
}

// The length pass `pass` sorts: the n input entries, then the live ones.
__device__ __forceinline__ int64_t mq_len(int pass, int64_t n,
                                          const uint32_t* nlive) {
  return pass == 0 ? n : static_cast<int64_t>(*nlive);
}

// The tiles [*t0, *t1) of scatter block b: the len entries cut into
// tiles of kSortTile, dealt out in order, an equal run to each of
// kSortBlocks.
__device__ __forceinline__ void mq_tiles(int64_t len, int b, int64_t* t0,
                                         int64_t* t1) {
  const int64_t tiles = (len + kSortTile - 1) / kSortTile;
  const int64_t per = (tiles + kSortBlocks - 1) / kSortBlocks;
  const int64_t a = static_cast<int64_t>(b) * per;
  *t0 = a < tiles ? a : tiles;
  *t1 = a + per < tiles ? a + per : tiles;
}

// Per scatter block b, its count of each digit over its tiles, from
// kCountSplit count blocks (tiles dealt out in turn; one histogram a warp
// in shared memory, then summed) adding into hist[d * kSortBlocks + b],
// zeroed beforehand; the digit totals added into dtot.
__global__ void __launch_bounds__(kSortThreads) mq_count_kernel(
    MqEntry e, const uint32_t* __restrict__ keys, int pass, int64_t n,
    const uint32_t* __restrict__ nlive, uint32_t* __restrict__ hist,
    uint32_t* __restrict__ dtot) {
  __shared__ uint32_t h[kSortWarps][kDigits];
  for (int i = threadIdx.x; i < kSortWarps * kDigits; i += blockDim.x)
    h[i / kDigits][i % kDigits] = 0;
  __syncthreads();
  const int64_t len = mq_len(pass, n, nlive);
  const int b = blockIdx.x / kCountSplit;
  int64_t t0, t1;
  mq_tiles(len, b, &t0, &t1);
  const int shift = 8 * pass;
  uint32_t* wh = h[threadIdx.x >> 5];
  for (int64_t t = t0 + blockIdx.x % kCountSplit; t < t1; t += kCountSplit) {
    const int64_t hi = (t + 1) * kSortTile < len ? (t + 1) * kSortTile : len;
    for (int64_t p = t * kSortTile + threadIdx.x; p < hi; p += blockDim.x) {
      uint32_t key = 0;
      float2 mw;
      const bool live = pass == 0 ? mq_input(e, p, &key, &mw) : true;
      if (pass != 0) key = keys[p];
      if (live) atomicAdd(&wh[(key >> shift) & 0xFF], 1u);
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < kDigits; d += blockDim.x) {
    uint32_t c = 0;
    for (int w = 0; w < kSortWarps; ++w) c += h[w][d];
    if (c) {
      atomicAdd(&hist[d * kSortBlocks + b], c);
      atomicAdd(&dtot[d], c);
    }
  }
}

// Block d: the exclusive offsets of digit d in each count block, in
// place: the counts of the smaller digits, then digit d's counts in the
// blocks before. Pass 0 also stores the number of live entries.
__global__ void __launch_bounds__(kSortBlocks) mq_scan_digits_kernel(
    uint32_t* __restrict__ hist, const uint32_t* __restrict__ dtot,
    uint32_t* __restrict__ nlive) {
  __shared__ uint32_t wsum[32];
  __shared__ uint32_t base_s;
  const int d = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  if (warp == 0) {
    uint32_t b = 0;
    for (int j = lane; j < d; j += 32) b += dtot[j];
    for (int o = 16; o > 0; o >>= 1) b += __shfl_down_sync(kFull, b, o);
    if (lane == 0) {
      base_s = b;
      if (nlive && d == kDigits - 1) *nlive = b + dtot[d];
    }
  }
  uint32_t* col = hist + d * kSortBlocks;
  const uint32_t v = col[threadIdx.x];  // blockDim.x == kSortBlocks
  uint32_t x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    uint32_t t = lane < nw ? wsum[lane] : 0u;
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, t, o);
      if (lane >= o) t += y;
    }
    if (lane < nw) wsum[lane] = t;  // inclusive over the warps
  }
  __syncthreads();
  col[threadIdx.x] = base_s + (warp ? wsum[warp - 1] : 0u) + x - v;
}

// Per block, its tiles in order: the stable rank of each live entry among
// the tile's entries of its digit (warps in tile order, each ranking its
// rounds in turn with __match_any_sync), the tile staged in shared memory
// in digit order and written out as runs after the block's entries of the
// same digit in earlier tiles. Keys are not written on the last pass
// (kdst null): only the payload is read after it.
__global__ void __launch_bounds__(kSortThreads) mq_scatter_kernel(
    MqEntry e, int pass, const uint32_t* __restrict__ ksrc,
    const float2* __restrict__ vsrc, uint32_t* __restrict__ kdst,
    float2* __restrict__ vdst, int64_t n,
    const uint32_t* __restrict__ nlive, const uint32_t* __restrict__ hist) {
  __shared__ uint32_t wcnt_all[kSortWarps][kDigits];
  __shared__ uint32_t dstart[kDigits];
  __shared__ uint32_t run[kDigits];  // where the next entry of d goes
  __shared__ uint32_t sk[kSortTile];
  __shared__ float2 sv[kSortTile];
  __shared__ uint32_t tile_live;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t len = mq_len(pass, n, nlive);
  int64_t t0, t1;
  mq_tiles(len, blockIdx.x, &t0, &t1);
  if (t0 >= t1) return;  // the whole block
  for (int d = threadIdx.x; d < kDigits; d += blockDim.x)
    run[d] = hist[d * kSortBlocks + blockIdx.x];
  uint32_t* wcnt = wcnt_all[warp];
  const int shift = 8 * pass;
  for (int64_t t = t0; t < t1; ++t) {
    const int64_t base = t * kSortTile;
    for (int j = lane; j < kDigits; j += 32) wcnt[j] = 0;
    __syncwarp();
    uint32_t key[kSortRounds], rank[kSortRounds];  // kNoRank: no entry
    float2 val[kSortRounds];
#pragma unroll
    for (int j = 0; j < kSortRounds; ++j) {
      const int64_t p = base + warp * 32 * kSortRounds + j * 32 + lane;
      key[j] = 0;
      rank[j] = kNoRank;
      if (p < len) {
        if (pass == 0) {
          if (mq_input(e, p, &key[j], &val[j])) rank[j] = 0;
        } else {
          key[j] = ksrc[p];
          val[j] = vsrc[p];
          rank[j] = 0;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kSortRounds; ++j) {
      const bool live = rank[j] != kNoRank;
      const uint32_t rk = warp_rank((key[j] >> shift) & 0xFF, live, wcnt);
      if (live) rank[j] = rk;
    }
    __syncthreads();
    for (int d = threadIdx.x; d < kDigits; d += blockDim.x) {
      uint32_t r = 0;
      for (int w = 0; w < kSortWarps; ++w) {
        const uint32_t c = wcnt_all[w][d];
        wcnt_all[w][d] = r;
        r += c;
      }
      dstart[d] = r;
    }
    __syncthreads();
    if (warp == 0) {
      const uint32_t tl = warp_scan_digits(dstart);
      if (lane == 0) tile_live = tl;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kSortRounds; ++j) {
      if (rank[j] == kNoRank) continue;
      const int d = (key[j] >> shift) & 0xFF;
      const uint32_t pos = dstart[d] + wcnt[d] + rank[j];
      sk[pos] = key[j];
      sv[pos] = val[j];
    }
    __syncthreads();
    const int cnt = static_cast<int>(tile_live);
    for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
      const uint32_t k = sk[i];
      const int d = (k >> shift) & 0xFF;
      const int64_t g = static_cast<int64_t>(run[d]) + (i - dstart[d]);
      if (kdst) kdst[g] = k;
      vdst[g] = sv[i];
    }
    __syncthreads();
    for (int d = threadIdx.x; d < kDigits; d += blockDim.x)
      run[d] += (d + 1 < kDigits ? dstart[d + 1] : tile_live) - dstart[d];
  }
}

// The sorted weights of one scan tile, scanned as mq_bins_kernel scans
// them; its total out.
__global__ void __launch_bounds__(kScanThreads) mq_tile_totals_kernel(
    const float2* __restrict__ v, const uint32_t* __restrict__ nlive,
    float* __restrict__ tile_total) {
  __shared__ float vals[kScanTile];
  __shared__ float tsum[32];
  const int64_t m = *nlive;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kScanTile;
  if (base >= m) return;
  const int cnt = static_cast<int>(m - base < kScanTile ? m - base
                                                         : kScanTile);
  for (int i = threadIdx.x; i < cnt; i += blockDim.x) vals[i] = v[base + i].y;
  __syncthreads();
  const float total = block_scan_inclusive(vals, cnt, tsum);
  if (threadIdx.x == 0) tile_total[blockIdx.x] = total;
}

// Per scan tile: its offset (the tiles before, summed in a fixed order)
// and the grand total, the tile's inclusive scan, each entry's cluster,
// then one warp a cluster in the tile's range: lanes sum every 32nd entry
// in order, a fixed shuffle tree joins them. partial[c][tile] = (weight
// sum, mean * weight sum), zero for the clusters the tile does not touch;
// a cluster's row holds nt tiles.
__global__ void __launch_bounds__(kScanThreads) mq_bins_kernel(
    const float2* __restrict__ v, const uint32_t* __restrict__ nlive,
    const float* __restrict__ tile_total, int delta, float scale,
    float half_delta, int64_t nt, float2* __restrict__ partial) {
  __shared__ float sm[kScanTile];
  __shared__ float sw[kScanTile];
  __shared__ float cum[kScanTile];
  __shared__ int scl[kScanTile];
  __shared__ float red[32];
  __shared__ int crange[2];
  const int64_t m = *nlive;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kScanTile;
  if (base >= m) return;
  const int cnt = static_cast<int>(m - base < kScanTile ? m - base
                                                         : kScanTile);
  const int64_t ntiles = (m + kScanTile - 1) / kScanTile;
  float before = 0.0f, all = 0.0f;
  for (int64_t j = threadIdx.x; j < ntiles; j += blockDim.x) {
    const float x = tile_total[j];
    if (j < static_cast<int64_t>(blockIdx.x)) before = __fadd_rn(before, x);
    all = __fadd_rn(all, x);
  }
  const float off = block_sum_fixed(before, red);
  const float total = clamp_total(block_sum_fixed(all, red));
  if (threadIdx.x == 0) {
    crange[0] = delta;
    crange[1] = -1;
  }
  for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
    const float2 x = v[base + i];
    sm[i] = x.x;
    sw[i] = x.y;
    cum[i] = x.y;
  }
  __syncthreads();
  block_scan_inclusive(cum, cnt, red);
  int lo = delta, hi = -1;
  for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
    const float w = sw[i];
    int c = delta;
    if (w > 0.0f) {
      c = cluster_of(__fadd_rn(cum[i], off), w, total, scale, half_delta,
                     delta);
      lo = min(lo, c);
      hi = max(hi, c);
    }
    scl[i] = c;
  }
  atomicMin(&crange[0], lo);
  atomicMax(&crange[1], hi);
  __syncthreads();
  const int c0 = crange[0], c1 = crange[1];
  float2* out = partial + blockIdx.x;
  for (int c = threadIdx.x; c < delta; c += blockDim.x)
    if (c < c0 || c > c1) out[c * nt] = make_float2(0.0f, 0.0f);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int c = c0 + warp; c <= c1; c += nwarps) {
    float ws = 0.0f, ms = 0.0f;
    for (int i = lane; i < cnt; i += 32) {
      if (scl[i] == c) {
        ws = __fadd_rn(ws, sw[i]);
        ms = __fadd_rn(ms, __fmul_rn(sm[i], sw[i]));
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      ws = __fadd_rn(ws, __shfl_down_sync(kFull, ws, o));
      ms = __fadd_rn(ms, __shfl_down_sync(kFull, ms, o));
    }
    if (lane == 0) out[c * nt] = make_float2(ws, ms);
  }
}

// One block: the delta clusters' sums over the tiles (8 threads a
// cluster take the tiles in turn, a fixed shuffle tree joins them), the
// centroids sorted as
// tdigest_quantile sorts them, the quantiles. With digest, the merged
// digest's means and weights are stored there too ([2, delta]).
__global__ void __launch_bounds__(kFinalThreads) mq_final_kernel(
    const float2* __restrict__ partial, int64_t nt,
    const uint32_t* __restrict__ nlive, int delta,
    const float* __restrict__ q, int Q, float* __restrict__ out,
    float* __restrict__ digest) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* key = reinterpret_cast<uint64_t*>(smem);  // [delta] sort keys
  float* cm = reinterpret_cast<float*>(key + delta);  // cluster means
  float* cw = cm + delta;                             // cluster weights
  float* sm = cw + delta;                             // sorted means
  float* sw = sm + delta;                             // sorted weights
  float* centers = sw + delta;                        // [delta]
  __shared__ int nreal_s;
  const int64_t ntiles = (static_cast<int64_t>(*nlive) + kScanTile - 1) /
                         kScanTile;
  const int sub = threadIdx.x & 7;
  // Every thread of a warp runs the same number of rounds (blockDim.x is
  // a multiple of 32), so the shuffles see whole warps.
  for (int c0 = 0; c0 < delta; c0 += blockDim.x >> 3) {
    const int c = c0 + (threadIdx.x >> 3);
    float ws = 0.0f, ms = 0.0f;
    if (c < delta) {
#pragma unroll 4
      for (int64_t t = sub; t < ntiles; t += 8) {
        const float2 v = partial[c * nt + t];
        ws = __fadd_rn(ws, v.x);
        ms = __fadd_rn(ms, v.y);
      }
    }
    for (int o = 4; o > 0; o >>= 1) {
      ws = __fadd_rn(ws, __shfl_down_sync(kFull, ws, o));
      ms = __fadd_rn(ms, __shfl_down_sync(kFull, ms, o));
    }
    if (sub == 0 && c < delta) {
      const float mean = ws > 0.0f ? __fdiv_rn(ms, fmaxf(ws, kTiny)) : 0.0f;
      cm[c] = mean;
      cw[c] = ws;
      key[c] = entry_key(mean, ws, static_cast<uint32_t>(c));
      if (digest) {
        digest[c] = mean;
        digest[delta + c] = ws;
      }
    }
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

// Scratch of the merged quantile for n = S * K entries: keys and payloads
// in two buffers each (the passes alternate), each pass's digit counts
// per scatter block, the digit totals of each pass and the live count,
// the scan tiles' totals and their cluster sums.
struct MqLayout {
  int64_t nt, keys[2], vals[2], hist, dtot, tile_total, partial, bytes;
};

__host__ MqLayout mq_layout(int64_t n, int delta) {
  auto up = [](int64_t b) { return (b + 255) & ~int64_t(255); };
  MqLayout l;
  l.nt = (n + kScanTile - 1) / kScanTile;
  int64_t at = 0;
  for (int b = 0; b < 2; ++b) {
    l.vals[b] = at;
    at += up(n * 8);
    l.keys[b] = at;
    at += up(n * 4);
  }
  l.hist = at;  // one region a pass, then dtot: one memset zeroes both
  at += kPasses * kSortBlocks * kDigits * 4;
  l.dtot = at;
  at += up((kPasses * kDigits + 1) * 4);
  l.tile_total = at;
  at += up(l.nt * 4);
  l.partial = at;
  at += up(l.nt * delta * 8);
  l.bytes = at;
  return l;
}

cudaError_t set_smem(const void* fn, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <int R>
int launch_fold(float* means, float* weights, int64_t C, int K,
                const int32_t* idx, int64_t rows, const float* batch,
                const uint8_t* valid, const float* bweights, int P,
                cudaStream_t stream) {
  const int n = K + P;
  const int W = (n + 32 * R - 1) / (32 * R);
  const int smem = fold_smem(n, K, W, R);
  cudaError_t err = set_smem(
      reinterpret_cast<const void*>(tdigest_fold_kernel<R>), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = static_cast<float>(K) / kPiF;
  tdigest_fold_kernel<R><<<static_cast<unsigned>(rows), W * 32, smem,
                           stream>>>(means, weights, C, K, idx, batch, valid,
                                     bweights, P, scale);
  return static_cast<int>(cudaGetLastError());
}

int mq_run(const float* means, const float* weights, int K,
           const int32_t* idx, const uint8_t* valid, int64_t S,
           const float* q, int Q, int delta, void* scratch,
           int64_t scratch_bytes, float* out, float* digest,
           cudaStream_t stream) {
  const int64_t n = S * K;
  if (n <= 0 || n >= (int64_t(1) << 32) || delta <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  MqLayout l = mq_layout(n, delta);
  if (scratch_bytes < l.bytes) return static_cast<int>(cudaErrorInvalidValue);
  unsigned char* base = static_cast<unsigned char*>(scratch);
  uint32_t* keys[2];
  float2* vals[2];
  for (int b = 0; b < 2; ++b) {
    keys[b] = reinterpret_cast<uint32_t*>(base + l.keys[b]);
    vals[b] = reinterpret_cast<float2*>(base + l.vals[b]);
  }
  uint32_t* hist = reinterpret_cast<uint32_t*>(base + l.hist);
  uint32_t* dtot = reinterpret_cast<uint32_t*>(base + l.dtot);
  uint32_t* nlive = dtot + kPasses * kDigits;
  float* tile_total = reinterpret_cast<float*>(base + l.tile_total);
  float2* partial = reinterpret_cast<float2*>(base + l.partial);
  MqEntry e{means, weights, K, idx, valid};
  const float scale = static_cast<float>(delta) / kPiF;
  const float half_delta = static_cast<float>(delta / 2) +
                           (delta % 2 ? 0.5f : 0.0f);
  const unsigned nt = static_cast<unsigned>(l.nt);
  cudaError_t err = cudaMemsetAsync(hist, 0, l.tile_total - l.hist,
                                    stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Pass p writes buffer p & 1; pass 0 reads the digests themselves.
  for (int pass = 0; pass < kPasses; ++pass) {
    const int src = (pass + 1) & 1, dst = pass & 1;
    uint32_t* tot = dtot + pass * kDigits;
    uint32_t* ph = hist + pass * kSortBlocks * kDigits;
    mq_count_kernel<<<kSortBlocks * kCountSplit, kSortThreads, 0, stream>>>(
        e, keys[src], pass, n, nlive, ph, tot);
    mq_scan_digits_kernel<<<kDigits, kSortBlocks, 0, stream>>>(
        ph, tot, pass == 0 ? nlive : nullptr);
    mq_scatter_kernel<<<kSortBlocks, kSortThreads, 0, stream>>>(
        e, pass, keys[src], vals[src],
        pass == kPasses - 1 ? nullptr : keys[dst], vals[dst], n, nlive,
        ph);
  }
  const float2* sorted = vals[(kPasses - 1) & 1];
  mq_tile_totals_kernel<<<nt, kScanThreads, 0, stream>>>(sorted, nlive,
                                                         tile_total);
  mq_bins_kernel<<<nt, kScanThreads, 0, stream>>>(
      sorted, nlive, tile_total, delta, scale, half_delta, l.nt, partial);
  const int fsmem = delta * 8 + delta * 5 * 4;
  err = set_smem(reinterpret_cast<const void*>(mq_final_kernel), fsmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  mq_final_kernel<<<1, kFinalThreads, fsmem, stream>>>(
      partial, l.nt, nlive, delta, q, Q, out, digest);
  return static_cast<int>(cudaGetLastError());
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
  if (K <= 0 || P < 0 || n > 16 * 32 * 16)
    return static_cast<int>(cudaErrorInvalidValue);
  // The fewest keys a thread that keep the block within 16 warps.
  if (n <= 16 * 32 * 4)
    return launch_fold<4>(means, weights, C, K, idx, R, batch, valid,
                          bweights, P, stream);
  if (n <= 16 * 32 * 8)
    return launch_fold<8>(means, weights, C, K, idx, R, batch, valid,
                          bweights, P, stream);
  return launch_fold<16>(means, weights, C, K, idx, R, batch, valid,
                         bweights, P, stream);
}

// Fold item row r (U int32 items, valid[r, j]) into register row idx[r] of
// the [C, 2^p] stack, in place; rows with idx outside [0, C) are skipped,
// and a slot named by several rows takes the max over all of them.
int hll_fold_i32(int32_t* regs, int64_t C, int32_t p, const int32_t* idx,
                 int64_t H, const int32_t* items, const uint8_t* valid,
                 int32_t U, cudaStream_t stream) {
  const int64_t n = H * U;
  if (n <= 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((n + 4 * kFoldThreads - 1) / (4 * kFoldThreads));
  const bool vec = U % 4 == 0 && reinterpret_cast<uintptr_t>(items) % 16 == 0
                   && reinterpret_cast<uintptr_t>(valid) % 4 == 0;
  if (vec)
    hll_fold_kernel<true><<<blocks, kFoldThreads, 0, stream>>>(
        regs, C, p, idx, items, valid, U, n);
  else
    hll_fold_kernel<false><<<blocks, kFoldThreads, 0, stream>>>(
        regs, C, p, idx, items, valid, U, n);
  return static_cast<int>(cudaGetLastError());
}

// One float32 estimate per [m] register row (m = 2^p, 16 <= m <= 2^30);
// regs 16-byte aligned.
int hll_estimate_f32(const int32_t* regs, int64_t R, int32_t m, float* out,
                     cudaStream_t stream) {
  if (R <= 0) return 0;
  if (m < 16 || m > (1 << 30) || (m & (m - 1)) != 0
      || reinterpret_cast<uintptr_t>(regs) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // Four 16-byte loads a thread, from one warp (m = 16) to 32.
  const int threads = m / 16 < 32 ? 32 : (m / 16 > 1024 ? 1024 : m / 16);
  const double alpha = 0.7213 / (1.0 + 1.079 / m);
  hll_estimate_kernel<<<static_cast<unsigned>(R), threads, 0, stream>>>(
      regs, m, static_cast<float>(alpha * m * m), out);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel on `stream`: the launch floor, for measurements.
int empty_launch(cudaStream_t stream) {
  empty_kernel<<<1, 32, 0, stream>>>();
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
  if (Q <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return mq_run(means, weights, K, idx, valid, S, q, Q, delta, scratch,
                scratch_bytes, out, nullptr, stream);
}

// The merged digest itself, for tests: digest[0, :] its delta means,
// digest[1, :] its weights (the same launches, no quantiles).
int tdigest_merged_digest_f32(const float* means, const float* weights,
                              int32_t K, const int32_t* idx,
                              const uint8_t* valid, int64_t S, int32_t delta,
                              void* scratch, int64_t scratch_bytes,
                              float* digest, cudaStream_t stream) {
  return mq_run(means, weights, K, idx, valid, S, nullptr, 0, delta,
                scratch, scratch_bytes, nullptr, digest, stream);
}

}  // extern "C"
