// Batched TSST4 block decode, hand-written for Hopper (sm_90a). Built by
// opentsdb_tpu_torch/ops/cuda_build.py with nvcc into a shared library
// with a plain C interface, loaded through ctypes; the wrapper lives in
// opentsdb_tpu_torch/ops/block_decode.py beside its plain PyTorch version.
//
// What it replaces. opentsdb_tpu/compress/kernels.py decode_points (with
// _varbytes_u32, _unzigzag32 and _seg_cumsum), the XLA function under the
// fused decode-plus-aggregate plan: it turns the concatenated payload
// streams of whole TSST4 blocks into per-point qualifier deltas (rel_ts)
// and float32 values. Per point: a big-endian varbyte gather (nb <= 4
// significant bytes at an offset that is the exclusive prefix sum of nb),
// an unzigzag, and two segmented int32 cumsums (c[i] - c[first_idx[i]-1])
// that rebuild the qualifier deltas from delta-of-delta entries. Values:
// TSF32 undoes an XOR chain (an XOR scan re-based at each block start,
// then a bitcast, so NaN patterns pass through untouched); TSINT undoes a
// zigzag-delta chain (one segmented int32 cumsum, then __int2float_rn).
// Every output equals the JAX function's bit for bit, padding points
// included: the sums wrap in uint32 exactly as XLA's int32 cumsum does
// (signed overflow is undefined in C++, so nothing here adds signed
// ints), and indices clamp as XLA's gathers clamp.
//
// What bounds it: bytes. Each point takes a few integer operations, far
// below the card's rate; the floor is the inputs read once and the
// outputs written once (ts_nb, v_nb, first_idx, blk_first, rel_base, the
// payloads; rel_ts and vals) over 3.35 TB/s.
//
// Design: the plainest faithful one, three device-wide scans, each in
// three phases (tile aggregates, an exclusive scan of the aggregates in
// one block, then each tile rescanned with its carried-in prefix):
//   1. (ts_nb, v_nb), add: the byte offsets. Its tile pass gathers the
//      varbytes and writes the unzigzagged timestamp entry and the value
//      word (unzigzagged for TSINT) to scratch.
//   2. (entry, value word), (add, add or xor): in place, the inclusive
//      scans C and W.
//   3. steps[i] = C[i] - C[first_idx[i]-1], add: into a second scratch S.
// A last pass writes rel_ts = rel_base + S[i] - S[first_idx[i]-1] and the
// values from W. A one-block-a-CTA design would be tempting (the chains
// never cross blocks), but padding points of the byte-stream leg carry
// first_idx = blk_first = 0 and so decode against the global prefix, as
// in the JAX formulation; the device-wide scans reproduce that. Each
// thread scans kItems consecutive points, and the block scans the thread
// aggregates in shared memory. Ten launches per call on one stream; the
// scratch (3 words a point and one pair a tile) comes from the wrapper.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;  // consecutive points per thread
constexpr int kTile = kThreads * kItems;
constexpr int kScanThreads = 1024;  // the aggregate scan's one block

struct Add {
  static __device__ __forceinline__ uint32_t op(uint32_t a, uint32_t b) {
    return a + b;
  }
};

struct Xor {
  static __device__ __forceinline__ uint32_t op(uint32_t a, uint32_t b) {
    return a ^ b;
  }
};

template <class Op0, class Op1>
__device__ __forceinline__ uint2 combine(uint2 a, uint2 b) {
  return make_uint2(Op0::op(a.x, b.x), Op1::op(a.y, b.y));
}

// Exclusive scan of one pair a thread over the block, in shared memory
// (Hillis-Steele over blockDim.x entries). Returns the thread's exclusive
// prefix; *total gets the block's aggregate.
template <class Op0, class Op1>
__device__ uint2 block_exclusive(uint2 v, uint2* sh, uint2* total) {
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  sh[t] = v;
  __syncthreads();
  for (int d = 1; d < nt; d <<= 1) {
    const uint2 add = t >= d ? sh[t - d] : make_uint2(0u, 0u);
    __syncthreads();
    sh[t] = combine<Op0, Op1>(sh[t], add);
    __syncthreads();
  }
  *total = sh[nt - 1];
  __syncthreads();
  return t == 0 ? make_uint2(0u, 0u) : sh[t - 1];
}

// Phase 1: each tile's aggregate.
template <class Op0, class Op1, class Elem>
__global__ void __launch_bounds__(kThreads)
    tile_reduce(Elem elem, int64_t n, uint2* tile_sums) {
  __shared__ uint2 sh[kThreads];
  const int64_t base = (int64_t)blockIdx.x * kTile + (int64_t)threadIdx.x *
                                                          kItems;
  uint2 acc = make_uint2(0u, 0u);
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + k;
    if (i < n) acc = combine<Op0, Op1>(acc, elem(i));
  }
  uint2 total;
  block_exclusive<Op0, Op1>(acc, sh, &total);
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = total;
}

// Phase 2: exclusive scan of the tile aggregates, in place, in one block.
template <class Op0, class Op1>
__global__ void __launch_bounds__(kScanThreads)
    scan_tiles(uint2* tile_sums, int64_t ntiles) {
  __shared__ uint2 sh[kScanThreads];
  const int64_t per = (ntiles + kScanThreads - 1) / kScanThreads;
  const int64_t lo = (int64_t)threadIdx.x * per;
  const int64_t hi = lo + per < ntiles ? lo + per : ntiles;
  uint2 acc = make_uint2(0u, 0u);
  for (int64_t i = lo; i < hi; ++i) acc = combine<Op0, Op1>(acc, tile_sums[i]);
  uint2 total;
  uint2 run = block_exclusive<Op0, Op1>(acc, sh, &total);
  for (int64_t i = lo; i < hi; ++i) {
    const uint2 v = tile_sums[i];
    tile_sums[i] = run;
    run = combine<Op0, Op1>(run, v);
  }
}

// Phase 3: each tile rescanned from its carried-in prefix; out(i, incl,
// elem) gets every point's inclusive prefix and its own element.
template <class Op0, class Op1, class Elem, class Out>
__global__ void __launch_bounds__(kThreads)
    tile_scan(Elem elem, Out out, int64_t n, const uint2* tile_prefix) {
  __shared__ uint2 sh[kThreads];
  const int64_t base = (int64_t)blockIdx.x * kTile + (int64_t)threadIdx.x *
                                                          kItems;
  uint2 e[kItems];
  uint2 acc = make_uint2(0u, 0u);
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + k;
    e[k] = i < n ? elem(i) : make_uint2(0u, 0u);
    acc = combine<Op0, Op1>(acc, e[k]);
  }
  uint2 total;
  uint2 run = combine<Op0, Op1>(tile_prefix[blockIdx.x],
                                block_exclusive<Op0, Op1>(acc, sh, &total));
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + k;
    run = combine<Op0, Op1>(run, e[k]);
    if (i < n) out(i, run, e[k]);
  }
}

__device__ __forceinline__ uint32_t unzigzag(uint32_t z) {
  return (z >> 1) ^ (0u - (z & 1u));
}

// The nb significant big-endian bytes at off (nb == 0 -> 0). Indices clamp
// to [0, len - 1] as the JAX gather's do; an empty payload reads nothing.
// Only the first four bytes count, and a byte whose shift would reach 32
// bits contributes 0, as XLA's shifts do.
__device__ __forceinline__ uint32_t varbytes(const uint8_t* pay, int64_t len,
                                             uint32_t off, int32_t nb) {
  uint32_t out = 0u;
  for (int j = 0; j < 4; ++j) {
    if (j >= nb) break;
    int64_t idx = (int64_t)(int32_t)(off + (uint32_t)j);
    idx = idx < 0 ? 0 : (idx > len - 1 ? len - 1 : idx);
    const uint32_t byte = len > 0 ? (uint32_t)pay[idx] : 0u;
    const uint32_t shift = (uint32_t)(nb - 1 - j) * 8u;
    out |= shift < 32u ? byte << shift : 0u;
  }
  return out;
}

// first_idx / blk_first index the prefix array [0, c...] of n + 1 entries:
// clamped to [0, n], as XLA clamps the gather. Returns c[idx - 1], 0 at 0.
__device__ __forceinline__ uint32_t before(const uint32_t* c, int32_t idx,
                                           int64_t n) {
  int64_t k = idx < 0 ? 0 : (int64_t)idx;
  k = k > n ? n : k;
  return k == 0 ? 0u : c[k - 1];
}

struct NbElem {
  const int32_t* ts_nb;
  const int32_t* v_nb;
  __device__ __forceinline__ uint2 operator()(int64_t i) const {
    return make_uint2((uint32_t)ts_nb[i], (uint32_t)v_nb[i]);
  }
};

// Pass 1's tail: the exclusive offsets give the varbytes; the entry and
// the value word go to scratch (E, V).
struct GatherOut {
  const int32_t* ts_nb;
  const int32_t* v_nb;
  const uint8_t* ts_pay;
  int64_t ts_len;
  const uint8_t* v_pay;
  int64_t v_len;
  int value_int;
  uint32_t* E;
  uint32_t* V;
  __device__ __forceinline__ void operator()(int64_t i, uint2 incl,
                                             uint2 e) const {
    const uint32_t ts_off = incl.x - e.x;
    const uint32_t v_off = incl.y - e.y;
    E[i] = unzigzag(varbytes(ts_pay, ts_len, ts_off, ts_nb[i]));
    const uint32_t x = varbytes(v_pay, v_len, v_off, v_nb[i]);
    V[i] = value_int ? unzigzag(x) : x;
  }
};

struct PairElem {
  const uint32_t* E;
  const uint32_t* V;
  __device__ __forceinline__ uint2 operator()(int64_t i) const {
    return make_uint2(E[i], V[i]);
  }
};

// Pass 2's tail: inclusive scans in place (each point rewrites only its
// own entries after the whole tile has read them).
struct InPlaceOut {
  uint32_t* C;
  uint32_t* W;
  __device__ __forceinline__ void operator()(int64_t i, uint2 incl,
                                             uint2) const {
    C[i] = incl.x;
    W[i] = incl.y;
  }
};

struct StepElem {
  const uint32_t* C;
  const int32_t* first_idx;
  int64_t n;
  __device__ __forceinline__ uint2 operator()(int64_t i) const {
    return make_uint2(C[i] - before(C, first_idx[i], n), 0u);
  }
};

struct StepOut {
  uint32_t* S;
  __device__ __forceinline__ void operator()(int64_t i, uint2 incl,
                                             uint2) const {
    S[i] = incl.x;
  }
};

__global__ void __launch_bounds__(kThreads)
    finish(const uint32_t* S, const uint32_t* W, const int32_t* first_idx,
           const int32_t* blk_first, const int32_t* rel_base,
           int32_t rel_base_scalar, int value_int, int64_t n,
           int32_t* rel_ts, float* vals) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t base =
      (uint32_t)(rel_base != nullptr ? rel_base[i] : rel_base_scalar);
  rel_ts[i] = (int32_t)(base + (S[i] - before(S, first_idx[i], n)));
  const uint32_t prev = before(W, blk_first[i], n);
  if (value_int) {
    vals[i] = __int2float_rn((int32_t)(W[i] - prev));
  } else {
    vals[i] = __uint_as_float(W[i] ^ prev);
  }
}

template <class Op0, class Op1, class Elem, class Out>
cudaError_t scan(Elem elem, Out out, int64_t n, uint2* tiles,
                 cudaStream_t st) {
  const int64_t ntiles = (n + kTile - 1) / kTile;
  tile_reduce<Op0, Op1><<<(unsigned)ntiles, kThreads, 0, st>>>(elem, n,
                                                               tiles);
  scan_tiles<Op0, Op1><<<1, kScanThreads, 0, st>>>(tiles, ntiles);
  tile_scan<Op0, Op1><<<(unsigned)ntiles, kThreads, 0, st>>>(elem, out, n,
                                                             tiles);
  return cudaGetLastError();
}

}  // namespace

// Scratch words the wrapper allocates for n points: E/C, V/W and S (n
// each), one word to align the tiles to 8 bytes, then one uint2 per tile.
extern "C" int64_t block_decode_scratch_words(int64_t n) {
  return 3 * n + 1 + 2 * ((n + kTile - 1) / kTile);
}

// Decode n points. ts_pay / v_pay hold ts_len / v_len bytes (either may be
// 0); rel_base is [n] int32 or null (then rel_base_scalar applies to every
// point); value_int selects TSINT (1) or TSF32 (0). scratch holds
// block_decode_scratch_words(n) 32-bit words, 8-byte aligned. Returns the
// CUDA error of the launches (0 = cudaSuccess).
extern "C" int block_decode_points(
    const int32_t* ts_nb, const uint8_t* ts_pay, int64_t ts_len,
    const int32_t* v_nb, const uint8_t* v_pay, int64_t v_len,
    const int32_t* first_idx, const int32_t* blk_first,
    const int32_t* rel_base, int32_t rel_base_scalar, int32_t value_int,
    int64_t n, uint32_t* scratch, int32_t* rel_ts, float* vals,
    void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  uint32_t* E = scratch;
  uint32_t* V = scratch + n;
  uint32_t* S = scratch + 2 * n;
  uint2* tiles = reinterpret_cast<uint2*>(scratch + 3 * n +
                                          ((3 * n) & 1));
  cudaError_t e = scan<Add, Add>(
      NbElem{ts_nb, v_nb},
      GatherOut{ts_nb, v_nb, ts_pay, ts_len, v_pay, v_len, value_int, E, V},
      n, tiles, st);
  if (e != cudaSuccess) return (int)e;
  if (value_int) {
    e = scan<Add, Add>(PairElem{E, V}, InPlaceOut{E, V}, n, tiles, st);
  } else {
    e = scan<Add, Xor>(PairElem{E, V}, InPlaceOut{E, V}, n, tiles, st);
  }
  if (e != cudaSuccess) return (int)e;
  e = scan<Add, Add>(StepElem{E, first_idx, n}, StepOut{S}, n, tiles, st);
  if (e != cudaSuccess) return (int)e;
  finish<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      S, V, first_idx, blk_first, rel_base, rel_base_scalar, value_int, n,
      rel_ts, vals);
  return (int)cudaGetLastError();
}
