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
// outputs written once over 3.35 TB/s: ts_nb, v_nb, first_idx, blk_first
// and rel_base (20 B a point, 16 with a scalar rel_base), the payload
// bytes (nb of each stream, at most 8 B a point, about 5 on the smoke's
// gathers), rel_ts and vals (8 B).
//
// Design: one pass, one block a tile of kTile = 4096 points (512 threads,
// 8 consecutive points each), three chained scans resolved by two
// decoupled look-backs (Merrill & Garland, "Single-pass Parallel Prefix
// Scan with Decoupled Look-back", 2016). A block takes its tile from a
// global atomic counter, so it waits only on tiles that already run: no
// deadlock, whatever order the blocks start in. For each look-back it
// publishes its tile's aggregate, and, once warp 0 has combined its
// predecessors' words (32 tiles a window, aggregates back to the nearest
// inclusive prefix), its inclusive prefix over the aggregate. A status
// word is 64 bits: the call's tag and the status in the high half, one
// 32-bit value in the low half, so a reader takes a slot only when all
// its words are of this call and of one status. The tag is the wrapper's
// call sequence number: the words of earlier calls never match, so
// nothing is reset between calls (no memset), and the block that takes
// the last tile index puts the counter back to 0.
//   1. (ts_nb, v_nb), add: the tile's byte offsets. With them each
//      stream's window of the tile ([off, off + tile bytes), at most
//      4 bytes a point) is staged in shared memory with 16-byte loads,
//      and every varbyte is read from there (two words and a byte
//      permute): the entry e and the value word w.
//   2. (e, w), (add, add or xor): C and W, each with a segment carry:
//      the index h of the last head before the span (a point whose
//      first_idx, or blk_first, is itself) and the chain's value just
//      before h.
//   3. steps = C[i] - C[first_idx[i]-1], add: S, with the same carry.
// Chains 2 and 3 share one look-back (12 words): a step needs C before
// the tile only as C_pre once (a lookup before the tile) and as C before
// the carry head once more (a carry lookup), so a span's S is kept as
// A + Z * C_pre - K * C_carry with the counts Z and K, and a span's
// words combine with its predecessor's without waiting for C.
// The lookups X[q-1] (q the clamped first_idx or blk_first) come from
// shared memory when q-1 lies in the tile (the tile's local inclusive
// prefixes: out = local[i] - local[q-1]), from the exclusive prefix when
// q-1 is the point before the tile, are 0 when q = 0 (the byte-stream
// leg's padding, which decodes against the global prefix), and come
// from the carry when q is the last head before the tile, however many
// tiles back (a record of 3,600 points, or a block of some 40,000,
// spans tiles). Real gathers have no other kind. Anything else (a
// forward lookup, a first_idx that is no head) marks the call irregular
// in a tagged flag, and the second launch, cooperative and gated on that
// flag, recomputes every output with the general algorithm (device-wide
// scans with grid barriers over full C, W and S arrays in scratch); on a
// regular call its blocks, one an SM, read the flag and return. So two
// launches a call, always.
// Bytes a point on a regular call: the 20 B (16) of inputs, the payload
// windows (each once, plus at most 15 B a tile of alignment), the 8 B of
// outputs; status words are 112 B a tile (0.03 B a point), read back a
// few times by the next tiles' look-back; nothing else. first_idx,
// blk_first and rel_base go to shared memory by cp.async; block scans
// are warp shuffles (__shfl_up_sync) and one shuffle scan of the warp
// totals.
//
// What holds it back (H100, torch.profiler and per-phase %globaltimer
// stamps): latency, not bytes. A tile's life is a chain of dependent
// steps (the tile counter, its loads, two look-backs of about two L2
// round trips each, the payload loads that wait on the first), and 2
// blocks of 512 threads an SM (64 registers a thread, 96 KB of shared
// memory a block) keep some 8,000 points an SM in flight.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;  // consecutive points per thread (a multiple of 4)
constexpr int kTile = kThreads * kItems;
// A stream's staged window: 4 bytes a point, 15 of alignment ahead, and
// the word past the end that the two-word read may touch.
constexpr int kWindow = 4 * kTile + 32;
// Status words a tile: the slots of the two look-back chains (2 and 12
// words).
constexpr int kDescWords = 14;
// Dynamic shared memory of the main kernel: the two payload windows, then
// first_idx, blk_first, the S counts and rel_base of the tile.
constexpr int kSmemBytes = 2 * kWindow + 4 * kTile * 4;
constexpr int kFbThreads = 256;
constexpr int kFbMaxBlocks = 2048;

struct Add {
  static __device__ __forceinline__ uint32_t op(uint32_t a, uint32_t b) {
    return a + b;
  }
  static __device__ __forceinline__ uint32_t inv(uint32_t a, uint32_t b) {
    return a - b;
  }
};

struct Xor {
  static __device__ __forceinline__ uint32_t op(uint32_t a, uint32_t b) {
    return a ^ b;
  }
  static __device__ __forceinline__ uint32_t inv(uint32_t a, uint32_t b) {
    return a ^ b;
  }
};

struct Args {
  const int32_t* ts_nb;
  const uint8_t* ts_pay;
  int64_t ts_len;
  const int32_t* v_nb;
  const uint8_t* v_pay;
  int64_t v_len;
  const int32_t* first_idx;
  const int32_t* blk_first;
  const int32_t* rel_base;  // null: rel_base_scalar for every point
  int32_t rel_base_scalar;
  int64_t n;
  int32_t* rel_ts;
  float* vals;
};

__device__ __forceinline__ uint64_t ld_relaxed(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// Two status words in one 16-byte access (each word is read or written
// whole; the pair need not be).
__device__ __forceinline__ void ld_relaxed2(const uint64_t* p, uint64_t& a,
                                            uint64_t& b) {
  asm volatile("ld.relaxed.gpu.global.v2.u64 {%0, %1}, [%2];"
               : "=l"(a), "=l"(b) : "l"(p) : "memory");
}

__device__ __forceinline__ void st_relaxed2(uint64_t* p, uint64_t a,
                                            uint64_t b) {
  asm volatile("st.relaxed.gpu.global.v2.u64 [%0], {%1, %2};"
               :: "l"(p), "l"(a), "l"(b) : "memory");
}

__device__ __forceinline__ uint32_t unzigzag(uint32_t z) {
  return (z >> 1) ^ (0u - (z & 1u));
}

__device__ __forceinline__ int64_t clamp_idx(int32_t idx, int64_t n) {
  return idx < 0 ? 0 : (idx > n ? n : (int64_t)idx);
}

// The nb significant big-endian bytes at off (nb == 0 -> 0), from device
// memory. Indices clamp to [0, len - 1] as the JAX gather's do; an empty
// payload reads nothing. Only the first four bytes count, and a byte
// whose shift would reach 32 bits contributes 0, as XLA's shifts do.
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

// The same from a staged window: nb in [0, 4], p the byte's position in
// the window. Two aligned words and a byte permute give the four bytes
// from p in big-endian order; the shift keeps nb of them.
__device__ __forceinline__ uint32_t win_varbytes(const uint8_t* win,
                                                 uint32_t p, int32_t nb) {
  if (nb <= 0) return 0u;
  const uint32_t* w = reinterpret_cast<const uint32_t*>(win) + (p >> 2);
  const uint32_t r = p & 3u;
  const uint32_t be = __byte_perm(
      w[0], w[1], (r << 12) | ((r + 1) << 8) | ((r + 2) << 4) | (r + 3));
  return be >> (32 - 8 * nb);
}

// Stage the cnt bytes of a stream from offset off into dst: dst[lead + k]
// is the byte the JAX gather reads at off + k. When the window lies in
// the payload, 16-byte loads from the aligned chunk below off (lead =
// off's distance into it); else one clamped byte at a time (lead 0).
__device__ __forceinline__ uint32_t stage(uint8_t* dst, const uint8_t* pay,
                                          int64_t len, uint32_t off,
                                          uint32_t cnt) {
  const int64_t lo = (int64_t)(int32_t)off;
  const int64_t hi = lo + (int64_t)cnt;
  if (len > 0 && (reinterpret_cast<uintptr_t>(pay) & 15u) == 0 && lo >= 0 &&
      hi <= len && hi <= (int64_t)INT32_MAX) {
    const int64_t base = lo & ~(int64_t)15;
    const int chunks = (int)((hi - base + 15) >> 4);
    const uint4* src = reinterpret_cast<const uint4*>(pay + base);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (int c = threadIdx.x; c < chunks; c += kThreads) d[c] = __ldcs(src + c);
    return (uint32_t)(lo - base);
  }
  for (int k = threadIdx.x; k < (int)cnt; k += kThreads) {
    int64_t idx = (int64_t)(int32_t)(off + (uint32_t)k);
    idx = idx < 0 ? 0 : (idx > len - 1 ? len - 1 : idx);
    dst[k] = len > 0 ? pay[idx] : 0;
  }
  return 0u;
}

// kItems consecutive int32 from i (0 past n): 16-byte streaming loads
// when all lie in the array (the wrapper aligns every input).
__device__ __forceinline__ void load_items(const int32_t* p, int64_t i,
                                           int64_t n, int32_t (&v)[kItems]) {
  if (i + kItems - 1 < n) {
#pragma unroll
    for (int c = 0; c < kItems / 4; ++c) {
      const int4 r = __ldcs(reinterpret_cast<const int4*>(p + i) + c);
      v[4 * c] = r.x;
      v[4 * c + 1] = r.y;
      v[4 * c + 2] = r.z;
      v[4 * c + 3] = r.w;
    }
  } else {
    for (int k = 0; k < kItems; ++k) v[k] = i + k < n ? p[i + k] : 0;
  }
}

__device__ __forceinline__ void store_items(int32_t* p, int64_t i, int64_t n,
                                            const int32_t (&v)[kItems]) {
  if (i + kItems - 1 < n) {
#pragma unroll
    for (int c = 0; c < kItems / 4; ++c)
      __stcs(reinterpret_cast<int4*>(p + i) + c,
             make_int4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]));
  } else {
    for (int k = 0; k < kItems; ++k)
      if (i + k < n) p[i + k] = v[k];
  }
}

// A thread's kItems words into shared memory at dst (16-byte aligned).
__device__ __forceinline__ void put_items(uint32_t* dst,
                                          const uint32_t (&v)[kItems]) {
#pragma unroll
  for (int c = 0; c < kItems / 4; ++c)
    reinterpret_cast<uint4*>(dst)[c] =
        make_uint4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
}

// kItems consecutive int32 from i (0 past n) into shared memory:
// asynchronous 16-byte copies when all lie in the array.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ void copy_async(int32_t* dst, const int32_t* p,
                                           int64_t i, int64_t n) {
  if (i + kItems - 1 < n) {
#pragma unroll
    for (int c = 0; c < kItems / 4; ++c) cp_async16(dst + 4 * c, p + i + 4 * c);
  } else {
    for (int k = 0; k < kItems; ++k) dst[k] = i + k < n ? p[i + k] : 0;
  }
}

// Exclusive scan of one pair a thread over the block: a shuffle scan in
// each warp, then warp 0 scans the warp totals. sh holds 2 * kWarps + 1
// entries. *total gets the block's aggregate; *mx / *my the block's
// maxima of hx / hy (last head indices).
template <class Op0, class Op1>
__device__ __forceinline__ uint2 block_excl(uint2 v, int hx, int hy,
                                            uint4* sh, uint2* total, int* mx,
                                            int* my) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint2 x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t a = __shfl_up_sync(0xffffffffu, x.x, d);
    const uint32_t b = __shfl_up_sync(0xffffffffu, x.y, d);
    if (lane >= d) {
      x.x = Op0::op(a, x.x);
      x.y = Op1::op(b, x.y);
    }
  }
  hx = __reduce_max_sync(0xffffffffu, hx);
  hy = __reduce_max_sync(0xffffffffu, hy);
  if (lane == 31) sh[warp] = make_uint4(x.x, x.y, (uint32_t)hx, (uint32_t)hy);
  __syncthreads();
  if (warp == 0) {
    const uint4 t = lane < kWarps
                        ? sh[lane]
                        : make_uint4(0u, 0u, (uint32_t)INT32_MIN,
                                     (uint32_t)INT32_MIN);
    uint32_t sx = t.x, sy = t.y;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const uint32_t a = __shfl_up_sync(0xffffffffu, sx, d);
      const uint32_t b = __shfl_up_sync(0xffffffffu, sy, d);
      if (lane >= d) {
        sx = Op0::op(a, sx);
        sy = Op1::op(b, sy);
      }
    }
    const int mz = __reduce_max_sync(0xffffffffu, (int)t.z);
    const int mw = __reduce_max_sync(0xffffffffu, (int)t.w);
    if (lane < kWarps)
      sh[kWarps + lane] = make_uint4(Op0::inv(sx, t.x), Op1::inv(sy, t.y),
                                     0u, 0u);
    if (lane == kWarps - 1)
      sh[2 * kWarps] = make_uint4(sx, sy, (uint32_t)mz, (uint32_t)mw);
  }
  __syncthreads();
  const uint4 pre = sh[kWarps + warp];
  const uint4 tot = sh[2 * kWarps];
  *total = make_uint2(tot.x, tot.y);
  *mx = (int)tot.z;
  *my = (int)tot.w;
  return make_uint2(Op0::op(pre.x, Op0::inv(x.x, v.x)),
                    Op1::op(pre.y, Op1::inv(x.y, v.y)));
}

// A chain with a segment carry, three words: g (the chain's value over
// the span), base (its value just before the span's last head h,
// relative to the span's start), h (absolute index, -1: no head).
// b = a.b, in place (a before b).
template <class Op>
__device__ __forceinline__ void seg_combine(const uint32_t* a, uint32_t* b) {
  const bool bh = (int32_t)b[2] >= 0;
  b[1] = bh ? Op::op(a[0], b[1]) : a[1];
  b[2] = bh ? b[2] : a[2];
  b[0] = Op::op(a[0], b[0]);
}

// The look-back chains' words: K values (even), the slot's first word in
// a tile's status words; combine(a, b) makes b the words of a.b.
struct Offsets {
  static constexpr int K = 2, kOff = 0;
  static __device__ __forceinline__ void identity(uint32_t* v) {
    v[0] = v[1] = 0u;
  }
  static __device__ __forceinline__ void combine(const uint32_t* a,
                                                 uint32_t* b) {
    b[0] += a[0];
    b[1] += a[1];
  }
};

// An S value over a span b as an affine function of what precedes it,
// three words (A, Z, K): S = A + Z * Cg_pre - K * Cb_pre, where Cg_pre is
// C just before the span and Cb_pre is C just before the last head
// before the span. A point whose step looks before the span adds C_pre
// once (Z counts it) and, when it looks back to that head, subtracts
// Cb_pre once (K counts it). Rewritten over the span a.b, given a's C
// words (g, base, h): a's head, if it has one, is the head b's points
// looked back to.
__device__ __forceinline__ void shift_affine(const uint32_t* x,
                                             const uint32_t* ca,
                                             uint32_t* out) {
  if ((int32_t)ca[2] >= 0) {
    out[0] = x[0] + x[1] * ca[0] - x[2] * ca[1];
    out[1] = x[1] - x[2];
    out[2] = 0u;
  } else {
    out[0] = x[0] + x[1] * ca[0];
    out[1] = x[1];
    out[2] = x[2];
  }
}

// Chains 2 and 3 in one look-back, twelve words: C (add, first_idx
// heads), W (OpW, blk_first heads), S and S before the last C head, both
// affine in what precedes the span.
template <class OpW>
struct Chains {
  static constexpr int K = 12, kOff = 2;
  static __device__ __forceinline__ void identity(uint32_t* v) {
    for (int k = 0; k < K; ++k) v[k] = 0u;
    v[2] = v[5] = 0xffffffffu;
  }
  static __device__ __forceinline__ void combine(const uint32_t* a,
                                                 uint32_t* b) {
    uint32_t s[3], sb[3];
    shift_affine(b + 6, a, s);
    const bool bh = (int32_t)b[2] >= 0;
    if (bh) shift_affine(b + 9, a, sb);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      b[6 + k] = a[6 + k] + s[k];
      b[9 + k] = bh ? a[6 + k] + sb[k] : a[9 + k];
    }
    seg_combine<Add>(a, b);
    seg_combine<OpW>(a + 3, b + 3);
  }
};

// A status word: the call's tag and the slot's status (0: the tile's
// aggregate, 1: its inclusive prefix) in the high half, a value in the
// low half. The inclusive prefix overwrites the aggregate word by word.
// read_slot: 0 while the slot's words are not all of this call and of
// one status, else 1 (aggregate) or 2 (inclusive prefix), with v.
template <int K>
__device__ __forceinline__ int read_slot(const uint64_t* slot, uint32_t tag,
                                         uint32_t* v) {
  uint32_t all = 0xffffffffu, any = 0u;
#pragma unroll
  for (int k = 0; k < K; k += 2) {
    uint64_t a, b;
    ld_relaxed2(slot + k, a, b);
    all &= (uint32_t)(a >> 32) & (uint32_t)(b >> 32);
    any |= (uint32_t)(a >> 32) | (uint32_t)(b >> 32);
    v[k] = (uint32_t)a;
    v[k + 1] = (uint32_t)b;
  }
  if (all != any || (all >> 1) != tag) return 0;
  return 1 + (int)(all & 1u);
}

template <int K>
__device__ __forceinline__ void write_slot(uint64_t* slot, uint32_t tag,
                                           uint32_t status,
                                           const uint32_t* v) {
  const uint64_t hi = (uint64_t)((tag << 1) | status) << 32;
#pragma unroll
  for (int k = 0; k < K; k += 2) st_relaxed2(slot + k, hi | v[k], hi | v[k + 1]);
}

// Warp 0: the chain's exclusive prefix of the tile from its predecessors'
// status words, into run (shared memory, K words, written by lane 0).
// Lane l polls tile pos - l until it shows an aggregate or an inclusive
// prefix of this call; the window is combined up to its nearest
// inclusive prefix (lanes past it count as the identity) by a shuffle
// tree in tile order, only as deep as that lane needs; without one, the
// window's aggregate joins run and the window moves 32 tiles back.
template <class Ch>
__device__ __forceinline__ void look_back(const uint64_t* descs, int tile,
                                          uint32_t tag, uint32_t* run) {
  constexpr int K = Ch::K;
  const int lane = threadIdx.x & 31;
  if (lane == 0) Ch::identity(run);
  for (int pos = tile - 1;; pos -= 32) {
    const int t = pos - lane;
    uint32_t v[K];
    int status = 2;
    if (t < 0) {
      Ch::identity(v);
    } else {
      const uint64_t* d = descs + (size_t)t * kDescWords + Ch::kOff;
      while ((status = read_slot<K>(d, tag, v)) == 0) __nanosleep(32);
    }
    const unsigned m = __ballot_sync(0xffffffffu, status == 2);
    const int p = m ? __ffs(m) - 1 : 31;
    if (lane > p) Ch::identity(v);
    for (int d = 1; d <= p; d <<= 1) {
      uint32_t o[K];
#pragma unroll
      for (int k = 0; k < K; ++k) o[k] = __shfl_down_sync(0xffffffffu, v[k], d);
      if (lane + d < 32) Ch::combine(o, v);
    }
    if (lane == 0) Ch::combine(v, run);
    if (m) return;
  }
}

// Publish the tile's aggregate (agg, shared memory, written by thread 0),
// find its exclusive prefix (warp 0), then publish its inclusive prefix;
// ex (shared memory) gets the exclusive prefix. The caller synchronises
// the block before reading ex.
template <class Ch>
__device__ __forceinline__ void resolve(uint64_t* descs, int tile,
                                        uint32_t tag, const uint32_t* agg,
                                        uint32_t* ex) {
  constexpr int K = Ch::K;
  if (threadIdx.x >= 32) return;
  uint64_t* mine = descs + (size_t)tile * kDescWords + Ch::kOff;
  if (tile == 0) {
    if (threadIdx.x == 0) Ch::identity(ex);
  } else {
    if (threadIdx.x == 0) write_slot<K>(mine, tag, 0u, agg);
    look_back<Ch>(descs, tile, tag, ex);
  }
  if (threadIdx.x == 0) {
    uint32_t inc[K];
#pragma unroll
    for (int k = 0; k < K; ++k) inc[k] = agg[k];
    Ch::combine(ex, inc);
    write_slot<K>(mine, tag, 1u, inc);
  }
}

// Where X[q-1] comes from for a lookup q (clamped to [0, n]) of a point
// in the tile starting at t0: kZero (q == 0: X[-1] = 0), kLocal (q-1 in
// [t0-1, t0+kTile): the tile's local prefixes), kCarry (q is the last
// head before the tile), else kIrregular.
enum { kZero, kLocal, kCarry, kIrregular };

__device__ __forceinline__ int lookup_kind(int64_t q, int64_t t0, int h) {
  if (q == 0) return kZero;
  if (q >= t0 && q <= t0 + kTile) return kLocal;
  return q == (int64_t)h ? kCarry : kIrregular;
}

// X[i] (-) X[q-1] from the tile's local inclusive prefix xl of point i,
// the local prefixes loc, and the exclusive prefix (g, base) of the
// chain; kIrregular gives 0 (the general launch recomputes the call).
template <class Op>
__device__ __forceinline__ uint32_t segment_value(int kind, uint32_t xl,
                                                  const uint32_t* loc,
                                                  int64_t q, int64_t t0,
                                                  uint32_t g, uint32_t base) {
  switch (kind) {
    case kZero:
      return Op::op(g, xl);
    case kLocal:
      return Op::inv(xl, q > t0 ? loc[q - 1 - t0] : 0u);
    case kCarry:
      return Op::inv(Op::op(g, xl), base);
    default:
      return 0u;
  }
}

template <bool kInt>
__global__ void __launch_bounds__(kThreads, 2)
    decode_main(Args a, uint64_t* state, uint32_t tag, int ntiles) {
  using OpW = typename std::conditional<kInt, Add, Xor>::type;
  extern __shared__ __align__(16) uint8_t dsm[];
  __shared__ uint4 sh1[2 * kWarps + 1];
  __shared__ uint4 sh2[2 * kWarps + 1];
  __shared__ uint4 sh3[2 * kWarps + 1];
  __shared__ uint32_t agg[14];
  __shared__ uint32_t ex[14];
  __shared__ int s_tile;
  uint8_t* win_ts = dsm;
  uint8_t* win_v = dsm + kWindow;
  int32_t* sfi = reinterpret_cast<int32_t*>(dsm + 2 * kWindow);
  int32_t* sbf = sfi + kTile;
  uint32_t* szk = reinterpret_cast<uint32_t*>(sbf + kTile);
  int32_t* sbase = reinterpret_cast<int32_t*>(szk + kTile);

  const int tid = threadIdx.x;
  const int64_t n = a.n;
  if (tid == 0) {
    unsigned* counter = reinterpret_cast<unsigned*>(state);
    const unsigned t = atomicAdd(counter, 1u);
    // Every other block has taken its index: ready for the next call.
    if (t == (unsigned)ntiles - 1) atomicExch(counter, 0u);
    s_tile = (int)t;
  }
  __syncthreads();
  const int tile = s_tile;
  const int64_t t0 = (int64_t)tile * kTile;
  const int j0 = tid * kItems;  // the thread's first point in the tile
  const int64_t i0 = t0 + j0;
  uint64_t* descs = state + 2;

  // Every input is read once, now: first_idx, blk_first and rel_base
  // straight into shared memory (each thread reads back its own four),
  // the byte counts into registers.
  copy_async(sfi + j0, a.first_idx, i0, n);
  copy_async(sbf + j0, a.blk_first, i0, n);
  if (a.rel_base != nullptr) copy_async(sbase + j0, a.rel_base, i0, n);
  int32_t tnb[kItems], vnb[kItems];
  load_items(a.ts_nb, i0, n, tnb);
  load_items(a.v_nb, i0, n, vnb);

  // 1. Byte offsets; the payload windows; entries and value words.
  bool small = true;
  uint32_t st = 0u, sv = 0u;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    small &= (uint32_t)tnb[k] <= 4u && (uint32_t)vnb[k] <= 4u;
    st += (uint32_t)tnb[k];
    sv += (uint32_t)vnb[k];
  }
  // The windows are staged when every byte count of the tile is 0-4
  // (the block maximum of the vote below is negative).
  uint2 tot1;
  int big, unused0;
  const uint2 pre1 = block_excl<Add, Add>(make_uint2(st, sv), small ? -1 : 1,
                                          -1, sh1, &tot1, &big, &unused0);
  const bool staged = big < 0;
  if (tid == 0) {
    agg[0] = tot1.x;
    agg[1] = tot1.y;
  }
  resolve<Offsets>(descs, tile, tag, agg, ex);
  __syncthreads();
  const uint32_t off_ts = ex[0], off_v = ex[1];
  uint32_t lead_ts = 0u, lead_v = 0u;
  if (staged) {
    lead_ts = stage(win_ts, a.ts_pay, a.ts_len, off_ts, tot1.x);
    lead_v = stage(win_v, a.v_pay, a.v_len, off_v, tot1.y);
  }
  __syncthreads();
  uint32_t e[kItems], w[kItems];
  {
    uint32_t pt = pre1.x, pv = pre1.y;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const uint32_t xt =
          staged ? win_varbytes(win_ts, lead_ts + pt, tnb[k])
                 : varbytes(a.ts_pay, a.ts_len, off_ts + pt, tnb[k]);
      const uint32_t xv =
          staged ? win_varbytes(win_v, lead_v + pv, vnb[k])
                 : varbytes(a.v_pay, a.v_len, off_v + pv, vnb[k]);
      e[k] = unzigzag(xt);
      w[k] = kInt ? unzigzag(xv) : xv;
      pt += (uint32_t)tnb[k];
      pv += (uint32_t)vnb[k];
    }
  }

  // 2. C and W, the tile's local inclusive prefixes.
  cp_async_wait();
  int hc = -1, hw = -1;
  uint32_t sc = 0u, sw = 0u;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = i0 + k;
    sc += e[k];
    sw = OpW::op(sw, w[k]);
    if (i < n && sfi[j0 + k] == i) hc = (int)i;
    if (i < n && sbf[j0 + k] == i) hw = (int)i;
  }
  uint2 tot2;
  int head_c, head_w;
  const uint2 pre2 = block_excl<Add, OpW>(make_uint2(sc, sw), hc, hw, sh2,
                                          &tot2, &head_c, &head_w);
  // The windows are dead: every gather ran before block_excl's barrier.
  uint32_t* cloc = reinterpret_cast<uint32_t*>(dsm);
  uint32_t* wloc = cloc + kTile;
  uint32_t cl[kItems];
  {
    uint32_t rc = pre2.x, rw = pre2.y;
    uint32_t wl[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      rc += e[k];
      rw = OpW::op(rw, w[k]);
      cl[k] = rc;
      wl[k] = rw;
    }
    put_items(cloc + j0, cl);
    put_items(wloc + j0, wl);
  }
  __syncthreads();
  if (tid == 0) {
    agg[2] = tot2.x;
    agg[3] = head_c > t0 ? cloc[head_c - t0 - 1] : 0u;
    agg[4] = (uint32_t)head_c;
    agg[5] = tot2.y;
    agg[6] = head_w > t0 ? wloc[head_w - t0 - 1] : 0u;
    agg[7] = (uint32_t)head_w;
  }

  // 3. The steps C[i] - C[first_idx-1] as affine words (A, Z | K << 16)
  // in the C before the tile (kZero, kCarry) and before its carry head
  // (kCarry); the carry's lookups must all name one head, checked
  // against the look-back's.
  bool irregular = false;
  int kinds = 0;
  int qmax = -1, negqmin = INT32_MIN;
  uint32_t sa[kItems], zk[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t q = clamp_idx(sfi[j0 + k], n);
    int kind = kZero;
    sa[k] = cl[k];
    zk[k] = 1u;
    if (i0 + k >= n) {
      sa[k] = zk[k] = 0u;
    } else if (q == 0) {
    } else if (q >= t0 && q <= t0 + kTile) {
      kind = kLocal;
      sa[k] = cl[k] - (q > t0 ? cloc[q - 1 - t0] : 0u);
      zk[k] = 0u;
    } else if (q < t0) {
      kind = kCarry;
      zk[k] = 1u | (1u << 16);
      qmax = (int)q > qmax ? (int)q : qmax;
      negqmin = -(int)q > negqmin ? -(int)q : negqmin;
    } else {
      kind = kIrregular;
      sa[k] = zk[k] = 0u;
      irregular = true;
    }
    kinds |= kind << (2 * k);
  }
  uint2 tot3;
  int q_hi, neg_q_lo;
  uint32_t ssa = 0u, szks = 0u;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    ssa += sa[k];
    szks += zk[k];
  }
  const uint2 pre3 = block_excl<Add, Add>(make_uint2(ssa, szks), qmax,
                                          negqmin, sh3, &tot3, &q_hi,
                                          &neg_q_lo);
  // S's local prefixes over cloc: every lookup of cloc ran before
  // block_excl's barrier, and thread 0 took the C base before it.
  uint32_t* sloc = cloc;
  {
    uint32_t ra = pre3.x, rz = pre3.y;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      ra += sa[k];
      rz += zk[k];
      sa[k] = ra;
      zk[k] = rz;
    }
    put_items(sloc + j0, sa);
    put_items(szk + j0, zk);
  }
  __syncthreads();
  if (tid == 0) {
    const bool hb = head_c > t0;
    const uint32_t hz = hb ? szk[head_c - t0 - 1] : 0u;
    agg[8] = tot3.x;
    agg[9] = tot3.y & 0xffffu;
    agg[10] = tot3.y >> 16;
    agg[11] = hb ? sloc[head_c - t0 - 1] : 0u;
    agg[12] = hz & 0xffffu;
    agg[13] = hz >> 16;
  }
  resolve<Chains<OpW>>(descs, tile, tag, agg + 2, ex + 2);
  __syncthreads();
  const uint32_t c_g = ex[2], c_b = ex[3], w_g = ex[5], w_b = ex[6];
  const uint32_t s_g = ex[8], s_b = ex[11];
  const int c_h = (int)ex[4], w_h = (int)ex[7];
  irregular |= q_hi >= 0 && (q_hi != -neg_q_lo || q_hi != c_h);

  // The values: W[i] (-) W[blk_first-1].
  {
    int32_t out[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int64_t q = clamp_idx(sbf[j0 + k], n);
      const int kind = lookup_kind(q, t0, w_h);
      irregular |= kind == kIrregular && i0 + k < n;
      const uint32_t bits =
          segment_value<OpW>(kind, wloc[j0 + k], wloc, q, t0, w_g, w_b);
      out[k] = kInt ? __float_as_int(__int2float_rn((int32_t)bits))
                    : (int32_t)bits;
    }
    store_items(reinterpret_cast<int32_t*>(a.vals), i0, n, out);
  }

  // rel_ts = rel_base + S[i] - S[first_idx-1], S's local prefixes made
  // concrete with the C words before the tile.
  {
    int32_t out[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int kind = (kinds >> (2 * k)) & 3;
      const uint32_t z = szk[j0 + k];
      const uint32_t sl = sloc[j0 + k] + (z & 0xffffu) * c_g - (z >> 16) * c_b;
      uint32_t d = 0u;
      if (kind == kZero) {
        d = s_g + sl;
      } else if (kind == kLocal) {
        const int64_t q = clamp_idx(sfi[j0 + k], n);
        uint32_t prev = 0u;
        if (q > t0) {
          const uint32_t zq = szk[q - 1 - t0];
          prev = sloc[q - 1 - t0] + (zq & 0xffffu) * c_g - (zq >> 16) * c_b;
        }
        d = sl - prev;
      } else if (kind == kCarry) {
        d = s_g + sl - s_b;
      }
      const uint32_t b0 = a.rel_base != nullptr ? (uint32_t)sbase[j0 + k]
                                                : (uint32_t)a.rel_base_scalar;
      out[k] = (int32_t)(b0 + d);
    }
    store_items(a.rel_ts, i0, n, out);
  }
  if (irregular) st_relaxed(state + 1, tag);
}

// ---------------------------------------------------------------------------
// The general path: the call's every output from full C, W and S arrays,
// run only when the main launch flagged the call irregular. A cooperative
// launch of co-resident blocks, each over one contiguous chunk of points,
// with grid barriers between the device-wide phases.
// ---------------------------------------------------------------------------

// Inclusive scan of one pair a thread over a kFbThreads block.
template <class Op0, class Op1>
__device__ __forceinline__ uint2 fb_scan(uint2 v, uint2* sh, uint2* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint2 x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t a = __shfl_up_sync(0xffffffffu, x.x, d);
    const uint32_t b = __shfl_up_sync(0xffffffffu, x.y, d);
    if (lane >= d) {
      x.x = Op0::op(a, x.x);
      x.y = Op1::op(b, x.y);
    }
  }
  if (lane == 31) sh[warp] = x;
  __syncthreads();
  uint2 pre = make_uint2(0u, 0u), tot = make_uint2(0u, 0u);
  for (int w = 0; w < kFbThreads / 32; ++w) {
    const uint2 t = sh[w];
    if (w < warp) {
      pre.x = Op0::op(pre.x, t.x);
      pre.y = Op1::op(pre.y, t.y);
    }
    tot.x = Op0::op(tot.x, t.x);
    tot.y = Op1::op(tot.y, t.y);
  }
  __syncthreads();
  *total = tot;
  return make_uint2(Op0::op(pre.x, x.x), Op1::op(pre.y, x.y));
}

// The combined chunk sums of blocks [0, b), broadcast through *cell.
template <class Op0, class Op1>
__device__ __forceinline__ uint2 fb_prefix(const uint2* agg, int b,
                                           uint2* cell) {
  if (threadIdx.x == 0) {
    uint2 r = make_uint2(0u, 0u);
    for (int k = 0; k < b; ++k) {
      const uint2 t = __ldcg(agg + k);
      r.x = Op0::op(r.x, t.x);
      r.y = Op1::op(r.y, t.y);
    }
    *cell = r;
  }
  __syncthreads();
  const uint2 r = *cell;
  __syncthreads();
  return r;
}

// c[clamp(idx, 0, n) - 1], 0 at 0, read past L1 (other blocks wrote c).
__device__ __forceinline__ uint32_t before(const uint32_t* c, int32_t idx,
                                           int64_t n) {
  const int64_t k = clamp_idx(idx, n);
  return k == 0 ? 0u : __ldcg(c + k - 1);
}

template <bool kInt>
__global__ void __launch_bounds__(kFbThreads)
    decode_general(Args a, const uint64_t* state, uint32_t tag, uint32_t* W,
                   uint32_t* S, uint2* agg) {
  using OpW = typename std::conditional<kInt, Add, Xor>::type;
  if ((uint32_t)ld_relaxed(state + 1) != tag) return;  // a regular call
  __shared__ uint2 sh[kFbThreads / 32];
  __shared__ uint2 cell[1];
  cg::grid_group grid = cg::this_grid();
  const int64_t n = a.n;
  const int G = gridDim.x, b = blockIdx.x, tid = threadIdx.x;
  const int64_t per = (n + G - 1) / G;
  const int64_t lo = (int64_t)b * per < n ? (int64_t)b * per : n;
  const int64_t hi = lo + per < n ? lo + per : n;
  // C lives in rel_ts until the last phase writes rel_ts (it reads no C).
  uint32_t* C = reinterpret_cast<uint32_t*>(a.rel_ts);
  uint2 tot;

  // The chunks' byte counts.
  uint2 acc = make_uint2(0u, 0u);
  for (int64_t i = lo + tid; i < hi; i += kFbThreads) {
    acc.x += (uint32_t)a.ts_nb[i];
    acc.y += (uint32_t)a.v_nb[i];
  }
  fb_scan<Add, Add>(acc, sh, &tot);
  if (tid == 0) agg[b] = tot;
  grid.sync();

  // Offsets, varbytes: entries into C, value words into W.
  uint2 run = fb_prefix<Add, Add>(agg, b, cell);
  acc = make_uint2(0u, 0u);
  for (int64_t base = lo; base < hi; base += kFbThreads) {
    const int64_t i = base + tid;
    const uint2 nb = i < hi ? make_uint2((uint32_t)a.ts_nb[i],
                                         (uint32_t)a.v_nb[i])
                            : make_uint2(0u, 0u);
    const uint2 inc = fb_scan<Add, Add>(nb, sh, &tot);
    if (i < hi) {
      const uint32_t ent = unzigzag(varbytes(a.ts_pay, a.ts_len,
                                             run.x + inc.x - nb.x,
                                             (int32_t)nb.x));
      const uint32_t x = varbytes(a.v_pay, a.v_len, run.y + inc.y - nb.y,
                                  (int32_t)nb.y);
      const uint32_t wv = kInt ? unzigzag(x) : x;
      C[i] = ent;
      W[i] = wv;
      acc.x += ent;
      acc.y = OpW::op(acc.y, wv);
    }
    run.x += tot.x;
    run.y += tot.y;
  }
  fb_scan<Add, OpW>(acc, sh, &tot);
  if (tid == 0) agg[G + b] = tot;
  grid.sync();

  // C and W: inclusive scans in place (each point rewrites its own).
  run = fb_prefix<Add, OpW>(agg + G, b, cell);
  for (int64_t base = lo; base < hi; base += kFbThreads) {
    const int64_t i = base + tid;
    const uint2 v = i < hi ? make_uint2(__ldcg(C + i), __ldcg(W + i))
                           : make_uint2(0u, 0u);
    const uint2 inc = fb_scan<Add, OpW>(v, sh, &tot);
    if (i < hi) {
      C[i] = run.x + inc.x;
      W[i] = OpW::op(run.y, inc.y);
    }
    run.x += tot.x;
    run.y = OpW::op(run.y, tot.y);
  }
  grid.sync();

  // The chunks' steps, then S.
  acc = make_uint2(0u, 0u);
  for (int64_t i = lo + tid; i < hi; i += kFbThreads)
    acc.x += __ldcg(C + i) - before(C, a.first_idx[i], n);
  fb_scan<Add, Add>(acc, sh, &tot);
  if (tid == 0) agg[2 * G + b] = tot;
  grid.sync();
  run = fb_prefix<Add, Add>(agg + 2 * G, b, cell);
  for (int64_t base = lo; base < hi; base += kFbThreads) {
    const int64_t i = base + tid;
    const uint32_t step =
        i < hi ? __ldcg(C + i) - before(C, a.first_idx[i], n) : 0u;
    const uint2 inc = fb_scan<Add, Add>(make_uint2(step, 0u), sh, &tot);
    if (i < hi) S[i] = run.x + inc.x;
    run.x += tot.x;
  }
  grid.sync();

  // The outputs.
  for (int64_t i = (int64_t)b * kFbThreads + tid; i < n;
       i += (int64_t)G * kFbThreads) {
    const uint32_t base =
        (uint32_t)(a.rel_base != nullptr ? a.rel_base[i] : a.rel_base_scalar);
    a.rel_ts[i] = (int32_t)(base + (__ldcg(S + i) -
                                    before(S, a.first_idx[i], n)));
    const uint32_t wi = __ldcg(W + i);
    const uint32_t prev = before(W, a.blk_first[i], n);
    a.vals[i] = kInt ? __int2float_rn((int32_t)(wi - prev))
                     : __uint_as_float(wi ^ prev);
  }
}

// The general kernel's grid: one block an SM of the current card, at most
// kFbMaxBlocks (cached per card). Co-resident, as a cooperative launch
// needs; on a regular call the launch only reads the flag.
template <bool kInt>
cudaError_t general_blocks(int* out) {
  static int cached[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && cached[dev] > 0) {
    *out = cached[dev];
    return cudaSuccess;
  }
  int per_sm = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, decode_general<kInt>, kFbThreads, 0);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  int g = per_sm < 1 ? 0 : sms;
  g = g < 1 ? 1 : (g > kFbMaxBlocks ? kFbMaxBlocks : g);
  if (dev < 64) cached[dev] = g;
  *out = g;
  return cudaSuccess;
}

template <bool kInt>
cudaError_t launch(const Args& args, uint64_t* state, uint32_t tag,
                   uint32_t* scratch, cudaStream_t st) {
  const int ntiles = (int)((args.n + kTile - 1) / kTile);
  static bool sized[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64 || !sized[dev]) {
    e = cudaFuncSetAttribute(decode_main<kInt>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
    if (e != cudaSuccess) return e;
    if (dev < 64) sized[dev] = true;
  }
  decode_main<kInt><<<ntiles, kThreads, kSmemBytes, st>>>(args, state, tag,
                                                          ntiles);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  int g = 0;
  e = general_blocks<kInt>(&g);
  if (e != cudaSuccess) return e;
  Args a = args;
  const uint64_t* cstate = state;
  uint32_t* W = scratch;
  uint32_t* S = scratch + args.n;
  uint2* agg = reinterpret_cast<uint2*>(scratch + 2 * args.n +
                                        ((2 * args.n) & 1));
  void* params[] = {&a, &cstate, &tag, &W, &S, &agg};
  return cudaLaunchCooperativeKernel(decode_general<kInt>, dim3(g),
                                     dim3(kFbThreads), params, 0, st);
}

}  // namespace

// 64-bit status words the wrapper keeps for a stream, zeroed once when
// allocated: the tile counter, the irregular flag, then kDescWords a
// tile.
extern "C" int64_t block_decode_state_words(int64_t n) {
  return 2 + (int64_t)kDescWords * ((n + kTile - 1) / kTile);
}

// 32-bit scratch words a call needs for n points: W and S of the general
// path (C lives in rel_ts), one to align, and 3 uint2 chunk sums a block.
extern "C" int64_t block_decode_scratch_words(int64_t n) {
  return 2 * n + 1 + 6 * (int64_t)kFbMaxBlocks;
}

// Decode n points (n < 2^31). ts_pay / v_pay hold ts_len / v_len bytes
// (either may be 0); rel_base is [n] int32 or null (then rel_base_scalar
// applies to every point); value_int selects TSINT (1) or TSF32 (0). The
// int32 arrays and outputs are 16-byte aligned. state holds
// block_decode_state_words(n) words of this stream, tag this call's
// nonzero sequence number (never reused while the words hold it);
// scratch holds block_decode_scratch_words(n) words, 8-byte aligned.
// Returns the CUDA error of the two launches (0 = cudaSuccess).
extern "C" int block_decode_points(
    const int32_t* ts_nb, const uint8_t* ts_pay, int64_t ts_len,
    const int32_t* v_nb, const uint8_t* v_pay, int64_t v_len,
    const int32_t* first_idx, const int32_t* blk_first,
    const int32_t* rel_base, int32_t rel_base_scalar, int32_t value_int,
    int64_t n, uint64_t* state, uint32_t tag, uint32_t* scratch,
    int32_t* rel_ts, float* vals, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const Args args{ts_nb,     ts_pay,   ts_len,          v_nb, v_pay,
                  v_len,     first_idx, blk_first,      rel_base,
                  rel_base_scalar, n,   rel_ts,          vals};
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(value_int ? launch<true>(args, state, tag, scratch, st)
                         : launch<false>(args, state, tag, scratch, st));
}
