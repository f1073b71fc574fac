// Segment reductions for the downsample core, hand-written for Hopper
// (sm_90a). Built by opentsdb_tpu_torch/ops/cuda_build.py with nvcc into a
// shared library with a plain C interface, loaded through ctypes; the
// wrappers live in opentsdb_tpu_torch/ops/segment_reduce.py.
//
// What they replace.
// - segment_sum_f32 replaces opentsdb_tpu/ops/pallas_kernels.py
//   pallas_segment_sum (body _seg_sum_kernel): out[s, f] = sum of
//   feat[i, f] over points i with seg[i] == s. The Pallas kernel is a
//   one-hot matmul over a (segment tile x point chunk) grid, shaped for the
//   TPU's MXU and its sequential grid; at millions of segments a one-hot
//   product is absurd on any machine, and a f32 matmul on Hopper risks
//   TF32. Here the sums are taken in registers or shared memory and land in
//   the zeroed output with atomics.
// - segment_minmax_f32 replaces the XLA segment_min / segment_max of
//   opentsdb_tpu/ops/kernels.py (_segment_moments, _group_stage). It
//   computes only the outputs the caller passes (min, max or both) in
//   place over float storage that the caller filled with +inf / -inf.
// Both take ids in any order; ids outside [0, num_segments) drop out (the
// Pallas kernel's -1 padding contract).
//
// What bounds them: bytes. Each point is read once (K floats and one id)
// and takes one add or compare per feature, far below Hopper's ~20
// flops/byte ridge for f32; the floor is (N*K*4 + N*4 + outputs*S*K*4)
// bytes over 3.35 TB/s. What stood between a one-atomic-per-element kernel
// and that floor was the atomics: one per element, whatever the ids, and
// each lane's atomic a request of its own at the L2. The entry points pick
// one of two designs from num_segments and K:
//
// (a) Run merge, for many segments (the series stage: ids sorted by
//     series and bucket, about 6 points per segment on the query path).
//     Each block of a persistent grid stages a tile of 2048 points (ids and
//     features) in shared memory with 16-byte cp.async, prefetching its
//     next tile while it reduces the current one. Each thread takes 8
//     consecutive points and merges runs of equal ids in registers; a
//     segmented scan over the warp (__shfl_up_sync on run heads) carries a
//     run across thread edges. Every run that ends inside the warp becomes
//     one record (id, K partials) in shared memory, and the warp sends its
//     records together, lane t taking partial t: neighbouring lanes add
//     into neighbouring output words, so one atomic instruction covers a
//     few 32-byte sectors instead of 32 scattered ones. A run that crosses
//     a warp or tile edge gets one atomic per piece, never a plain store,
//     so unsorted ids stay right; with runs of length 1 the K partials of a
//     point still go out together, one sector per point. K is a template
//     parameter for K <= 4, so the loop over (point, feature) has no
//     division. Wider K (the group stage of a group-by into many groups:
//     rows of K = B or 3B bucket columns, gmap sorted, one or a few series
//     per group and the padding rows one long run) merges runs down the
//     columns instead: each thread loads 8 rows of one column into
//     registers at once and sends one atomic per run, and a warp's loads
//     and atomics cover neighbouring columns.
// (b) Shared-memory privatisation, for few segments (num_segments <= 64:
//     the group stage, whole [S, B] rows into a handful of groups, ids in
//     any order). Each block owns a 256-column tile and a slab of rows,
//     reads them with 16-byte loads where K allows, and accumulates
//     [num_segments, 256] partials with shared-memory atomics; then one
//     global atomic per (segment, column) goes out per block, about one
//     block per SM.
//
// Min and max need no key pass: float storage compared with the
// sign-split integer trick. A value with sign bit 0 goes through
// atomicMin/atomicMax on the int view, one with sign bit 1 through
// atomicMax/atomicMin on the unsigned view. Each such update equals taking
// the minimum (maximum) under the order of _order_key (opentsdb_tpu/ops/
// kernels.py), for every bit pattern, -0.0 < +0.0 included, so the result
// is exact and independent of order. Float sums add in a run-dependent
// order: counts and other integral sums below 2^24 stay exact, value sums
// carry a stated tolerance.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

// Which reductions a kernel computes: out0 holds the sum or the minimum,
// out1 the maximum.
enum : int { kSum = 1, kMin = 2, kMax = 4 };

constexpr uint32_t kPosInfBits = 0x7F800000u;
constexpr uint32_t kNegInfBits = 0xFF800000u;

// Design (a): run merge.
constexpr int kRunThreads = 256;
constexpr int kRunPoints = 8;  // consecutive points per thread per tile
constexpr int kRunTile = kRunThreads * kRunPoints;
constexpr int kColThreads = 256;
constexpr int kColRows = 8;  // rows of one column per thread (K > 4)

// Design (b): shared-memory privatisation.
constexpr int64_t kPrivMaxSegments = 64;
constexpr int kPrivThreads = 512;
constexpr int kPrivTileFloats = 256;  // columns per block
constexpr int kPrivUnroll = 4;        // rows in flight per thread

// The order of opentsdb_tpu/ops/kernels.py _order_key: -NaN < -inf < ...
// < -0.0 < +0.0 < ... < +inf < +NaN.
__device__ __forceinline__ uint32_t order_key(float v) {
  const uint32_t b = __float_as_uint(v);
  return (b >> 31) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float omin(float a, float b) {
  return order_key(b) < order_key(a) ? b : a;
}

__device__ __forceinline__ float omax(float a, float b) {
  return order_key(b) > order_key(a) ? b : a;
}

// *p = omin(*p, v), atomically, on shared or global float storage.
__device__ __forceinline__ void atomic_omin(float* p, float v) {
  const int i = __float_as_int(v);
  if (i >= 0) {
    atomicMin(reinterpret_cast<int*>(p), i);
  } else {
    atomicMax(reinterpret_cast<unsigned*>(p), (unsigned)i);
  }
}

// *p = omax(*p, v), atomically, on shared or global float storage.
__device__ __forceinline__ void atomic_omax(float* p, float v) {
  const int i = __float_as_int(v);
  if (i >= 0) {
    atomicMax(reinterpret_cast<int*>(p), i);
  } else {
    atomicMin(reinterpret_cast<unsigned*>(p), (unsigned)i);
  }
}

// A run's partial result: the sum or the minimum in a, the maximum in b.
template <int OPS>
struct Acc {
  float a, b;

  __device__ __forceinline__ void set(float x) {
    a = x;
    b = x;
  }
  __device__ __forceinline__ void add(float x) {
    if constexpr ((OPS & kSum) != 0) a += x;
    if constexpr ((OPS & kMin) != 0) a = omin(a, x);
    if constexpr ((OPS & kMax) != 0) b = omax(b, x);
  }
  // this = left (+) this.
  __device__ __forceinline__ void add_left(const Acc& l) {
    if constexpr ((OPS & kSum) != 0) a = l.a + a;
    if constexpr ((OPS & kMin) != 0) a = omin(l.a, a);
    if constexpr ((OPS & kMax) != 0) b = omax(l.b, b);
  }
  __device__ __forceinline__ Acc shfl_up(int d) const {
    Acc r = *this;
    if constexpr ((OPS & (kSum | kMin)) != 0) r.a = __shfl_up_sync(~0u, a, d);
    if constexpr ((OPS & kMax) != 0) r.b = __shfl_up_sync(~0u, b, d);
    return r;
  }
  // Adds the partial into out0[o] / out1[o]. A partial equal to the
  // output's initial value (0, +inf, -inf) would change nothing and is
  // not sent.
  __device__ __forceinline__ void flush(float* out0, float* out1,
                                        int64_t o) const {
    if constexpr ((OPS & kSum) != 0) {
      if (a != 0.0f) atomicAdd(out0 + o, a);
    }
    if constexpr ((OPS & kMin) != 0) {
      if (__float_as_uint(a) != kPosInfBits) atomic_omin(out0 + o, a);
    }
    if constexpr ((OPS & kMax) != 0) {
      if (__float_as_uint(b) != kNegInfBits) atomic_omax(out1 + o, b);
    }
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// Starts copying src[0:count] into shared dst: 16-byte cp.async where src
// is 16-byte aligned, element by element otherwise and for the tail.
template <class T>
__device__ __forceinline__ void stage(T* dst, const T* src, int count) {
  constexpr int kPer16 = 16 / sizeof(T);
  const int n16 =
      (reinterpret_cast<uintptr_t>(src) & 15) != 0 ? 0 : count / kPer16;
  for (int i = threadIdx.x; i < n16; i += blockDim.x) {
    cp_async16(dst + i * kPer16, src + i * kPer16);
  }
  for (int i = n16 * kPer16 + threadIdx.x; i < count; i += blockDim.x) {
    dst[i] = src[i];
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Shared memory of run_merge_kernel<K, OPS>: the staged tile (ids and
// features) and each warp's run records (id and partials) of one tile.
template <int K, int OPS>
constexpr int run_smem_bytes() {
  constexpr int kOuts = ((OPS & kMin) != 0 && (OPS & kMax) != 0) ? 2 : 1;
  return kRunTile * 4 * (1 + K) + kRunTile * 4 * (1 + K * kOuts);
}

// Writes one run (id s, partials r) into record slot g.
template <int K, int OPS>
__device__ __forceinline__ void put_record(int32_t* r_ids, float* r_a,
                                           float* r_b, int g, int32_t s,
                                           const Acc<OPS> (&r)[K]) {
  r_ids[g] = s;
#pragma unroll
  for (int f = 0; f < K; ++f) {
    if constexpr ((OPS & (kSum | kMin)) != 0) r_a[g * K + f] = r[f].a;
    if constexpr ((OPS & kMax) != 0) r_b[g * K + f] = r[f].b;
  }
}

// Design (a) for K <= 4: see the note at the top.
template <int K, int OPS>
__global__ void __launch_bounds__(kRunThreads, 3)
    run_merge_kernel(const float* __restrict__ feat,
                     const int32_t* __restrict__ seg, int64_t n,
                     int64_t num_segments, float* __restrict__ out0,
                     float* __restrict__ out1) {
  constexpr int kWarpRecords = 32 * kRunPoints;
  extern __shared__ __align__(16) unsigned char s_raw[];
  int32_t* s_ids = reinterpret_cast<int32_t*>(s_raw);
  float* s_feat = reinterpret_cast<float*>(s_ids + kRunTile);
  // This warp's run records: ids, then partials [record][K] per output
  // (r_b == r_a when max is the only output).
  const int warp = threadIdx.x >> 5;
  int32_t* r_ids = reinterpret_cast<int32_t*>(s_feat + kRunTile * K) +
                   warp * kWarpRecords;
  float* r_a = reinterpret_cast<float*>(r_ids - warp * kWarpRecords +
                                        kRunTile) +
               warp * kWarpRecords * K;
  float* r_b = r_a + (((OPS & (kSum | kMin)) != 0 && (OPS & kMax) != 0)
                          ? kRunTile * K
                          : 0);
  const int lane = threadIdx.x & 31;
  const int first = threadIdx.x * kRunPoints;
  const int64_t tiles = (n + kRunTile - 1) / kRunTile;

  if (blockIdx.x < tiles) {
    const int64_t p0 = (int64_t)blockIdx.x * kRunTile;
    const int cnt = (int)(n - p0 < kRunTile ? n - p0 : kRunTile);
    stage(s_ids, seg + p0, cnt);
    stage(s_feat, feat + p0 * K, cnt * K);
  }
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t p0 = tile * kRunTile;
    const int cnt = (int)(n - p0 < kRunTile ? n - p0 : kRunTile);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    int32_t id[kRunPoints];
    float x[kRunPoints * K];
#pragma unroll
    for (int i = 0; i < kRunPoints / 4; ++i) {
      const int4 q = reinterpret_cast<const int4*>(s_ids + first)[i];
      id[4 * i] = q.x;
      id[4 * i + 1] = q.y;
      id[4 * i + 2] = q.z;
      id[4 * i + 3] = q.w;
    }
#pragma unroll
    for (int i = 0; i < kRunPoints * K / 4; ++i) {
      const float4 q = reinterpret_cast<const float4*>(s_feat + first * K)[i];
      x[4 * i] = q.x;
      x[4 * i + 1] = q.y;
      x[4 * i + 2] = q.z;
      x[4 * i + 3] = q.w;
    }
    __syncthreads();
    // The registers hold this tile; the next one streams in meanwhile.
    const int64_t next = tile + gridDim.x;
    if (next < tiles) {
      const int64_t q0 = next * kRunTile;
      const int qcnt = (int)(n - q0 < kRunTile ? n - q0 : kRunTile);
      stage(s_ids, seg + q0, qcnt);
      stage(s_feat, feat + q0 * K, qcnt * K);
    }

    // Points past the end and ids out of range become -1: they break runs
    // and are never sent.
#pragma unroll
    for (int j = 0; j < kRunPoints; ++j) {
      if (first + j >= cnt || id[j] < 0 || id[j] >= num_segments) id[j] = -1;
    }
    const int32_t first_id = id[0], last_id = id[kRunPoints - 1];
    bool single = true;  // the thread's points form one run
#pragma unroll
    for (int j = 1; j < kRunPoints; ++j) single &= id[j] == first_id;
    const int32_t left_last = __shfl_up_sync(~0u, last_id, 1);
    const int32_t right_first = __shfl_down_sync(~0u, first_id, 1);
    // cont: the left lane's trailing run continues into this lane.
    // pass_right: this lane's trailing run continues into the right lane,
    // which then sends it.
    const bool cont = lane > 0 && first_id >= 0 && left_last == first_id;
    const bool pass_right =
        lane < 31 && last_id >= 0 && right_first == last_id;
    const bool send_lead = !single && first_id >= 0;
    const bool send_tail = !pass_right && last_id >= 0;
    // Segmented inclusive scan over lanes, heads where a lane does not
    // extend the run on its left: take bit s marks the steps (distance
    // 1 << s) at which this lane adds its left neighbour's carry.
    unsigned take = 0;
    int head = !(single && cont);
#pragma unroll
    for (int s = 0; s < 5; ++s) {
      const int left_head = __shfl_up_sync(~0u, head, 1 << s);
      if (lane >= (1 << s) && !head) {
        take |= 1u << s;
        head = left_head;
      }
    }
    // Record slots: the runs this lane sends are those that end inside
    // its points after its first run, plus its first (lead) and last
    // (tail) runs where it is the lane that sends them; an exclusive scan
    // of the counts gives each lane its first slot.
    int sends = send_lead + send_tail;
    {
      bool seen = false;
#pragma unroll
      for (int j = 1; j < kRunPoints; ++j) {
        if (id[j] != id[j - 1]) {
          sends += seen && id[j - 1] >= 0;
          seen = true;
        }
      }
    }
    int slot = sends;
#pragma unroll
    for (int s = 0; s < 5; ++s) {
      const int left = __shfl_up_sync(~0u, slot, 1 << s);
      if (lane >= (1 << s)) slot += left;
    }
    const int records = __shfl_sync(~0u, slot, 31);
    slot -= sends;

    Acc<OPS> run[K], lead[K];
#pragma unroll
    for (int f = 0; f < K; ++f) run[f].set(x[f]);
    bool lead_done = false;  // the thread's first run has ended
#pragma unroll
    for (int j = 1; j < kRunPoints; ++j) {
      if (id[j] != id[j - 1]) {
        if (lead_done) {
          if (id[j - 1] >= 0) {
            put_record<K, OPS>(r_ids, r_a, r_b, slot++, id[j - 1], run);
          }
        } else {
#pragma unroll
          for (int f = 0; f < K; ++f) lead[f] = run[f];
          lead_done = true;
        }
#pragma unroll
        for (int f = 0; f < K; ++f) run[f].set(x[j * K + f]);
      } else {
#pragma unroll
        for (int f = 0; f < K; ++f) run[f].add(x[j * K + f]);
      }
    }
#pragma unroll
    for (int s = 0; s < 5; ++s) {
#pragma unroll
      for (int f = 0; f < K; ++f) {
        const Acc<OPS> l = run[f].shfl_up(1 << s);
        if ((take >> s) & 1) run[f].add_left(l);
      }
    }
#pragma unroll
    for (int f = 0; f < K; ++f) {
      const Acc<OPS> in = run[f].shfl_up(1);
      if (cont) lead[f].add_left(in);
    }
    if (send_lead) put_record<K, OPS>(r_ids, r_a, r_b, slot++, first_id, lead);
    if (send_tail) put_record<K, OPS>(r_ids, r_a, r_b, slot, last_id, run);
    __syncwarp();
    // The warp sends its records together, lane t taking partial t of
    // [record][K]: neighbouring lanes hit neighbouring output words, so one
    // atomic instruction covers a few 32-byte sectors instead of 32.
    for (int t = lane; t < records * K; t += 32) {
      const int g = t / K;
      Acc<OPS> part;
      part.a = r_a[t];
      part.b = r_b[t];
      part.flush(out0, out1, (int64_t)r_ids[g] * K + (t - g * K));
    }
    __syncwarp();
  }
}

// Design (a) for K > 4. A block row of kc = min(K, kColThreads) threads
// covers kc neighbouring columns, so each load and each atomic of a warp
// touches neighbouring words; each thread owns one column of kColRows
// consecutive rows, loads them together into registers, merges runs of
// equal ids down the column and sends one atomic per run.
template <int OPS>
__global__ void __launch_bounds__(kColThreads)
    run_merge_cols_kernel(const float* __restrict__ feat,
                          const int32_t* __restrict__ seg, int64_t n,
                          int32_t k, int64_t num_segments,
                          float* __restrict__ out0, float* __restrict__ out1) {
  const int kc = k < kColThreads ? k : kColThreads;
  const int g = threadIdx.x / kc;
  const int64_t col = (int64_t)blockIdx.y * kc + (threadIdx.x - g * kc);
  if (g >= kColThreads / kc || col >= k) return;
  const int64_t r0 =
      ((int64_t)blockIdx.x * (kColThreads / kc) + g) * kColRows;
  int32_t id[kColRows];
  float x[kColRows];
#pragma unroll
  for (int j = 0; j < kColRows; ++j) {
    id[j] = -1;
    x[j] = 0.0f;
    if (r0 + j < n) {
      id[j] = seg[r0 + j];
      x[j] = feat[(r0 + j) * k + col];
      if (id[j] < 0 || id[j] >= num_segments) id[j] = -1;
    }
  }
  Acc<OPS> run;
  run.set(x[0]);
#pragma unroll
  for (int j = 1; j < kColRows; ++j) {
    if (id[j] != id[j - 1]) {
      if (id[j - 1] >= 0) {
        run.flush(out0, out1, (int64_t)id[j - 1] * k + col);
      }
      run.set(x[j]);
    } else {
      run.add(x[j]);
    }
  }
  const int32_t last = id[kColRows - 1];
  if (last >= 0) run.flush(out0, out1, (int64_t)last * k + col);
}

// Design (b): see the note at the top. V = 4 reads 16-byte vectors (K a
// multiple of 4, feat 16-byte aligned), V = 1 single floats. Shared
// memory holds [num_segments][V][ctv] partials per output, so the lanes
// of a warp (neighbouring lc) hit neighbouring banks.
template <int OPS, int V>
__global__ void __launch_bounds__(kPrivThreads)
    privatised_kernel(const float* __restrict__ feat,
                      const int32_t* __restrict__ seg, int64_t n, int32_t k,
                      int32_t num_segments, int ctv, int64_t slab_rows,
                      float* __restrict__ out0, float* __restrict__ out1) {
  extern __shared__ __align__(16) float s_acc[];
  const int len = num_segments * V * ctv;  // per output
  float* acc_a = s_acc;
  float* acc_b = s_acc + ((OPS & (kSum | kMin)) != 0 ? len : 0);
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    if constexpr ((OPS & kSum) != 0) acc_a[i] = 0.0f;
    if constexpr ((OPS & kMin) != 0) acc_a[i] = __uint_as_float(kPosInfBits);
    if constexpr ((OPS & kMax) != 0) acc_b[i] = __uint_as_float(kNegInfBits);
  }
  __syncthreads();

  const int rows_step = kPrivThreads / ctv;
  const int lc = threadIdx.x % ctv, lr = threadIdx.x / ctv;
  const int64_t col0 = (int64_t)blockIdx.x * ctv * V;
  const int64_t col = col0 + (int64_t)lc * V;
  const int64_t r0 = (int64_t)blockIdx.y * slab_rows;
  const int64_t r1 = r0 + slab_rows < n ? r0 + slab_rows : n;
  if (lr < rows_step && col < k) {
    for (int64_t r = r0 + lr; r < r1;
         r += (int64_t)rows_step * kPrivUnroll) {
      int32_t s[kPrivUnroll];
      float v[kPrivUnroll][V];
#pragma unroll
      for (int u = 0; u < kPrivUnroll; ++u) {
        const int64_t row = r + (int64_t)u * rows_step;
        s[u] = -1;
#pragma unroll
        for (int j = 0; j < V; ++j) v[u][j] = 0.0f;
        if (row < r1) {
          s[u] = seg[row];
          const float* src = feat + row * k + col;
          if constexpr (V == 4) {
            const float4 q = *reinterpret_cast<const float4*>(src);
            v[u][0] = q.x;
            v[u][1] = q.y;
            v[u][2] = q.z;
            v[u][3] = q.w;
          } else {
            v[u][0] = *src;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kPrivUnroll; ++u) {
        if (s[u] < 0 || s[u] >= num_segments) continue;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const int a = (s[u] * V + j) * ctv + lc;
          if constexpr ((OPS & kSum) != 0) atomicAdd(acc_a + a, v[u][j]);
          if constexpr ((OPS & kMin) != 0) atomic_omin(acc_a + a, v[u][j]);
          if constexpr ((OPS & kMax) != 0) atomic_omax(acc_b + a, v[u][j]);
        }
      }
    }
  }
  __syncthreads();  // every partial of the block is complete
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    Acc<OPS> part;
    part.a = acc_a[i];
    part.b = acc_b[i];
    const int s = i / (V * ctv);
    const int rem = i - s * V * ctv;
    const int j = rem / ctv;
    const int64_t c = col0 + (int64_t)(rem - j * ctv) * V + j;
    if (c < k) part.flush(out0, out1, (int64_t)s * k + c);
  }
}

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

// Facts that do not change between launches (the SM count, a kernel's
// shared-memory attribute and occupancy) are worked out on a device's
// first launch and kept per device; 0 means not known yet. A failed
// lookup is not kept: it is returned, or left pending for the caller's
// cudaGetLastError.
constexpr int kMaxDevices = 64;

int current_device() {
  int dev = 0;
  return cudaGetDevice(&dev) == cudaSuccess && dev < kMaxDevices ? dev : -1;
}

int sm_count(int dev) {
  static std::atomic<int> known[kMaxDevices];
  int sms = dev >= 0 ? known[dev].load(std::memory_order_relaxed) : 0;
  if (sms > 0) return sms;
  if (dev < 0 ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      sms <= 0) {
    return 1;
  }
  known[dev].store(sms, std::memory_order_relaxed);
  return sms;
}

template <int K, int OPS>
cudaError_t launch_run(const float* feat, const int32_t* seg, int64_t n,
                       int64_t num_segments, float* out0, float* out1,
                       int dev, cudaStream_t st) {
  constexpr int kSmem = run_smem_bytes<K, OPS>();
  static std::atomic<int> known[kMaxDevices];  // blocks per SM
  int per_sm = dev >= 0 ? known[dev].load(std::memory_order_relaxed) : 0;
  if (per_sm == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        run_merge_kernel<K, OPS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmem);
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, run_merge_kernel<K, OPS>, kRunThreads, kSmem);
    }
    if (e != cudaSuccess) return e;
    if (per_sm < 1) per_sm = 1;
    if (dev >= 0) known[dev].store(per_sm, std::memory_order_relaxed);
  }
  // A persistent grid: as many blocks as fit on the card at once.
  const int64_t blocks =
      min64(cdiv(n, kRunTile), (int64_t)sm_count(dev) * per_sm);
  run_merge_kernel<K, OPS><<<(unsigned)blocks, kRunThreads, kSmem, st>>>(
      feat, seg, n, num_segments, out0, out1);
  return cudaSuccess;
}

template <int OPS>
void launch_cols(const float* feat, const int32_t* seg, int64_t n, int32_t k,
                 int64_t num_segments, float* out0, float* out1,
                 cudaStream_t st) {
  const int kc = k < kColThreads ? k : kColThreads;
  const dim3 grid(
      (unsigned)cdiv(n, (int64_t)(kColThreads / kc) * kColRows),
      (unsigned)cdiv(k, kc));
  run_merge_cols_kernel<OPS><<<grid, kColThreads, 0, st>>>(
      feat, seg, n, k, num_segments, out0, out1);
}

template <int OPS, int V>
cudaError_t launch_privatised(const float* feat, const int32_t* seg,
                              int64_t n, int32_t k, int64_t num_segments,
                              float* out0, float* out1, int dev,
                              cudaStream_t st) {
  constexpr int kOuts = ((OPS & kMin) != 0 && (OPS & kMax) != 0) ? 2 : 1;
  static std::atomic<int> known[kMaxDevices];  // 1: attribute set
  if (dev < 0 || known[dev].load(std::memory_order_relaxed) == 0) {
    // Room for the most this kernel takes: kPrivMaxSegments x a whole
    // column tile per output.
    const cudaError_t e = cudaFuncSetAttribute(
        privatised_kernel<OPS, V>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(kOuts * kPrivMaxSegments * kPrivTileFloats * sizeof(float)));
    if (e != cudaSuccess) return e;
    if (dev >= 0) known[dev].store(1, std::memory_order_relaxed);
  }
  const int ctv = (int)min64(k / V, kPrivTileFloats / V);
  const int64_t col_tiles = cdiv(k, (int64_t)ctv * V);
  const int64_t rows_step = kPrivThreads / ctv;
  // About one block per SM over all column tiles.
  int64_t row_blocks = sm_count(dev) / col_tiles;
  row_blocks = min64(row_blocks, cdiv(n, rows_step * kPrivUnroll));
  if (row_blocks < 1) row_blocks = 1;
  const int64_t slab = cdiv(n, row_blocks);
  const dim3 grid((unsigned)col_tiles, (unsigned)row_blocks);
  const size_t smem = (size_t)kOuts * num_segments * V * ctv * sizeof(float);
  privatised_kernel<OPS, V><<<grid, kPrivThreads, smem, st>>>(
      feat, seg, n, k, (int32_t)num_segments, ctv, slab, out0, out1);
  return cudaSuccess;
}

// Picks the design from num_segments and K; n, k, num_segments > 0.
template <int OPS>
cudaError_t launch(const float* feat, const int32_t* seg, int64_t n,
                   int32_t k, int64_t num_segments, float* out0, float* out1,
                   cudaStream_t st) {
  const int dev = current_device();
  if (num_segments <= kPrivMaxSegments) {
    if (k % 4 == 0 && (reinterpret_cast<uintptr_t>(feat) & 15) == 0) {
      return launch_privatised<OPS, 4>(feat, seg, n, k, num_segments, out0,
                                       out1, dev, st);
    }
    return launch_privatised<OPS, 1>(feat, seg, n, k, num_segments, out0,
                                     out1, dev, st);
  }
  switch (k) {
    case 1:
      return launch_run<1, OPS>(feat, seg, n, num_segments, out0, out1,
                                  dev, st);
    case 2:
      return launch_run<2, OPS>(feat, seg, n, num_segments, out0, out1,
                                  dev, st);
    case 3:
      return launch_run<3, OPS>(feat, seg, n, num_segments, out0, out1,
                                  dev, st);
    case 4:
      return launch_run<4, OPS>(feat, seg, n, num_segments, out0, out1,
                                  dev, st);
    default:
      launch_cols<OPS>(feat, seg, n, k, num_segments, out0, out1,
                                 st);
  }
  return cudaSuccess;
}

}  // namespace

// out must hold num_segments * k zeros. Returns the CUDA error of the
// launch (0 = cudaSuccess); launches nothing when there is no work.
extern "C" int segment_sum_f32(const float* feat, const int32_t* seg,
                               int64_t n, int32_t k, int64_t num_segments,
                               float* out, void* stream) {
  if (n > 0 && k > 0 && num_segments > 0) {
    const cudaError_t e = launch<kSum>(feat, seg, n, k, num_segments, out,
                                       nullptr, (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

// mn and mx are float buffers of num_segments * k elements filled with
// +inf and -inf; either may be null, and then that output is not
// computed. Each becomes the per-segment minimum / maximum, left at its
// fill where a segment got no element. Returns the CUDA error of the
// launch (0 = cudaSuccess).
extern "C" int segment_minmax_f32(const float* vals, const int32_t* seg,
                                  int64_t n, int32_t k, int64_t num_segments,
                                  float* mn, float* mx, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaSuccess;
  if (n > 0 && k > 0 && num_segments > 0) {
    if (mn != nullptr && mx != nullptr) {
      e = launch<kMin | kMax>(vals, seg, n, k, num_segments, mn, mx, st);
    } else if (mn != nullptr) {
      e = launch<kMin>(vals, seg, n, k, num_segments, mn, nullptr, st);
    } else if (mx != nullptr) {
      e = launch<kMax>(vals, seg, n, k, num_segments, nullptr, mx, st);
    }
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
