// Segment reductions for the downsample core, hand-written for Hopper
// (sm_90a). Built by opentsdb_tpu_torch/ops/cuda_build.py with nvcc into a
// shared library with a plain C interface, loaded through ctypes; the
// wrappers live in opentsdb_tpu_torch/ops/segment_reduce.py.
//
// segment_sum_f32 replaces opentsdb_tpu/ops/pallas_kernels.py
// pallas_segment_sum (body _seg_sum_kernel): out[s, f] = sum of feat[i, f]
// over points i with seg[i] == s; ids outside [0, num_segments) drop out
// (the Pallas kernel's -1 padding contract). The Pallas kernel is a
// one-hot matmul over a (segment tile x point chunk) grid, which suits the
// TPU's MXU and sequential grid. At the query path's shapes (millions of
// segments) a one-hot product is absurd on any machine, and a f32 matmul
// on Hopper risks TF32. Here one thread per (point, feature) element
// reads its value and id once and atomically adds into a zeroed output.
//
// segment_minmax_f32 replaces the XLA segment_min / segment_max of
// opentsdb_tpu/ops/kernels.py (_segment_moments, _group_stage): atomicMin
// and atomicMax on the order-preserving uint32 key of each float (the
// _order_key / _key_to_float mapping of kernels.py), initialised to the
// keys of +inf / -inf, converted back to floats in place at the end.
//
// Bound on the card: bytes. Each element moves 8 bytes in (value + id,
// the id re-read per feature from L1/L2) and does one add or compare,
// so the work is far below Hopper's ~20 flops/byte ridge for f32; the
// floor is (N*K*4 + N*4 + S*K*4) bytes over 3.35 TB/s. Why atomics: the
// sums land in device memory in any order with no second pass and no
// sort, and the query path's points arrive grouped by series and time,
// so most atomics of a warp hit distinct or L2-resident addresses. Float
// atomics add in a run-dependent order: counts and other integral sums
// below 2^24 stay exact, value sums get a stated tolerance. Min and max
// are exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// Enough resident blocks to fill 132 SMs several times over; the
// grid-stride loops cover any remaining elements.
constexpr int64_t kMaxBlocks = 132 * 16;

// Keys of +inf and -inf under the order-preserving mapping below.
constexpr uint32_t kKeyPosInf = 0xFF800000u;
constexpr uint32_t kKeyNegInf = 0x007FFFFFu;

__device__ __forceinline__ uint32_t order_key(float v) {
  uint32_t b = __float_as_uint(v);
  return (b >> 31) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_to_float(uint32_t k) {
  uint32_t b = (k >> 31) ? (k & 0x7FFFFFFFu) : ~k;
  return __uint_as_float(b);
}

int64_t grid_for(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  return blocks < kMaxBlocks ? blocks : kMaxBlocks;
}

__global__ void segment_sum_kernel(const float* __restrict__ feat,
                                   const int32_t* __restrict__ seg,
                                   int64_t n, int32_t k,
                                   int64_t num_segments,
                                   float* __restrict__ out) {
  const int64_t total = n * k;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const int64_t p = i / k;
    const int32_t s = seg[p];
    if (s < 0 || s >= num_segments) continue;
    atomicAdd(out + (int64_t)s * k + (i - p * k), feat[i]);
  }
}

__global__ void fill_keys_kernel(uint32_t* __restrict__ mn,
                                 uint32_t* __restrict__ mx, int64_t m) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += stride) {
    mn[i] = kKeyPosInf;
    mx[i] = kKeyNegInf;
  }
}

__global__ void segment_minmax_kernel(const float* __restrict__ vals,
                                      const int32_t* __restrict__ seg,
                                      int64_t n, int32_t k,
                                      int64_t num_segments,
                                      uint32_t* __restrict__ mn,
                                      uint32_t* __restrict__ mx) {
  const int64_t total = n * k;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const int64_t p = i / k;
    const int32_t s = seg[p];
    if (s < 0 || s >= num_segments) continue;
    const uint32_t key = order_key(vals[i]);
    const int64_t o = (int64_t)s * k + (i - p * k);
    atomicMin(mn + o, key);
    atomicMax(mx + o, key);
  }
}

__global__ void keys_to_floats_kernel(uint32_t* __restrict__ mn,
                                      uint32_t* __restrict__ mx,
                                      int64_t m) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += stride) {
    reinterpret_cast<float*>(mn)[i] = key_to_float(mn[i]);
    reinterpret_cast<float*>(mx)[i] = key_to_float(mx[i]);
  }
}

}  // namespace

// out must hold num_segments * k zeros. Returns cudaGetLastError() after
// the launch (0 = cudaSuccess).
extern "C" int segment_sum_f32(const float* feat, const int32_t* seg,
                               int64_t n, int32_t k, int64_t num_segments,
                               float* out, void* stream) {
  const int64_t total = n * (int64_t)k;
  if (total > 0) {
    segment_sum_kernel<<<(unsigned)grid_for(total), kThreads, 0,
                         (cudaStream_t)stream>>>(feat, seg, n, k,
                                                 num_segments, out);
  }
  return (int)cudaGetLastError();
}

// mn and mx are float buffers of num_segments * k elements, written in
// full: per-segment minima and maxima, +inf / -inf where a segment got no
// element. Returns cudaGetLastError() after the launches.
extern "C" int segment_minmax_f32(const float* vals, const int32_t* seg,
                                  int64_t n, int32_t k, int64_t num_segments,
                                  float* mn, float* mx, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  uint32_t* kmn = reinterpret_cast<uint32_t*>(mn);
  uint32_t* kmx = reinterpret_cast<uint32_t*>(mx);
  const int64_t m = num_segments * (int64_t)k;
  const int64_t total = n * (int64_t)k;
  if (m > 0) {
    fill_keys_kernel<<<(unsigned)grid_for(m), kThreads, 0, s>>>(kmn, kmx, m);
    if (total > 0) {
      segment_minmax_kernel<<<(unsigned)grid_for(total), kThreads, 0, s>>>(
          vals, seg, n, k, num_segments, kmn, kmx);
    }
    keys_to_floats_kernel<<<(unsigned)grid_for(m), kThreads, 0, s>>>(kmn, kmx,
                                                                      m);
  }
  return (int)cudaGetLastError();
}
