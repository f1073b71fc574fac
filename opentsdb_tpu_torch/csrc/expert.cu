// The finishing step of the expert-parallel dashboard (parallel/expert.py).
//
// Replaces no Pallas kernel: it is the per-slot traced switch of
// opentsdb_tpu/parallel/expert.py _finish_switch (:279-283), which the
// dashboard body runs twice a moment slot -- over the series stage's
// segment moments with the slot's downsampler (_dash_series_stage,
// :376-388) and over the group moments with the slot's group aggregator
// (_expert_dash_body, :391-419). XLA computes every aggregator's finish
// and selects; here one pass finishes every slot of a shard at once.
//
// dash_finish_f32 -- for slot q of Q and cell c of `cells`, over the
// [Q, cells] float32 planes (count, total, centered m2, min, max) and
// the slot's aggregator code[q] in DASH_AGGS order (sum, min, max, avg,
// dev, count):
//   sum: total; min: min; max: max; avg: total / max(count, 1);
//   dev: sqrt(max(m2, 0) / max(count, 1)); count: count
// (ops/kernels.py _finish). A slot reads only the planes its code needs,
// so a plane no slot of the launch needs may be null. A block handles a
// tile of one slot's cells (blockIdx.y is the slot), so the code is
// uniform across the block and each warp's loads are 32 neighbouring
// words.
//   Bound: bytes. Each slot reads the planes its code needs once (4
// cells bytes each: one for sum, min, max and count, two for avg (count,
// total) and two for dev (count, m2)) and writes its values once (4 cells bytes); the codes are
// 4 Q bytes. At the dashboard's series stage a slot is S * B = 32,768
// cells, at its group stage B = 32.
//
// Rounding: the division and the square root are the correctly rounded
// _rn intrinsics, as torch computes them, so the kernel and its plain
// version (ops/expert_finish.py) agree bit for bit. Never build this file
// with --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

enum Agg { kSum = 0, kMin = 1, kMax = 2, kAvg = 3, kDev = 4, kCount = 5 };

__global__ void __launch_bounds__(kThreads)
dash_finish_kernel(const float* __restrict__ count,
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
        v = __fdiv_rn(total[i], fmaxf(count[i], 1.0f));
        break;
      case kDev: {
        // clamp(m2, min=0) keeps a NaN, as torch.clamp does.
        const float m = m2[i] < 0.0f ? 0.0f : m2[i];
        v = __fsqrt_rn(__fdiv_rn(m, fmaxf(count[i], 1.0f)));
        break;
      }
      default:
        v = count[i];
        break;
    }
    out[i] = v;
  }
}

}  // namespace

// Planes [Q, cells] row-major float32 (a plane no slot's code reads may be
// null), code [Q] int32 in [0, 6), out [Q, cells] float32. Q <= 65,535.
// Returns the CUDA error of the launch (0 = cudaSuccess), or
// cudaErrorInvalidValue past 65,535 slots.
extern "C" int dash_finish_f32(const float* count, const float* total,
                               const float* m2, const float* mn,
                               const float* mx, const int32_t* code,
                               int32_t Q, int64_t cells, float* out,
                               void* stream) {
  if (Q > 65535 || Q < 0) return (int)cudaErrorInvalidValue;
  if (Q > 0 && cells > 0) {
    int64_t bx = (cells + kThreads - 1) / kThreads;
    if (bx > 4096) bx = 4096;
    dim3 grid((unsigned)bx, (unsigned)Q);
    dash_finish_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        count, total, m2, mn, mx, code, cells, out);
  }
  return (int)cudaGetLastError();
}
