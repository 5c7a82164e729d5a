// Per-row mean |w| of an (M, N) float32 matrix: the Eq. 3 filter scores
// of structured sparsification (a conv weight's OIHW filters, or a dense
// weight's rows, viewed as (M, N)).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/row_stats.py:
// `row_stats` (body `_kernel`).  The TPU kernel walks the columns in a
// sequential grid axis and carries the partial sums in VMEM scratch; here
// nothing carries between blocks, so one warp owns one row and its loop
// over the columns takes the place of that grid axis.
//
// Bound: device memory.  Each element is read once (4 bytes) and the row
// score written once (4 bytes per row), against one |.| and one add per
// element.  The rows on the port's path are short (N = 27 to 1,152), so
// the design is one warp per row, eight rows per CTA: lane l sums
// |w[row, l + 32 k]| in k order (coalesced loads), then a butterfly
// shuffle adds the 32 partial sums in a fixed order, and lane 0 writes
// __fdiv_rn(sum, N).  The result is deterministic; it is not bitwise
// equal to torch.mean, whose summation order differs, and is held to it
// at rtol 1e-6.  This file must not be built with --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerCta = 8;

__global__ void row_stats_kernel(const float* __restrict__ w,
                                 float* __restrict__ out, int64_t m,
                                 int64_t n) {
  const int lane = threadIdx.x % kWarp;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarpsPerCta
                      + threadIdx.x / kWarp;
  if (row >= m) return;   // uniform over the warp
  const float* r = w + row * n;
  float acc = 0.0f;
  for (int64_t j = lane; j < n; j += kWarp) acc = __fadd_rn(acc, fabsf(r[j]));
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, o));
  if (lane == 0) out[row] = __fdiv_rn(acc, static_cast<float>(n));
}

}  // namespace

// w (m, n) float32 row-major; out (m,) float32.  Launches on `stream`;
// returns cudaGetLastError() (0 = launched).
extern "C" int row_stats_launch(const void* w, void* out, int64_t m,
                                int64_t n, void* stream) {
  if (m < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t ctas = (m + kWarpsPerCta - 1) / kWarpsPerCta;
  if (ctas > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  row_stats_kernel<<<static_cast<unsigned>(ctas), kWarp * kWarpsPerCta, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<float*>(out), m, n);
  return static_cast<int>(cudaGetLastError());
}
