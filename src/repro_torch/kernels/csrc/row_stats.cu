// Per-row mean |w| of (M, N) float32 matrices: the Eq. 3 filter scores
// of structured sparsification (a conv weight's OIHW filters, or a dense
// weight's rows, viewed as (M, N)), for all the weight views of one client
// (or of one broadcast) in ONE launch.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/row_stats.py:
// `row_stats` (body `_kernel`).  The TPU kernel walks the columns in a
// sequential grid axis and carries the partial sums in VMEM scratch; here
// nothing carries between blocks, so one warp owns one row and its loop
// over the columns takes the place of that grid axis.
//
// Bound: device memory, and at the port's sizes its latency.  Each element
// is read once (4 bytes) and each row's score written once, against one
// |.| and one add per element.  A client's 10 weight views hold 1,002 rows
// of 27 to 1,152 floats, 3.4 MB: a microsecond of the card's bandwidth.
// One launch per view ran each at launch latency (about 6 us on an H100
// for well under one of memory traffic), so the views go in one launch:
// their pointers, shapes, output offsets and first CTAs in a by-value
// table of up to 64 views (`__grid_constant__`, no host-to-device copy),
// one CTA per 8 rows of a view, which finds its view by a binary search
// of that table.  Each warp stages its row in shared memory with
// cp.async, every copy of the row in flight at once (16-byte copies from
// the first 16-byte boundary of the row on, 4-byte copies for the head
// and tail; rows of 27 floats start anywhere), then sums from shared
// memory.  A row longer than 1,280 floats goes through in tiles of 1,280.
//
// Float order: lane l sums |w[row, l + 32 k]| in k order (a tile is a
// multiple of 32 wide, so tiles keep that order), then a butterfly
// shuffle adds the 32 partial sums in a fixed order, and lane 0 writes
// __fdiv_rn(sum, N).  That is the order of the one-launch-per-view kernel
// this design replaces, so the two agree bit for bit; the result is
// deterministic.  It is not bitwise equal to torch.mean, whose summation
// order differs, and is held to it at rtol 1e-6.  A view with no columns
// gets 0 / 0 = NaN, as torch.mean does.  This file must not be built with
// --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerCta = 8;            // one warp a row
constexpr int kTileCols = 40 * kWarp;     // columns of a row staged at once
constexpr int kSlice = kTileCols + 4;     // a warp's floats of shared memory
constexpr int kMaxViews = 64;

// One launch's views, passed by value.
struct ViewTable {
  const float* w[kMaxViews];
  int64_t m[kMaxViews];
  int64_t n[kMaxViews];
  int64_t off[kMaxViews];            // first score of the view in `out`
  int chunk_start[kMaxViews + 1];    // first CTA of each view; [views] = all
  int views;
};

__device__ __forceinline__ unsigned smem_addr(const float* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__global__ void __launch_bounds__(kWarp * kRowsPerCta)
    row_stats_leaves_kernel(const __grid_constant__ ViewTable t,
                            float* __restrict__ out) {
  __shared__ __align__(16) float stage[kRowsPerCta][kSlice];
  const int b = static_cast<int>(blockIdx.x);
  int lo = 0, hi = t.views - 1;     // the last view starting at or before b
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (t.chunk_start[mid] <= b) lo = mid;
    else hi = mid - 1;
  }
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int64_t row =
      static_cast<int64_t>(b - t.chunk_start[lo]) * kRowsPerCta + warp;
  if (row >= t.m[lo]) return;   // uniform over the warp; no block barrier
  const int64_t n = t.n[lo];
  const float* r = t.w[lo] + row * n;
  float* s = stage[warp];
  float acc = 0.0f;
  for (int64_t c0 = 0; c0 < n; c0 += kTileCols) {
    const int cols = static_cast<int>(n - c0 < kTileCols ? n - c0
                                                         : kTileCols);
    const float* src = r + c0;
    // element e of the tile goes to s[shift + e]: the source and its
    // place in shared memory then share their offset from a 16-byte
    // boundary, and the body between the head and the tail copies in
    // 16-byte pieces
    const int shift = static_cast<int>(
        (reinterpret_cast<uintptr_t>(src) / sizeof(float)) % 4);
    const int head = min(cols, (4 - shift) % 4);
    const int body_end = head + (cols - head) / 4 * 4;
    float* dst = s + shift;
    for (int e = head + 4 * lane; e < body_end; e += 4 * kWarp)
      cp16(dst + e, src + e);
    if (lane < head) cp4(dst + lane, src + lane);
    if (body_end + lane < cols) cp4(dst + body_end + lane,
                                    src + body_end + lane);
    cp_wait_all();
    __syncwarp();
    for (int e = lane; e < cols; e += kWarp)
      acc = __fadd_rn(acc, fabsf(dst[e]));
    __syncwarp();   // read before the next tile overwrites it
  }
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, o));
  if (lane == 0) out[t.off[lo] + row] = __fdiv_rn(acc, static_cast<float>(n));
}

}  // namespace

// `views` (1 to 64) row-major float32 matrices in one launch: w[v] (a
// device pointer) holds m[v] rows of n[v] floats; their scores go to
// out[off[v]], ..., out[off[v] + m[v] - 1].  chunk_start (views + 1
// entries, from 0, non-decreasing) gives the first 8-row CTA of each view,
// the last entry their total.  Launches on `stream`; returns
// cudaGetLastError() (0 = launched).
extern "C" int row_stats_leaves_launch(int views, const uint64_t* w,
                                       const int64_t* m, const int64_t* n,
                                       const int64_t* off,
                                       const int* chunk_start, void* out,
                                       void* stream) {
  if (views < 1 || views > kMaxViews || chunk_start[0] != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  ViewTable t{};
  t.views = views;
  for (int v = 0; v < views; ++v) {
    const int64_t ctas = (m[v] + kRowsPerCta - 1) / kRowsPerCta;
    if (m[v] < 0 || n[v] < 0 || off[v] < 0
        || chunk_start[v + 1] - static_cast<int64_t>(chunk_start[v]) != ctas)
      return static_cast<int>(cudaErrorInvalidValue);
    t.w[v] = reinterpret_cast<const float*>(w[v]);
    t.m[v] = m[v];
    t.n[v] = n[v];
    t.off[v] = off[v];
    t.chunk_start[v] = chunk_start[v];
  }
  t.chunk_start[views] = chunk_start[views];
  if (chunk_start[views] < 1) return static_cast<int>(cudaErrorInvalidValue);
  row_stats_leaves_kernel<<<static_cast<unsigned>(chunk_start[views]),
                            kWarp * kRowsPerCta, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
