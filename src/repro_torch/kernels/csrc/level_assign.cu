// Fused error-feedback carry + threshold sparsify + uniform quantization:
// the client's Eq. 5 -> sparsify -> quantize chain in one pass.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/level_assign.py:
// `level_assign` (body `_level_assign_kernel`).  Per element of a row:
//   carried = d + r                                  (Eq. 5 carry)
//   kept    = |carried| >= theta ? carried : 0       (threshold sparsify)
//   q       = clip(round_half_even(kept / step), -max_level, max_level)
//   levels  = (int32) q
//   carry   = carried - q * step                     (next residual)
// theta is a float32 read from device memory, so a top-k threshold
// computed on the device never has to come back to the host.
//
// Two entry points.  `level_assign_launch` takes (rows, n) with one theta
// and one step.  `level_assign_leaves_launch` takes a client's (or a
// broadcast's) leaves in ONE launch, each leaf with its own theta (a
// device array, one per leaf) and its own step (by value); or a cohort's:
// each leaf stacked over the cohort's rows, one theta per row and leaf,
// the rows on grid y, so the batched client round takes one launch for
// all its clients where each client took one.
//
// Bound: device memory.  Each element reads d and r (8 bytes) and writes the
// level and the carry (8 bytes): 16 bytes against about 8 float operations,
// far below the card's float32 rate.  A leaf of the port's model holds 32 to
// 147,456 elements, so one launch per leaf ran at launch latency: on an H100,
// a client's 28 launches took about 25 times what the bytes of its 849,834
// elements need.  So the grouped entry covers up to 64 leaves a launch: their
// input pointers, sizes, output offsets, steps and the first CTA of each leaf
// go in a by-value table (no host-to-device copy), one CTA per 1,024-element
// chunk of the concatenation finds its leaf by a binary search of that table,
// and the outputs are two flat buffers whose leaf offsets are multiples of 4
// elements.  Within a chunk the pass is the plain one with 16-byte accesses: a
// thread covers 4 consecutive elements with float4/int4 loads and stores when
// every pointer is 16-byte aligned and each row starts on a 16-byte boundary
// (n % 4 == 0, or one row), with a scalar tail for the last n % 4 elements;
// otherwise a coalesced scalar pass.
//
// Bitwise contract with the plain PyTorch version (level_assign_plain in
// repro_torch/kernels/level_assign.py) and with the reference's
// ref.level_assign: every operation is IEEE round-to-nearest and none is
// contracted: __fadd_rn, __fdiv_rn (never the approximate divide),
// __fmul_rn and __fsub_rn (no FMA); rintf rounds half to even like
// torch.round and jnp.round; the clip happens in float before the int32
// conversion.  This file must not be built with --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;
constexpr int kTile = kThreads * kVec;   // elements of one row per CTA

__device__ __forceinline__ void assign(float d, float r, float theta,
                                       float step, float max_level,
                                       int* lv, float* carry) {
  const float carried = __fadd_rn(d, r);
  const float kept = fabsf(carried) >= theta ? carried : 0.0f;
  float q = rintf(__fdiv_rn(kept, step));
  q = fminf(fmaxf(q, -max_level), max_level);
  *lv = static_cast<int>(q);
  *carry = __fsub_rn(carried, __fmul_rn(q, step));
}

// Elements [base, base + kTile) of one row of n elements.
__device__ __forceinline__ void assign_chunk(const float* __restrict__ dr,
                                             const float* __restrict__ rr,
                                             int* __restrict__ lr,
                                             float* __restrict__ cr,
                                             int64_t base, int64_t n,
                                             float theta, float step,
                                             float max_level, bool vec) {
  if (vec) {
    const int64_t i = base + static_cast<int64_t>(threadIdx.x) * kVec;
    if (i + kVec <= n) {
      const float4 dv = *reinterpret_cast<const float4*>(dr + i);
      const float4 rv = *reinterpret_cast<const float4*>(rr + i);
      int4 lo;
      float4 co;
      assign(dv.x, rv.x, theta, step, max_level, &lo.x, &co.x);
      assign(dv.y, rv.y, theta, step, max_level, &lo.y, &co.y);
      assign(dv.z, rv.z, theta, step, max_level, &lo.z, &co.z);
      assign(dv.w, rv.w, theta, step, max_level, &lo.w, &co.w);
      *reinterpret_cast<int4*>(lr + i) = lo;
      *reinterpret_cast<float4*>(cr + i) = co;
    } else {
      for (int64_t j = i; j < n && j < i + kVec; ++j)
        assign(dr[j], rr[j], theta, step, max_level, lr + j, cr + j);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int64_t j = base + k * kThreads + threadIdx.x;
      if (j < n) assign(dr[j], rr[j], theta, step, max_level, lr + j, cr + j);
    }
  }
}

__global__ void level_assign_kernel(const float* __restrict__ d,
                                    const float* __restrict__ r,
                                    const float* __restrict__ theta_p,
                                    const float* __restrict__ step_p,
                                    int* __restrict__ lv,
                                    float* __restrict__ carry, int64_t n,
                                    float max_level, bool vec) {
  const int64_t row = static_cast<int64_t>(blockIdx.y) * n;
  assign_chunk(d + row, r + row, lv + row, carry + row,
               static_cast<int64_t>(blockIdx.x) * kTile, n, *theta_p,
               *step_p, max_level, vec);
}

constexpr int kMaxLeaves = 64;

// One launch's leaves, passed by value.
struct LeafTable {
  const float* d[kMaxLeaves];
  const float* r[kMaxLeaves];
  int64_t n[kMaxLeaves];
  int64_t off[kMaxLeaves];          // in the flat outputs, a multiple of 4
  float step[kMaxLeaves];
  int chunk_start[kMaxLeaves + 1];  // first CTA of each leaf; [leaves] = all
  unsigned long long vec;           // bit l: leaf l takes the float4 path
  int leaves;
};

// Grid y is the cohort row z of `rows`: leaf l's input row at d[l] + z *
// n[l], its outputs at rows * off[l] + z * n[l] (each leaf's rows
// contiguous), its theta at thetas[z * th_stride + l].
__global__ void level_assign_leaves_kernel(
    const __grid_constant__ LeafTable t, const float* __restrict__ thetas,
    int* __restrict__ lv, float* __restrict__ carry, float max_level,
    int64_t th_stride) {
  const int b = static_cast<int>(blockIdx.x);
  const int64_t z = blockIdx.y;
  int lo = 0, hi = t.leaves - 1;    // the last leaf starting at or before b
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (t.chunk_start[mid] <= b) lo = mid;
    else hi = mid - 1;
  }
  const int64_t in = z * t.n[lo];
  const int64_t off = static_cast<int64_t>(gridDim.y) * t.off[lo] + in;
  assign_chunk(t.d[lo] + in, t.r[lo] + in, lv + off, carry + off,
               static_cast<int64_t>(b - t.chunk_start[lo]) * kTile, t.n[lo],
               thetas[z * th_stride + lo], t.step[lo], max_level,
               (t.vec >> lo) & 1ull);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// d, r, lv and carry are (rows, n) row-major; theta and step point to one
// float32 each in device memory.  Launches on `stream`; returns
// cudaGetLastError() (0 = launched).
extern "C" int level_assign_launch(const void* d, const void* r,
                                   const void* theta, const void* step,
                                   void* lv, void* carry, int64_t rows,
                                   int64_t n, float max_level, void* stream) {
  if (rows < 1 || rows > 65535 || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t chunks = (n + kTile - 1) / kTile;
  if (chunks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = aligned16(d) && aligned16(r) && aligned16(lv)
                   && aligned16(carry) && (n % kVec == 0 || rows == 1);
  const dim3 grid(static_cast<unsigned>(chunks), static_cast<unsigned>(rows));
  level_assign_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(d), static_cast<const float*>(r),
      static_cast<const float*>(theta), static_cast<const float*>(step),
      static_cast<int*>(lv), static_cast<float*>(carry), n, max_level, vec);
  return static_cast<int>(cudaGetLastError());
}

// `leaves` (1 to 64) leaves in one launch, over `rows` (1 to 65,535)
// cohort rows.  d[l], r[l]: leaf l's rows x n[l] float32 inputs (device
// pointers, row-major); its levels and carry go to the rows x n[l] block
// at lv + rows * off[l] and carry + rows * off[l] (off[l] a multiple of
// 4); step[l] its step; thetas (device) holds row z's theta of leaf l at
// z * th_stride + l; chunk_start (leaves + 1 entries, from 0,
// non-decreasing) gives the first 1,024-element CTA of each leaf's row, the
// last entry their total.  Launches on `stream`; returns cudaGetLastError()
// (0 = launched).
extern "C" int level_assign_leaves_launch(
    int leaves, const uint64_t* d, const uint64_t* r, const int64_t* n,
    const int64_t* off, const float* step, const int* chunk_start,
    const void* thetas, void* lv, void* carry, float max_level, int rows,
    int64_t th_stride, void* stream) {
  if (leaves < 1 || leaves > kMaxLeaves || chunk_start[0] != 0 || rows < 1
      || rows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  LeafTable t{};
  t.leaves = leaves;
  const bool out16 = aligned16(lv) && aligned16(carry);
  for (int l = 0; l < leaves; ++l) {
    const int64_t chunks = (n[l] + kTile - 1) / kTile;
    if (n[l] < 0 || off[l] % kVec != 0
        || chunk_start[l + 1] - static_cast<int64_t>(chunk_start[l]) != chunks)
      return static_cast<int>(cudaErrorInvalidValue);
    t.d[l] = reinterpret_cast<const float*>(d[l]);
    t.r[l] = reinterpret_cast<const float*>(r[l]);
    t.n[l] = n[l];
    t.off[l] = off[l];
    t.step[l] = step[l];
    t.chunk_start[l] = chunk_start[l];
    // every row of the leaf starts 16-byte aligned
    if (out16 && aligned16(t.d[l]) && aligned16(t.r[l])
        && (rows == 1 || n[l] % kVec == 0))
      t.vec |= 1ull << l;
  }
  t.chunk_start[leaves] = chunk_start[leaves];
  if (chunk_start[leaves] < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(chunk_start[leaves]),
                  static_cast<unsigned>(rows));
  level_assign_leaves_kernel<<<grid, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<const float*>(thetas), static_cast<int*>(lv),
      static_cast<float*>(carry), max_level, th_stride);
  return static_cast<int>(cudaGetLastError());
}
