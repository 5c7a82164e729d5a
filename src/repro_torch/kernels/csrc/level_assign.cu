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
// theta and step are float32 scalars read from device memory, so a top-k
// threshold computed on the device never has to come back to the host.
//
// Bound: device memory.  Each element reads d and r (8 bytes) and writes
// the level and the carry (8 bytes): 16 bytes against about 8 float
// operations, far below the card's float32 rate.  The design is one plain
// pass with 16-byte accesses: a thread covers 4 consecutive elements with
// float4/int4 loads and stores when every pointer is 16-byte aligned and
// each row starts on a 16-byte boundary (n % 4 == 0, or one row), with a
// scalar tail for the last n % 4 elements; otherwise a coalesced scalar
// pass.  Grid: x over chunks of 1,024 elements, y over rows.
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

__global__ void level_assign_kernel(const float* __restrict__ d,
                                    const float* __restrict__ r,
                                    const float* __restrict__ theta_p,
                                    const float* __restrict__ step_p,
                                    int* __restrict__ lv,
                                    float* __restrict__ carry, int64_t n,
                                    float max_level, bool vec) {
  const float theta = *theta_p;
  const float step = *step_p;
  const int64_t row = static_cast<int64_t>(blockIdx.y) * n;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  const float* dr = d + row;
  const float* rr = r + row;
  int* lr = lv + row;
  float* cr = carry + row;
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
