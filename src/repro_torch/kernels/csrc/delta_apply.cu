// Fused dequantize + apply of an int8-blockscale update:
//   out[i] = w[i] + coef * (float(q[i]) * scales[i / block])
//
// Replaces the Pallas TPU kernel of src/repro/kernels/delta_compress.py:
// `delta_apply` (body `_apply_kernel`).  On the port's path the server
// applies the decoded int8 broadcast with coef = +1 (w + q*s) and forms
// the downlink's error-feedback residual with coef = -1 (carried - q*s).
//
// Bound: device memory.  Each element reads w (4 bytes) and q (1 byte)
// and writes out (4 bytes), plus 4 bytes of scale per block: about
// 9 + 4/block bytes against three float operations.  The design is one
// plain pass: a thread covers 4 consecutive elements with a float4 load
// of w, a char4 load of q and a float4 store when w and out are 16-byte
// aligned, q is 4-byte aligned and block % 4 == 0 (the 4 elements then
// share one scale), with a scalar tail for the last n % 4 elements;
// otherwise a coalesced scalar pass.
//
// Bitwise contract with the plain PyTorch version (delta_apply_plain in
// repro_torch/kernels/delta_apply.py) and with the reference's
// ref.delta_apply: the three operations are IEEE round-to-nearest in the
// reference's order and none is contracted: __fmul_rn(float(q), s), then
// __fmul_rn(coef, .), then __fadd_rn(w, .) (no FMA).  With coef = -1 the
// product is exact and w + (-x) is w - x, so the residual equals the
// reference's `carried - recon` bit for bit.  This file must not be built
// with --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;
constexpr int kTile = kThreads * kVec;   // elements per CTA

__device__ __forceinline__ float apply1(float w, signed char q, float s,
                                        float coef) {
  return __fadd_rn(w, __fmul_rn(coef, __fmul_rn(static_cast<float>(q), s)));
}

__global__ void delta_apply_kernel(const float* __restrict__ w,
                                   const signed char* __restrict__ q,
                                   const float* __restrict__ scales,
                                   float* __restrict__ out, int64_t n,
                                   int block, float coef, bool vec) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  if (vec) {
    const int64_t i = base + static_cast<int64_t>(threadIdx.x) * kVec;
    if (i + kVec <= n) {
      const float4 wv = *reinterpret_cast<const float4*>(w + i);
      const char4 qv = *reinterpret_cast<const char4*>(q + i);
      const float s = scales[i / block];
      float4 o;
      o.x = apply1(wv.x, qv.x, s, coef);
      o.y = apply1(wv.y, qv.y, s, coef);
      o.z = apply1(wv.z, qv.z, s, coef);
      o.w = apply1(wv.w, qv.w, s, coef);
      *reinterpret_cast<float4*>(out + i) = o;
    } else {
      for (int64_t j = i; j < n && j < i + kVec; ++j)
        out[j] = apply1(w[j], q[j], scales[j / block], coef);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int64_t j = base + k * kThreads + threadIdx.x;
      if (j < n) out[j] = apply1(w[j], q[j], scales[j / block], coef);
    }
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// w, out (n,) float32, not overlapping; q (n,) int8; scales
// (ceil(n / block),) float32.  Launches on `stream`; returns
// cudaGetLastError() (0 = launched).
extern "C" int delta_apply_launch(const void* w, const void* q,
                                  const void* scales, void* out, int64_t n,
                                  int block, float coef, void* stream) {
  if (n < 1 || block < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t ctas = (n + kTile - 1) / kTile;
  if (ctas > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = aligned(w, 16) && aligned(out, 16) && aligned(q, 4)
                   && block % kVec == 0;
  delta_apply_kernel<<<static_cast<unsigned>(ctas), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<const signed char*>(q),
      static_cast<const float*>(scales), static_cast<float*>(out), n, block,
      coef, vec);
  return static_cast<int>(cudaGetLastError());
}
