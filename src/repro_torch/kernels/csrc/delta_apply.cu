// Fused dequantize + apply of an int8-blockscale update, for all the
// leaves of one broadcast in ONE launch:
//   out[i] = w[i] + coef * (float(q[i]) * scales[i / block])
//
// Replaces the Pallas TPU kernel of src/repro/kernels/delta_compress.py:
// `delta_apply` (body `_apply_kernel`).  On the port's path the server
// applies the decoded int8 broadcast with coef = +1 (w + q*s) and forms
// the downlink's error-feedback residual with coef = -1 (carried - q*s).
//
// Bound: device memory, and at the port's sizes its latency.  Each element
// reads w (4 bytes) and q (1 byte) and writes out (4 bytes), plus 4 bytes
// of scale per block: about 9 + 4/block bytes against three float
// operations.  A broadcast has 28 leaves of 10 to 147,456 elements
// (849,834 in all, 7.7 MB: 2.3 us of the card's bandwidth); one launch per
// leaf ran each at launch latency (about 6 us on an H100), so the leaves
// go in one launch: their w, q and scale pointers, sizes, output offsets
// and first CTAs in a by-value table of up to 64 leaves
// (`__grid_constant__`, no host-to-device copy), one CTA per 1,024-element
// chunk of a leaf, which finds its leaf by a binary search of that table.
// The CTA first reads its chunk's block scales (at most 1,024; 8 at block
// 128) into shared memory, once.  Then a thread covers 4 consecutive
// elements with a float4 load of w, a char4 load of q and a float4 store
// where the leaf's table bit says so (w 16-byte aligned, q 4-byte aligned,
// block % 4 == 0, so the 4 elements share one scale), with a scalar tail
// for the last n % 4 elements; otherwise a coalesced scalar pass.  The
// codec's device sections put each leaf's q at a multiple of 4 bytes in
// one copy of the payload, not of 16, so q is read 4 bytes at a time.  The
// outputs are one flat buffer whose leaf offsets are multiples of 4
// elements.
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
constexpr int kMaxLeaves = 64;

// One launch's leaves, passed by value.
struct LeafTable {
  const float* w[kMaxLeaves];
  const signed char* q[kMaxLeaves];
  const float* s[kMaxLeaves];
  int64_t n[kMaxLeaves];
  int64_t off[kMaxLeaves];          // in the flat output, a multiple of 4
  int chunk_start[kMaxLeaves + 1];  // first CTA of each leaf; [leaves] = all
  unsigned long long vec;           // bit l: leaf l takes the float4 path
  int leaves;
};

__device__ __forceinline__ float apply1(float w, signed char q, float s,
                                        float coef) {
  return __fadd_rn(w, __fmul_rn(coef, __fmul_rn(static_cast<float>(q), s)));
}

__global__ void __launch_bounds__(kThreads)
    delta_apply_leaves_kernel(const __grid_constant__ LeafTable t,
                              float* __restrict__ out, int block,
                              float coef) {
  __shared__ float sc[kTile];
  const int b = static_cast<int>(blockIdx.x);
  int lo = 0, hi = t.leaves - 1;    // the last leaf starting at or before b
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (t.chunk_start[mid] <= b) lo = mid;
    else hi = mid - 1;
  }
  const int64_t n = t.n[lo];
  const int64_t base = static_cast<int64_t>(b - t.chunk_start[lo]) * kTile;
  const int64_t end = n < base + kTile ? n : base + kTile;
  const int64_t s0 = base / block;
  const int ns = static_cast<int>((end - 1) / block - s0 + 1);
  for (int i = threadIdx.x; i < ns; i += kThreads) sc[i] = t.s[lo][s0 + i];
  __syncthreads();
  const float* w = t.w[lo];
  const signed char* q = t.q[lo];
  float* o = out + t.off[lo];
  if ((t.vec >> lo) & 1ull) {
    const int64_t i = base + static_cast<int64_t>(threadIdx.x) * kVec;
    if (i + kVec <= n) {
      const float4 wv = *reinterpret_cast<const float4*>(w + i);
      const char4 qv = *reinterpret_cast<const char4*>(q + i);
      const float s = sc[i / block - s0];
      float4 ov;
      ov.x = apply1(wv.x, qv.x, s, coef);
      ov.y = apply1(wv.y, qv.y, s, coef);
      ov.z = apply1(wv.z, qv.z, s, coef);
      ov.w = apply1(wv.w, qv.w, s, coef);
      *reinterpret_cast<float4*>(o + i) = ov;
    } else {
      for (int64_t j = i; j < n && j < i + kVec; ++j)
        o[j] = apply1(w[j], q[j], sc[j / block - s0], coef);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int64_t j = base + k * kThreads + threadIdx.x;
      if (j < n) o[j] = apply1(w[j], q[j], sc[j / block - s0], coef);
    }
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// `leaves` (1 to 64) leaves in one launch.  w[l], q[l], s[l] (device
// pointers): leaf l's n[l] float32 values, its n[l] int8 levels and its
// ceil(n[l] / block) float32 block scales; its result goes to out + off[l]
// (off[l] a multiple of 4; the outputs overlap no input).  chunk_start
// (leaves + 1 entries, from 0, non-decreasing) gives the first
// 1,024-element CTA of each leaf, the last entry their total.  Launches on
// `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int delta_apply_leaves_launch(int leaves, const uint64_t* w,
                                         const uint64_t* q,
                                         const uint64_t* s, const int64_t* n,
                                         const int64_t* off,
                                         const int* chunk_start, void* out,
                                         int block, float coef,
                                         void* stream) {
  if (leaves < 1 || leaves > kMaxLeaves || block < 1 || chunk_start[0] != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  LeafTable t{};
  t.leaves = leaves;
  const bool out16 = aligned(out, 16) && block % kVec == 0;
  for (int l = 0; l < leaves; ++l) {
    const int64_t chunks = (n[l] + kTile - 1) / kTile;
    if (n[l] < 0 || off[l] % kVec != 0
        || chunk_start[l + 1] - static_cast<int64_t>(chunk_start[l]) != chunks)
      return static_cast<int>(cudaErrorInvalidValue);
    t.w[l] = reinterpret_cast<const float*>(w[l]);
    t.q[l] = reinterpret_cast<const signed char*>(q[l]);
    t.s[l] = reinterpret_cast<const float*>(s[l]);
    t.n[l] = n[l];
    t.off[l] = off[l];
    t.chunk_start[l] = chunk_start[l];
    if (out16 && aligned(t.w[l], 16) && aligned(t.q[l], 4))
      t.vec |= 1ull << l;
  }
  t.chunk_start[leaves] = chunk_start[leaves];
  if (chunk_start[leaves] < 1) return static_cast<int>(cudaErrorInvalidValue);
  delta_apply_leaves_kernel<<<static_cast<unsigned>(chunk_start[leaves]),
                              kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<float*>(out), block, coef);
  return static_cast<int>(cudaGetLastError());
}
