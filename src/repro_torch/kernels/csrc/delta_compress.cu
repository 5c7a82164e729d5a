// Fused threshold-sparsify + per-block symmetric int8 quantization.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/delta_compress.py:
// `delta_compress` (body `_compress_kernel`) and `delta_compress_batch`
// (body `_compress_row_kernel`).  One launch serves both: the (n,) variant
// is the K = 1 case of the (K, p) launch.
//
// Per row and per `block` consecutive elements:
//   kept  = d * [|d| >= theta]
//   scale = amax(|kept|) / 127, or 1.0 when amax == 0 (all-pad blocks)
//   q     = clip(round_half_even(kept / scale), -127, 127) as int8
//
// Bound: device memory.  Each element is read once (4 bytes) and written
// once (1 byte), plus 4 bytes of scale per block: about 5 + 4/128 bytes
// per element against a handful of float operations.  The design keeps it
// to that one pass: one warp covers one 128-element chunk with one float4
// load per lane, the block maximum is a shuffle reduction (plus a shared
// memory step across the warps of a block when block > 128), and the int8
// results go out as one char4 store per lane.
//
// Bitwise contract with the reference (and with the plain PyTorch version
// in repro_torch/kernels/delta_compress.py): the maximum is exact in any
// order; both divisions are IEEE round-to-nearest (__fdiv_rn, never the
// fast approximate divide, and this file must not be built with
// --use_fast_math); rounding is rintf (half to even, like jnp.round); the
// clip happens in float before the int8 conversion.
//
// Layout: d is (rows, p) float32, row-major and 16-byte aligned, with p a
// multiple of `block`; q is (rows, p) int8; scales is (rows, p / block).
// The caller pads ragged rows with zeros (a zero never wins the maximum
// and quantizes to 0).  Grid: x over groups of blocks, y over rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kChunk = 128;          // elements one warp covers (32 x float4)
constexpr int kWarpsPerCta = 8;

__device__ __forceinline__ float keep(float v, float theta) {
  return fabsf(v) >= theta ? v : 0.0f;
}

__device__ __forceinline__ signed char quant(float kept, float scale) {
  float r = rintf(__fdiv_rn(kept, scale));
  r = fminf(fmaxf(r, -127.0f), 127.0f);
  return static_cast<signed char>(r);
}

__global__ void delta_compress_kernel(const float* __restrict__ d,
                                      signed char* __restrict__ q,
                                      float* __restrict__ scales,
                                      int64_t p, int block,
                                      int blocks_per_cta, float theta) {
  extern __shared__ float warp_max[];
  const int warps_per_block = block / kChunk;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int local_block = warp / warps_per_block;
  const int part = warp % warps_per_block;
  const int64_t nblk = p / block;
  const int64_t row = blockIdx.y;
  const int64_t blk = static_cast<int64_t>(blockIdx.x) * blocks_per_cta
                      + local_block;
  const bool active = blk < nblk;
  const int64_t off = row * p + blk * block
                      + static_cast<int64_t>(part) * kChunk + lane * 4;

  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (active) v = *reinterpret_cast<const float4*>(d + off);
  v.x = keep(v.x, theta);
  v.y = keep(v.y, theta);
  v.z = keep(v.z, theta);
  v.w = keep(v.w, theta);

  float m = fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w)));
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (warps_per_block > 1) {  // uniform over the CTA: block is an argument
    if (lane == 0) warp_max[warp] = m;
    __syncthreads();
    m = 0.0f;
    for (int w = 0; w < warps_per_block; ++w)
      m = fmaxf(m, warp_max[local_block * warps_per_block + w]);
  }
  if (!active) return;

  const float scale = m > 0.0f ? __fdiv_rn(m, 127.0f) : 1.0f;
  char4 out;
  out.x = quant(v.x, scale);
  out.y = quant(v.y, scale);
  out.z = quant(v.z, scale);
  out.w = quant(v.w, scale);
  *reinterpret_cast<char4*>(q + off) = out;
  if (part == 0 && lane == 0) scales[row * nblk + blk] = scale;
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int delta_compress_launch(const void* d, void* q, void* scales,
                                     int64_t rows, int64_t p, int block,
                                     float theta, void* stream) {
  if (block < kChunk || block > kChunk * kWarpsPerCta || block % kChunk != 0
      || rows < 1 || rows > 65535 || p < 1 || p % block != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int warps_per_block = block / kChunk;
  const int blocks_per_cta = kWarpsPerCta / warps_per_block;
  const int threads = kWarp * warps_per_block * blocks_per_cta;
  const int64_t nblk = p / block;
  const int64_t groups = (nblk + blocks_per_cta - 1) / blocks_per_cta;
  if (groups > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(groups), static_cast<unsigned>(rows));
  const size_t smem = sizeof(float) * warps_per_block * blocks_per_cta;
  delta_compress_kernel<<<grid, threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(d), static_cast<signed char*>(q),
      static_cast<float*>(scales), p, block, blocks_per_cta, theta);
  return static_cast<int>(cudaGetLastError());
}
