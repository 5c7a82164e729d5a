// Fused threshold-sparsify + per-block symmetric int8 quantization, written
// straight into the v1 `int8-blockscale` wire body: one launch encodes a
// message's leaves, or a cohort's, from the leaves in place to the body.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/delta_compress.py:
// `delta_compress` (body `_compress_kernel`) and `delta_compress_batch`
// (body `_compress_row_kernel`).  The single-buffer (n,) and (K, n)
// entries are the one-leaf case of the grouped launch.
//
// Per row and per `block` consecutive elements of a params leaf:
//   kept  = d * [|d| >= theta]
//   scale = amax(|kept|) / 127, or 1.0 when amax == 0 (all-pad blocks)
//   q     = clip(round_half_even(kept / scale), -127, 127) as int8
// A row of the body holds, per params leaf, its levels padded with zeros
// to a block multiple, then its block scales (float32); then the raw
// float32 leaves (the message's scales section), copied bit for bit.
//
// Bound: device memory.  A client's message reads its 849,834 float32
// params and 1,020 scale floats once and writes its 880,956-byte body once
// (about 1.28 us at 3.35 TB/s) against a handful of float operations per
// element.  The route this replaces padded six leaves, concatenated all 28
// into one buffer, quantized it and concatenated the sections and the
// scales into the body: three passes over the message and about 10 device
// operations (40 for a cohort of 4).  Here the leaves go in a by-value
// table of up to 64 entries (`__grid_constant__`, no host-to-device copy):
// each entry's source pointer, elements a row and row stride, the byte
// offsets of its levels and block scales in the body, its kind (quantize,
// or raw copy: one bit each), a `vec` bit and its first group.  Grid y
// runs over the rows (clients), grid x over CTAs of 8 warps.
//
// Loads in flight: a group (one warp at block 128) covers W consecutive
// blocks of one entry's row (W = 1 or 2, a template argument the wrapper
// picks to keep the grid within two waves of the card), and finds
// its entry in the table itself (`find_entry`), so the 18 leaves of 128
// elements or fewer and the 28 scales leaves of a `vgg11_thinned` message
// take a warp each, not a CTA.  Each lane issues its W 16-byte loads
// before the first reduction, then the warp runs its W shuffle maxima,
// then its W quantize-and-store passes.  With block > 128 (the
// single-buffer entries only) a group is block / 128 warps whose maxima
// meet in shared memory, as in the one-buffer kernel this replaces.  In-row
// offsets are 32-bit (the launcher checks rows below 2^31 elements and
// bytes): with 64-bit ones it held more registers, and fewer CTAs fit an
// SM.  W = 4 was measured slower than 1 and 2 at both main-path shapes, so
// it is not built.
//
// Alignment: a stacked leaf's row r starts at src + r * stride floats (for
// fc1.b, n = 10, that is 4-byte aligned) and the port's leaves may be
// views at 4-element offsets of one buffer, so an entry takes float4 loads
// only when its pointer is 16-byte aligned and its rows start on 16-byte
// boundaries (the table's `vec` bit, set by the wrapper and checked here),
// and only for a lane whose 4 elements lie inside the row; the rest, the
// last partial block among them, are masked scalar loads, lanes past n
// reading 0 (a zero never wins the maximum and quantizes to 0; an all-pad
// block gets the scale-1 sentinel).  Every level section starts at a
// multiple of 4 bytes (padded sizes are block multiples, scale sections
// 4-byte multiples, and the body length too), so a lane's 4 levels go out
// as one char4 store; block scales and the raw section are 4-byte stores.
// TMA (cp.async.bulk) needs 16-byte aligned sources and sizes, which these
// rows do not give, so plain vector loads are the design.
//
// Bitwise contract with the reference (and with the plain PyTorch version
// in repro_torch/kernels/delta_compress.py): the maximum is exact in any
// order; both divisions are IEEE round-to-nearest (__fdiv_rn, never the
// fast approximate divide, and this file must not be built with
// --use_fast_math); rounding is rintf (half to even, like jnp.round); the
// clip happens in float before the int8 conversion; no FMA touches these
// values.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kChunk = 128;          // elements one warp covers a slot
constexpr int kWarpsPerCta = 8;
constexpr int kMaxLeaves = 64;
constexpr int kCoarse = 8;           // entries a step of the group's search

// One entry: a leaf's rows.  Offsets are bytes into one body row.
struct Entry {
  const float* src;
  int n;                             // elements a row
  int stride;                        // elements between rows
  int q_off;                         // levels, or the raw copy
  int s_off;                         // block scales
};

// One launch's entries, passed by value.
struct LeafTable {
  Entry e[kMaxLeaves];
  int group_start[kMaxLeaves + 1];   // first group of each entry, then the
                                     // total; INT_MAX past it
  unsigned long long raw;            // bit l: entry l is a raw float32 copy
  unsigned long long vec;            // bit l: entry l takes float4 loads
};

__device__ __forceinline__ float keep(float v, float theta) {
  return fabsf(v) >= theta ? v : 0.0f;
}

__device__ __forceinline__ signed char quant(float kept, float scale) {
  float r = rintf(__fdiv_rn(kept, scale));
  r = fminf(fmaxf(r, -127.0f), 127.0f);
  return static_cast<signed char>(r);
}

// The entry group g belongs to: the last one starting at or before g.  A
// binary search of the table would be six dependent reads of the
// parameter bank; this takes two rounds of independent reads: every 8th
// start (compile-time offsets), then the 7 starts after the one found.
__device__ __forceinline__ int find_entry(const LeafTable& t, int g) {
  int c = 0;
#pragma unroll
  for (int k = 1; k < kMaxLeaves / kCoarse; ++k)
    c += t.group_start[kCoarse * k] <= g;
  int lo = kCoarse * c;
  const int* fine = t.group_start + lo;
#pragma unroll
  for (int j = 1; j < kCoarse; ++j) lo += fine[j] <= g;
  return lo;
}

template <int W>
__global__ void __launch_bounds__(kWarp * kWarpsPerCta)
    int8_encode_kernel(const __grid_constant__ LeafTable t,
                       unsigned char* __restrict__ body, int64_t row_bytes,
                       int block, float theta) {
  extern __shared__ float part_max[];   // [W][warps], when block > 128
  const int wpb = block / kChunk;       // warps a group (one block a slot)
  const int groups = kWarpsPerCta / wpb;
  const int warps = wpb * groups;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int part = warp % wpb;
  const int g = static_cast<int>(blockIdx.x) * groups + warp / wpb;
  const int lo = find_entry(t, g);
  const Entry e = t.e[lo];
  const bool raw = (t.raw >> lo) & 1ull;    // uniform over the group
  const bool vec = (t.vec >> lo) & 1ull;
  const int n = e.n;
  const int blk0 = (g - t.group_start[lo]) * W;
  const int lane_off = part * kChunk + lane * 4;
  const int64_t row = blockIdx.y;
  const float* src = e.src + row * e.stride;
  unsigned char* out = body + row * row_bytes;

  float v[W][4];
#pragma unroll
  for (int j = 0; j < W; ++j) {         // all W loads before any use
    const int i = (blk0 + j) * block + lane_off;
    if (vec && i + 4 <= n) {
      const float4 x = *reinterpret_cast<const float4*>(src + i);
      v[j][0] = x.x;
      v[j][1] = x.y;
      v[j][2] = x.z;
      v[j][3] = x.w;
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) v[j][c] = i + c < n ? src[i + c] : 0.0f;
    }
  }
  float m[W];
  if (raw) {                            // copied as loaded, bit for bit
    float* o = reinterpret_cast<float*>(out + e.q_off);
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const int i = (blk0 + j) * block + lane_off;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (i + c < n) o[i + c] = v[j][c];
      m[j] = 0.0f;
    }
  } else {
#pragma unroll
    for (int j = 0; j < W; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) v[j][c] = keep(v[j][c], theta);
      m[j] = fmaxf(fmaxf(fabsf(v[j][0]), fabsf(v[j][1])),
                   fmaxf(fabsf(v[j][2]), fabsf(v[j][3])));
    }
#pragma unroll
    for (int o = kWarp / 2; o > 0; o >>= 1) {
#pragma unroll
      for (int j = 0; j < W; ++j)
        m[j] = fmaxf(m[j], __shfl_xor_sync(0xffffffffu, m[j], o));
    }
  }
  if (wpb > 1) {                        // uniform: block is an argument
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < W; ++j) part_max[j * warps + warp] = m[j];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < W; ++j) {
      float mm = 0.0f;
      for (int w = 0; w < wpb; ++w)
        mm = fmaxf(mm, part_max[j * warps + (warp - part) + w]);
      m[j] = mm;
    }
  }
  if (raw) return;

  signed char* q = reinterpret_cast<signed char*>(out + e.q_off);
  float* scales = reinterpret_cast<float*>(out + e.s_off);
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const int blk = blk0 + j;
    if (blk * block >= n) break;        // blk grows with j
    const float scale = m[j] > 0.0f ? __fdiv_rn(m[j], 127.0f) : 1.0f;
    char4 c;
    c.x = quant(v[j][0], scale);
    c.y = quant(v[j][1], scale);
    c.z = quant(v[j][2], scale);
    c.w = quant(v[j][3], scale);
    *reinterpret_cast<char4*>(q + blk * block + lane_off) = c;
    if (part == 0 && lane == 0) scales[blk] = scale;
  }
}

bool aligned(uint64_t p, uint64_t bytes) { return p % bytes == 0; }

template <int W>
int launch(const LeafTable& t, int leaves, unsigned char* body, int64_t rows,
           int64_t row_bytes, int block, float theta, cudaStream_t stream) {
  const int wpb = block / kChunk;
  const int groups = kWarpsPerCta / wpb;
  const int threads = kWarp * wpb * groups;
  const size_t smem = wpb > 1 ? sizeof(float) * W * (threads / kWarp) : 0;
  const dim3 grid(static_cast<unsigned>(
                      (t.group_start[leaves] + groups - 1) / groups),
                  static_cast<unsigned>(rows));
  int8_encode_kernel<W><<<grid, threads, smem, stream>>>(t, body, row_bytes,
                                                          block, theta);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `leaves` (1 to 64) entries of `rows` (1 to 65,535) rows in one launch.
// Entry l: src[l] (a device pointer) holds rows of n[l] float32 values,
// stride[l] floats apart.  A quantize entry writes each row's
// ceil(n / block) * block levels at body byte q_off[l] and its block
// scales at s_off[l]; a raw entry (bit l of `raw`) copies the n[l] floats
// to q_off[l].  Row r of the body starts at body + r * row_bytes (below
// 2^31 bytes, a multiple of 4).  A group of block / 128 warps covers
// per_warp blocks of an entry's row; group_start (leaves + 1 entries,
// from 0, non-decreasing) gives the first group of each entry, the last
// entry the total, and a CTA holds 8 / (block / 128) groups.  Bit l of
// `vec` asks for float4 loads, allowed where src[l] is 16-byte aligned and
// stride[l] a multiple of 4 (or one row).  block is a multiple of 128 in
// [128, 1024], per_warp 1 or 2.  Launches on `stream`; returns
// cudaGetLastError() (0 = launched).
extern "C" int int8_encode_launch(int leaves, const uint64_t* src,
                                  const int64_t* n, const int64_t* stride,
                                  const int64_t* q_off, const int64_t* s_off,
                                  const int* group_start, uint64_t raw,
                                  uint64_t vec, void* body, int64_t rows,
                                  int64_t row_bytes, int block, int per_warp,
                                  float theta, void* stream) {
  const int64_t kLimit = (1ll << 31) - (1 << 14);   // int32 in-row offsets
  if (leaves < 1 || leaves > kMaxLeaves || rows < 1 || rows > 65535
      || block < kChunk || block > kChunk * kWarpsPerCta || block % kChunk
      || (per_warp != 1 && per_warp != 2)
      || row_bytes < 0 || row_bytes % 4 || row_bytes > kLimit
      || group_start[0] != 0
      || !aligned(reinterpret_cast<uint64_t>(body), 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t span = static_cast<int64_t>(per_warp) * block;
  LeafTable t{};
  t.raw = raw;
  t.vec = vec;
  for (int l = 0; l < leaves; ++l) {
    const bool is_raw = (raw >> l) & 1ull;
    const int64_t groups = (n[l] + span - 1) / span;
    if (n[l] < 0 || n[l] > kLimit || stride[l] < 0 || stride[l] > kLimit
        || q_off[l] < 0 || q_off[l] % 4 || q_off[l] > kLimit
        || (!is_raw && (s_off[l] < 0 || s_off[l] % 4 || s_off[l] > kLimit))
        || group_start[l + 1] - static_cast<int64_t>(group_start[l])
               != groups)
      return static_cast<int>(cudaErrorInvalidValue);
    if (((vec >> l) & 1ull)
        && (!aligned(src[l], 16) || (rows > 1 && stride[l] % 4 != 0)))
      return static_cast<int>(cudaErrorInvalidValue);
    t.e[l] = Entry{reinterpret_cast<const float*>(src[l]),
                   static_cast<int>(n[l]), static_cast<int>(stride[l]),
                   static_cast<int>(q_off[l]), static_cast<int>(s_off[l])};
    t.group_start[l] = group_start[l];
  }
  t.group_start[leaves] = group_start[leaves];
  for (int l = leaves + 1; l <= kMaxLeaves; ++l) t.group_start[l] = INT_MAX;
  if (group_start[leaves] < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned char* out = static_cast<unsigned char*>(body);
  if (per_warp == 1)
    return launch<1>(t, leaves, out, rows, row_bytes, block, theta, s);
  return launch<2>(t, leaves, out, rows, row_bytes, block, theta, s);
}
