// Matrix product with the paper's per-output-row scaling factors (Eq. 4)
// applied at matmul time, and the three products of its backward:
//
//   forward  y[m, n]  = s[n] * sum_k x[m, k] w[n, k]        (M, N)
//   dx       dx[m, k] = sum_n (dy[m, n] s[n]) w[n, k]       (M, K)
//   dw       dw[n, k] = s[n] * sum_m dy[m, n] x[m, k]       (N, K)
//   ds       ds[n]    = sum_m dy[m, n] * (sum_k x[m, k] w[n, k])   (N,)
//
// Replaces the Pallas TPU kernel of src/repro/kernels/scaled_matmul.py:
// `scaled_matmul` (body `_kernel`).  The TPU kernel walks K in a
// sequential grid axis, carries the sum in a VMEM scratch tile and scales
// it when the last K block retires.  Here one CTA owns a 32 x 32 output
// tile, its loop over the reduction axis takes the place of that grid
// axis, and the scale multiplies the register accumulator in the epilogue
// (forward, dw) or the dy tile as it is loaded (dx).  The reference has no
// backward; the port's autograd.Function calls dx in the weight steps (S
// frozen) and in the scale sub-epochs, dw in the weight steps and ds in
// the scale sub-epochs.  ds fuses dy * (x w^T) and the column sum: one CTA
// per 32 columns walks every row tile, so the sum needs no second pass and
// no atomics, and its order is fixed.
//
// Bound: at the port's shapes (M = 32, 120, 960 rows; N = 128 or 10; K =
// 128) each call moves under 1 MB and does under 32 MFLOP, which the card
// finishes in well under the ~2 us a launch costs: launch latency bounds
// it.  So the design is the simplest tiled float32 product that is right:
// 32 x 32 tiles of both operands in shared memory (rows padded to 33
// floats, no bank conflicts), 256 threads, each accumulating 4 outputs of
// one column with fmaf in a fixed k order, so every result is
// deterministic.  No tensor cores: TF32 would round the inputs to 10-bit
// mantissas, and wgmma/TMA tiles are later work.  Operands are addressed
// through strides, so the four products share one kernel body.  This file
// must not be built with --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;     // output tile edge and reduction step
constexpr int kRowsPerThread = 4;
constexpr int kThreadRows = kTile / kRowsPerThread;   // 8
constexpr int kThreads = kTile * kThreadRows;          // 256

// A view of a row-major matrix as op(i, r) = p[i * si + r * sr].
struct View {
  const float* p;
  int64_t si, sr;
};

// The tile of C = A B^T with rows [i0, i0 + 32) and columns [j0, j0 + 32)
// over the reduction length R: acc[q] is C[i0 + ty + 8 q, j0 + tx].  With
// `a_scale`, each A element is multiplied by a_scale[r] as it is loaded.
__device__ void tile_product(View a, View b, const float* a_scale, int64_t P,
                             int64_t Q, int64_t R, int64_t i0, int64_t j0,
                             float (*as)[kTile + 1], float (*bs)[kTile + 1],
                             float acc[kRowsPerThread]) {
  const int tx = threadIdx.x % kTile;
  const int ty = threadIdx.x / kTile;
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) acc[q] = 0.0f;
  for (int64_t r0 = 0; r0 < R; r0 += kTile) {
    for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
      const int ii = e / kTile, rr = e % kTile;
      const int64_t r = r0 + rr;
      float va = 0.0f, vb = 0.0f;
      if (r < R) {
        if (i0 + ii < P) {
          va = a.p[(i0 + ii) * a.si + r * a.sr];
          if (a_scale != nullptr) va = __fmul_rn(va, a_scale[r]);
        }
        if (j0 + ii < Q) vb = b.p[(j0 + ii) * b.si + r * b.sr];
      }
      as[ii][rr] = va;
      bs[ii][rr] = vb;
    }
    __syncthreads();
#pragma unroll 8
    for (int rr = 0; rr < kTile; ++rr) {
      const float vb = bs[tx][rr];
#pragma unroll
      for (int q = 0; q < kRowsPerThread; ++q)
        acc[q] = fmaf(as[ty + kThreadRows * q][rr], vb, acc[q]);
    }
    __syncthreads();
  }
}

// C (P, Q) row-major = A B^T, then scaled by col_scale[j] or row_scale[i]
// (at most one is given) in the epilogue.
__global__ void scaled_matmul_product_kernel(
    View a, View b, const float* a_scale, const float* col_scale,
    const float* row_scale, float* __restrict__ c, int64_t P, int64_t Q,
    int64_t R) {
  __shared__ float as[kTile][kTile + 1];
  __shared__ float bs[kTile][kTile + 1];
  const int64_t i0 = static_cast<int64_t>(blockIdx.y) * kTile;
  const int64_t j0 = static_cast<int64_t>(blockIdx.x) * kTile;
  float acc[kRowsPerThread];
  tile_product(a, b, a_scale, P, Q, R, i0, j0, as, bs, acc);
  const int tx = threadIdx.x % kTile;
  const int ty = threadIdx.x / kTile;
  const int64_t j = j0 + tx;
  if (j >= Q) return;
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) {
    const int64_t i = i0 + ty + kThreadRows * q;
    if (i >= P) continue;
    float v = acc[q];
    if (col_scale != nullptr) v = __fmul_rn(v, col_scale[j]);
    if (row_scale != nullptr) v = __fmul_rn(v, row_scale[i]);
    c[i * Q + j] = v;
  }
}

// ds[n] = sum_m dy[m, n] (x w^T)[m, n]; one CTA per 32 columns n.
__global__ void scaled_matmul_ds_kernel(const float* __restrict__ x,
                                        const float* __restrict__ w,
                                        const float* __restrict__ dy,
                                        float* __restrict__ ds, int64_t M,
                                        int64_t N, int64_t K) {
  __shared__ float as[kTile][kTile + 1];
  __shared__ float bs[kTile][kTile + 1];
  __shared__ float part[kThreadRows][kTile];
  const int tx = threadIdx.x % kTile;
  const int ty = threadIdx.x / kTile;
  const int64_t j0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t j = j0 + tx;
  const View vx{x, K, 1}, vw{w, K, 1};
  float sum = 0.0f;
  for (int64_t i0 = 0; i0 < M; i0 += kTile) {
    float acc[kRowsPerThread];
    tile_product(vx, vw, nullptr, M, N, K, i0, j0, as, bs, acc);
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q) {
      const int64_t i = i0 + ty + kThreadRows * q;
      if (i < M && j < N) sum = fmaf(dy[i * N + j], acc[q], sum);
    }
  }
  part[ty][tx] = sum;
  __syncthreads();
  if (ty == 0 && j < N) {
    float total = part[0][tx];
    for (int t = 1; t < kThreadRows; ++t)
      total = __fadd_rn(total, part[t][tx]);
    ds[j] = total;
  }
}

int launch_product(View a, View b, const float* a_scale,
                   const float* col_scale, const float* row_scale, float* c,
                   int64_t P, int64_t Q, int64_t R, void* stream) {
  if (P < 1 || Q < 1 || R < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t gx = (Q + kTile - 1) / kTile, gy = (P + kTile - 1) / kTile;
  if (gx > 0x7fffffff || gy > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  scaled_matmul_product_kernel<<<grid, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      a, b, a_scale, col_scale, row_scale, c, P, Q, R);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All matrices float32, row-major and contiguous; x (m, k), w (n, k),
// s (n,), dy (m, n).  Each launches on `stream` and returns
// cudaGetLastError() (0 = launched).

// y (m, n) = x @ (s * w)^T, the scale applied to the accumulator.
extern "C" int scaled_matmul_forward(const void* x, const void* w,
                                     const void* s, void* y, int64_t m,
                                     int64_t n, int64_t k, void* stream) {
  const View a{static_cast<const float*>(x), k, 1};
  const View b{static_cast<const float*>(w), k, 1};
  return launch_product(a, b, nullptr, static_cast<const float*>(s), nullptr,
                        static_cast<float*>(y), m, n, k, stream);
}

// dx (m, k) = (dy * s) @ w.
extern "C" int scaled_matmul_dx(const void* dy, const void* w, const void* s,
                                void* dx, int64_t m, int64_t n, int64_t k,
                                void* stream) {
  const View a{static_cast<const float*>(dy), n, 1};
  const View b{static_cast<const float*>(w), 1, k};
  return launch_product(a, b, static_cast<const float*>(s), nullptr, nullptr,
                        static_cast<float*>(dx), m, k, n, stream);
}

// dw (n, k) = s * (dy^T @ x), the scale applied to the accumulator.
extern "C" int scaled_matmul_dw(const void* dy, const void* x, const void* s,
                                void* dw, int64_t m, int64_t n, int64_t k,
                                void* stream) {
  const View a{static_cast<const float*>(dy), 1, n};
  const View b{static_cast<const float*>(x), 1, k};
  return launch_product(a, b, nullptr, nullptr, static_cast<const float*>(s),
                        static_cast<float*>(dw), n, k, m, stream);
}

// ds (n,) = column sums of dy * (x @ w^T).
extern "C" int scaled_matmul_ds(const void* dy, const void* x, const void* w,
                                void* ds, int64_t m, int64_t n, int64_t k,
                                void* stream) {
  if (m < 1 || n < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t g = (n + kTile - 1) / kTile;
  if (g > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  scaled_matmul_ds_kernel<<<static_cast<unsigned>(g), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(dy), static_cast<float*>(ds), m, n, k);
  return static_cast<int>(cudaGetLastError());
}
