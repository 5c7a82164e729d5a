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
// it when the last K block retires.  Here a CTA owns an output tile, a loop
// inside it takes the place of that grid axis, and the scale multiplies
// the register accumulator in the epilogue (forward, dw) or the dy panel
// in shared memory before the product (dx).  The reference has no
// backward; the port's autograd.Function makes ONE launch per backward
// call, whose CTA ranges compute the gradients asked for: dx and dw in
// the weight steps (S frozen), dx and ds in the scale sub-epochs.
//
// Bound: at the port's shapes (M = 32, 120, 960 rows; N = 128 or 10; K =
// 128) a call moves under 1 MB and does under 32 MFLOP, which the card
// could finish in well under a microsecond.  What a call costs is latency:
// the launch, and each round trip to device memory that a CTA waits on in
// turn.  The kernel before this one loaded 32-wide steps of the reduction
// one after the other (four round trips for K = 128) and read transposed
// operands 512 bytes apart per thread.  So the design:
//
// * One round of loads per CTA.  Each CTA stages its whole reduction
//   panel of both operands (and its scale vectors) in shared memory with
//   cp.async, every copy in flight at once, before any arithmetic: 16-byte
//   copies where the rows and the base are 16-byte aligned, 4-byte copies
//   otherwise (dy of the (10, 128) layer has 40-byte rows).  A reduction
//   longer than 128 (no main-path shape) goes in chunks of 64 with two
//   stages, the next chunk loading while this one computes; ds walks row
//   tiles of M through the same two stages.
// * Coalesced loads whatever the layout.  Each operand is copied along
//   its contiguous axis: a panel is stored reduction-contiguous (rows
//   padded to 4 mod 32 floats, so a warp's rows fall in distinct banks)
//   or index-contiguous (dx's w, dw's dy and x), and the product reads it
//   through its strides.
// * A grid that does not leave the card idle: 16 x 16 output tiles, one
//   output a thread of 256, unless 32 x 32 tiles (2 x 2 outputs a thread)
//   already give 96 CTAs; ds takes 32 columns a CTA, each column summed
//   by 8 threads over rows 8 apart.
// * One launch per backward call: the CTA ranges of dx, dw and ds sit in
//   one grid, and every CTA reads its role from its index.  The parts of a
//   backward share dy through L2: their tiles cut dy along different axes
//   (dx by rows of M, dw and ds by columns of N), so no CTA holds both.
// * One launch per cohort: the batched client round stacks its clients'
//   operands along a leading axis (x (K, M, Kin), W (K, N, Kin), s (K, N)),
//   and grid y runs over those K rows, each CTA offsetting its pointers by
//   its row.  Per row the arithmetic is that of a launch over the row
//   alone, so a cohort of 8 takes one launch a dense layer and step where
//   the clients took 8.
//
// Each output is one fmaf chain over the reduction in order, from 0, and ds
// adds each column's 8 row partials in order in shared memory: the float
// operations, and so the bits, of the 32 x 32 tile-loop design this one
// replaced, which the card-vs-CPU checks of whole runs were tuned on
// (splitting each sum over thread groups was faster, but moved those runs).
// No atomics, so every result is deterministic.  No tensor cores: every call
// is under 32 MFLOP, so arithmetic is not the limit; a 3xTF32 split leaves
// about 2^-20 |ab| of error a product, which with the accumulation's nearly
// fills the tested bound 2 (R + 2) u at R = 10; plain TF32 would move the
// card's runs off the reference; and wgmma wants 64-row tiles, which M = 32
// cannot fill.  This file must not be built with --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSingle = 128;   // a reduction up to this is staged whole
constexpr int kChunk = 64;        // else: chunks of this, two stages
constexpr int kBigCtas = 96;      // 32 x 32 tiles from this many CTAs up
constexpr int kEpi = 32;          // floats of the epilogue scale vector
constexpr int kDsRows = 32, kDsCols = 32;

__host__ __device__ constexpr int ceil4(int v) { return (v + 3) & ~3; }

// Row length (floats) of a panel stored reduction-contiguous: a multiple
// of 4 (16-byte rows) that is 4 mod 32, so the rows a warp reads at one r
// fall in distinct banks.
__host__ __device__ constexpr int row_stride(int c) {
  return ceil4(c) + ((4 - ceil4(c)) % 32 + 32) % 32;
}

// The reduction length staged at once: all of it when one step covers a
// CTA's work, else chunks of kChunk.
__host__ __device__ inline int chunk_len(int64_t r, int64_t walks) {
  return (walks == 1 && r <= kMaxSingle) ? static_cast<int>(r) : kChunk;
}

// A matrix operand of C = A B^T: element (t, r), t an output index and r
// the reduction index, at p[t * ld + r] (kmajor) or p[r * ld + t]; the
// matrix of cohort row z starts at p + z * bs.
struct Operand {
  const float* p;
  int64_t ld;
  int64_t bs;
  int kmajor;
  int vec;      // 16-byte copies: p 16-byte aligned, ld and bs % 4 == 0
};

__host__ __device__ inline int panel_floats(int t, int kmajor, int c) {
  return kmajor ? t * row_stride(c) : c * t;
}

// C (P, Q) row-major = A B^T over R; A's column r is scaled by a_scale[r]
// before the product, the result by col_scale[j] or row_scale[i].  Cohort
// row z reads the scale vectors from z * sbs on and writes C at z * P * Q.
struct Product {
  Operand a, b;
  const float* a_scale;
  const float* col_scale;
  const float* row_scale;
  float* c;
  int64_t P, Q, R;
  int64_t sbs;
  int big;      // 32 x 32 output tiles, else 16 x 16
  int ctas;
};

// ds[n] = sum_m dy[m, n] (x w^T)[m, n]: one CTA per kDsCols columns walks
// the row tiles of M.
struct Ds {
  Operand x, w;       // both (rows, K) row-major
  Operand dy;         // dy (M, N) row-major as an index-contiguous panel
  float* ds;          // cohort row z's at ds + z * N
  int64_t M, N, K;
  int ctas;
};

struct Params {
  Product prod[2];
  Ds ds;
  int nprod;
  int has_ds;
  int start[3];       // first CTA of prod[0], prod[1] (, ds) in that order
};

__device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ unsigned smem_addr(const float* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Asynchronous copies to shared memory; bytes past `bytes` are zeroed.
__device__ __forceinline__ void cp16(float* dst, const float* src,
                                     int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copies output indices [t0, t0 + T) (zeros from `limit` on) and
// reductions [r0, r0 + rc) of `op` into `dst`: reduction-contiguous rows
// of `rs` floats (kmajor) or index-contiguous rows of T floats.
template <int T>
__device__ void load_panel(const Operand& op, float* dst, int64_t t0,
                           int64_t limit, int64_t r0, int rc, int rs) {
  if (op.kmajor) {
    if (op.vec) {
      const int v4 = (rc + 3) / 4;
      for (int e = threadIdx.x; e < T * v4; e += kThreads) {
        const int t = e / v4, v = 4 * (e - t * v4);
        const bool in = t0 + t < limit;
        cp16(dst + t * rs + v, in ? op.p + (t0 + t) * op.ld + r0 + v : op.p,
             in ? 4 * min(4, rc - v) : 0);
      }
    } else {
      for (int e = threadIdx.x; e < T * rc; e += kThreads) {
        const int t = e / rc, v = e - t * rc;
        const bool in = t0 + t < limit;
        cp4(dst + t * rs + v, in ? op.p + (t0 + t) * op.ld + r0 + v : op.p,
            in ? 4 : 0);
      }
    }
  } else {
    if (op.vec) {
      constexpr int v4 = T / 4;
      for (int e = threadIdx.x; e < rc * v4; e += kThreads) {
        const int r = e / v4, t = 4 * (e - r * v4);
        const int64_t left = limit - (t0 + t);
        const int bytes = left <= 0 ? 0 : 4 * static_cast<int>(lmin(left, 4));
        cp16(dst + r * T + t, bytes ? op.p + (r0 + r) * op.ld + t0 + t : op.p,
             bytes);
      }
    } else {
      for (int e = threadIdx.x; e < rc * T; e += kThreads) {
        const int r = e / T, t = e - r * T;
        const bool in = t0 + t < limit;
        cp4(dst + r * T + t, in ? op.p + (r0 + r) * op.ld + t0 + t : op.p,
            in ? 4 : 0);
      }
    }
  }
}

// The cell (ti, tj) of this thread in a TI x TJ grid of threads.  Each
// warp takes 4 rows by 8 columns of cells, so the rows of a panel that it
// reads at one r are 4 (or 8) consecutive ones, in distinct banks.
template <int TI, int TJ>
__device__ __forceinline__ void cell(int* ti, int* tj) {
  static_assert(TI * TJ == kThreads && TI % 4 == 0 && TJ % 8 == 0,
                "warps of 4 x 8 cells");
  constexpr int kColBlocks = TJ / 8;
  const int w = threadIdx.x / 32, u = threadIdx.x % 32;
  *ti = (w / kColBlocks) * 4 + u / 8;
  *tj = (w % kColBlocks) * 8 + u % 8;
}

// acc[q][p] += sum_r A(ti + q TI, r) B(tj + p TJ, r) over one staged
// chunk, r in order, A(t, r) at as[t * a_si + r * a_sr] and B likewise.
template <int BM, int BN, int TM, int TN>
__device__ __forceinline__ void accumulate(const float* as, int a_si,
                                           int a_sr, const float* bs,
                                           int b_si, int b_sr, int rc,
                                           float (&acc)[TM][TN]) {
  constexpr int TI = BM / TM, TJ = BN / TN;
  int ti, tj;
  cell<TI, TJ>(&ti, &tj);
  const float* pa = as + ti * a_si;
  const float* pb = bs + tj * b_si;
#pragma unroll 4
  for (int r = 0; r < rc; ++r) {
    float a[TM], b[TN];
#pragma unroll
    for (int q = 0; q < TM; ++q) a[q] = pa[q * TI * a_si];
#pragma unroll
    for (int p = 0; p < TN; ++p) b[p] = pb[p * TJ * b_si];
#pragma unroll
    for (int q = 0; q < TM; ++q)
#pragma unroll
      for (int p = 0; p < TN; ++p) acc[q][p] = fmaf(a[q], b[p], acc[q][p]);
    pa += a_sr;
    pb += b_sr;
  }
}

__host__ __device__ inline int product_stage(const Product& pr, int t,
                                             int c) {
  return panel_floats(t, pr.a.kmajor, c) + panel_floats(t, pr.b.kmajor, c) +
         (pr.a_scale != nullptr ? ceil4(c) : 0);
}

template <int BM, int BN, int TM, int TN>
__device__ void run_product(const Product& pr, int cta, float* smem) {
  static_assert(BM == BN, "square output tiles");
  constexpr int TI = BM / TM, TJ = BN / TN;
  const int64_t tq = (pr.Q + BN - 1) / BN;
  const int64_t i0 = (cta / tq) * BM, j0 = (cta % tq) * BN;
  const int c = chunk_len(pr.R, 1);
  const int steps = static_cast<int>((pr.R + c - 1) / c);
  const int rs = row_stride(c);
  const int fa = panel_floats(BM, pr.a.kmajor, c);
  const int fb = panel_floats(BN, pr.b.kmajor, c);
  const int stage = product_stage(pr, BM, c);
  const int a_si = pr.a.kmajor ? rs : 1, a_sr = pr.a.kmajor ? 1 : BM;
  const int b_si = pr.b.kmajor ? rs : 1, b_sr = pr.b.kmajor ? 1 : BN;
  float* epi = smem;
  float* stages = smem + kEpi;

  // the epilogue's scale vector travels with the first chunk
  const float* es = pr.col_scale != nullptr ? pr.col_scale + j0
                    : pr.row_scale != nullptr ? pr.row_scale + i0 : nullptr;
  const int64_t en = pr.col_scale != nullptr ? pr.Q - j0 : pr.P - i0;
  if (es != nullptr && threadIdx.x < BM && threadIdx.x < en)
    cp4(epi + threadIdx.x, es + threadIdx.x, 4);

  auto issue = [&](int s) {
    float* st = stages + (s & 1) * stage;
    const int64_t r0 = static_cast<int64_t>(s) * c;
    const int rc = static_cast<int>(lmin(c, pr.R - r0));
    load_panel<BM>(pr.a, st, i0, pr.P, r0, rc, rs);
    load_panel<BN>(pr.b, st + fa, j0, pr.Q, r0, rc, rs);
    if (pr.a_scale != nullptr)
      for (int e = threadIdx.x; e < rc; e += kThreads)
        cp4(st + fa + fb + e, pr.a_scale + r0 + e, 4);
    cp_commit();
  };

  float acc[TM][TN];
#pragma unroll
  for (int q = 0; q < TM; ++q)
#pragma unroll
    for (int p = 0; p < TN; ++p) acc[q][p] = 0.0f;
  issue(0);
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      issue(s + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    float* st = stages + (s & 1) * stage;
    const int rc = static_cast<int>(
        lmin(c, pr.R - static_cast<int64_t>(s) * c));
    if (pr.a_scale != nullptr) {
      const float* sc = st + fa + fb;
      for (int e = threadIdx.x; e < BM * rc; e += kThreads) {
        const int t = e / rc, r = e - t * rc;
        float* v = st + t * a_si + r * a_sr;
        *v = __fmul_rn(*v, sc[r]);
      }
      __syncthreads();
    }
    accumulate<BM, BN, TM, TN>(st, a_si, a_sr, st + fa, b_si, b_sr, rc, acc);
    __syncthreads();
  }

  int ti, tj;
  cell<TI, TJ>(&ti, &tj);
#pragma unroll
  for (int q = 0; q < TM; ++q) {
    const int64_t i = i0 + ti + q * TI;
    if (i >= pr.P) continue;
#pragma unroll
    for (int p = 0; p < TN; ++p) {
      const int64_t j = j0 + tj + p * TJ;
      if (j >= pr.Q) continue;
      float v = acc[q][p];
      if (pr.col_scale != nullptr) v = __fmul_rn(v, epi[j - j0]);
      if (pr.row_scale != nullptr) v = __fmul_rn(v, epi[i - i0]);
      pr.c[i * pr.Q + j] = v;
    }
  }
}

__host__ __device__ inline int ds_stage(int c) {
  return panel_floats(kDsRows, 1, c) + panel_floats(kDsCols, 1, c) +
         kDsRows * kDsCols;
}

template <int BM, int BN, int TM, int TN>
__device__ void run_ds(const Ds& d, int cta, float* smem) {
  constexpr int TI = BM / TM, TJ = BN / TN;
  const int64_t j0 = static_cast<int64_t>(cta) * BN;
  const int64_t row_tiles = (d.M + BM - 1) / BM;
  const int c = chunk_len(d.K, row_tiles);
  const int chunks = static_cast<int>((d.K + c - 1) / c);
  const int steps = static_cast<int>(row_tiles) * chunks;
  const int rs = row_stride(c);
  const int fa = panel_floats(BM, 1, c), fb = panel_floats(BN, 1, c);
  const int stage = ds_stage(c);
  float* red = smem;                   // TI x BN row partials
  float* stages = smem + TI * BN;

  auto issue = [&](int s) {
    float* st = stages + (s & 1) * stage;
    const int ch = s % chunks;
    const int64_t i0 = static_cast<int64_t>(s / chunks) * BM;
    const int64_t r0 = static_cast<int64_t>(ch) * c;
    const int rc = static_cast<int>(lmin(c, d.K - r0));
    load_panel<BM>(d.x, st, i0, d.M, r0, rc, rs);
    load_panel<BN>(d.w, st + fa, j0, d.N, r0, rc, rs);
    if (ch == chunks - 1)   // dy rows [i0, i0 + BM), columns [j0, j0 + BN)
      load_panel<BN>(d.dy, st + fa + fb, j0, d.N, i0,
                     static_cast<int>(lmin(BM, d.M - i0)),
                     0);
    cp_commit();
  };

  int ti, tj;
  cell<TI, TJ>(&ti, &tj);
  float acc[TM][TN], part[TN];
#pragma unroll
  for (int p = 0; p < TN; ++p) part[p] = 0.0f;
  issue(0);
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      issue(s + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* st = stages + (s & 1) * stage;
    const int ch = s % chunks;
    const int64_t i0 = static_cast<int64_t>(s / chunks) * BM;
    const int rc = static_cast<int>(
        lmin(c, d.K - static_cast<int64_t>(ch) * c));
    if (ch == 0) {
#pragma unroll
      for (int q = 0; q < TM; ++q)
#pragma unroll
        for (int p = 0; p < TN; ++p) acc[q][p] = 0.0f;
    }
    accumulate<BM, BN, TM, TN>(st, rs, 1, st + fa, rs, 1, rc, acc);
    if (ch == chunks - 1) {
      const float* dyt = st + fa + fb;
#pragma unroll
      for (int q = 0; q < TM; ++q) {
        const int i = ti + q * TI;
        if (i0 + i >= d.M) continue;
#pragma unroll
        for (int p = 0; p < TN; ++p) {
          const int j = tj + p * TJ;
          if (j0 + j < d.N)
            part[p] = fmaf(dyt[i * BN + j], acc[q][p], part[p]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int p = 0; p < TN; ++p) red[ti * BN + tj + p * TJ] = part[p];
  __syncthreads();
  if (threadIdx.x < BN && j0 + threadIdx.x < d.N) {
    float total = red[threadIdx.x];
    for (int t = 1; t < TI; ++t)
      total = __fadd_rn(total, red[t * BN + threadIdx.x]);
    d.ds[j0 + threadIdx.x] = total;
  }
}

// The operand of cohort row z.
__device__ __forceinline__ Operand at_row(Operand op, int64_t z) {
  op.p += z * op.bs;
  return op;
}

// Grid y is the cohort: CTA (b, z) does CTA b's work on cohort row z, the
// same operations in the same order as a launch over that row alone.
__global__ void __launch_bounds__(kThreads)
    scaled_matmul_kernel(const __grid_constant__ Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int b = static_cast<int>(blockIdx.x);
  const int64_t z = blockIdx.y;
  for (int k = 0; k < p.nprod; ++k) {
    if (b < p.start[k] + p.prod[k].ctas) {
      Product pr = p.prod[k];
      pr.a = at_row(pr.a, z);
      pr.b = at_row(pr.b, z);
      if (pr.a_scale != nullptr) pr.a_scale += z * pr.sbs;
      if (pr.col_scale != nullptr) pr.col_scale += z * pr.sbs;
      if (pr.row_scale != nullptr) pr.row_scale += z * pr.sbs;
      pr.c += z * pr.P * pr.Q;
      if (pr.big)
        run_product<32, 32, 2, 2>(pr, b - p.start[k], smem);
      else
        run_product<16, 16, 1, 1>(pr, b - p.start[k], smem);
      return;
    }
  }
  Ds d = p.ds;
  d.x = at_row(d.x, z);
  d.w = at_row(d.w, z);
  d.dy = at_row(d.dy, z);
  d.ds += z * d.N;
  run_ds<kDsRows, kDsCols, 4, 1>(d, b - p.start[p.nprod], smem);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// A (rows, ld) row-major operand, one such matrix every bs floats along
// the cohort (bs unused for a cohort of one).
Operand operand(const void* p, int64_t ld, int64_t bs, int64_t batch,
                int kmajor) {
  return Operand{static_cast<const float*>(p), ld, bs, kmajor,
                 aligned16(p) && ld % 4 == 0 && (batch == 1 || bs % 4 == 0)};
}

// Fills the tile size and CTA count of `pr`; returns its shared memory in
// floats.
int64_t plan_product(Product* pr) {
  const int64_t big = ((pr->P + 31) / 32) * ((pr->Q + 31) / 32);
  pr->big = big >= kBigCtas;
  const int t = pr->big ? 32 : 16;
  const int64_t ctas = ((pr->P + t - 1) / t) * ((pr->Q + t - 1) / t);
  pr->ctas = ctas > 0x3fffffff ? -1 : static_cast<int>(ctas);
  const int c = chunk_len(pr->R, 1);
  const int64_t steps = (pr->R + c - 1) / c;
  return kEpi + (steps > 1 ? 2 : 1) * product_stage(*pr, t, c);
}

int64_t plan_ds(Ds* d) {
  const int64_t ctas = (d->N + kDsCols - 1) / kDsCols;
  d->ctas = ctas > 0x3fffffff ? -1 : static_cast<int>(ctas);
  const int64_t row_tiles = (d->M + kDsRows - 1) / kDsRows;
  const int c = chunk_len(d->K, row_tiles);
  const int64_t steps = row_tiles * ((d->K + c - 1) / c);
  return (kDsRows / 4) * kDsCols + (steps > 1 ? 2 : 1) * ds_stage(c);
}

int launch(Params& p, int64_t smem_floats, int64_t batch, void* stream) {
  int64_t total = 0;
  for (int k = 0; k < p.nprod; ++k) {
    if (p.prod[k].ctas < 1) return static_cast<int>(cudaErrorInvalidValue);
    p.start[k] = static_cast<int>(total);
    total += p.prod[k].ctas;
  }
  p.start[p.nprod] = static_cast<int>(total);
  if (p.has_ds) {
    if (p.ds.ctas < 1) return static_cast<int>(cudaErrorInvalidValue);
    total += p.ds.ctas;
  }
  const int64_t bytes = smem_floats * static_cast<int64_t>(sizeof(float));
  if (total < 1 || total > 0x7fffffff || bytes > 48 * 1024 || batch < 1
      || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(total), static_cast<unsigned>(batch));
  scaled_matmul_kernel<<<grid, kThreads, static_cast<size_t>(bytes),
                         static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All matrices float32, row-major and contiguous, one of each shape for
// every row of a cohort of `batch` (1 to 65,535), stacked along a leading
// axis: x (batch, m, k), w (batch, n, k), s (batch, n), dy (batch, m, n).
// One launch covers the cohort, its rows on grid y.  Each launches on
// `stream` and returns cudaGetLastError() (0 = launched).

// y (batch, m, n) = x @ (s * w)^T per row, the scale applied to the
// accumulator.
extern "C" int scaled_matmul_forward(const void* x, const void* w,
                                     const void* s, void* y, int64_t batch,
                                     int64_t m, int64_t n, int64_t k,
                                     void* stream) {
  if (m < 1 || n < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.nprod = 1;
  p.prod[0] = Product{operand(x, k, m * k, batch, 1),
                      operand(w, k, n * k, batch, 1), nullptr,
                      static_cast<const float*>(s), nullptr,
                      static_cast<float*>(y), m, n, k, n, 0, 0};
  return launch(p, plan_product(&p.prod[0]), batch, stream);
}

// The gradients whose output pointer is not null, in one launch, per row:
// dx (m, k) = (dy * s) @ w, dw (n, k) = s * (dy^T @ x) and
// ds (n,) = column sums of dy * (x @ w^T).  x is read only for dw and ds,
// s only for dx and dw.
extern "C" int scaled_matmul_backward(const void* dy, const void* x,
                                      const void* w, const void* s, void* dx,
                                      void* dw, void* ds, int64_t batch,
                                      int64_t m, int64_t n, int64_t k,
                                      void* stream) {
  if (m < 1 || n < 1 || k < 1 || (!dx && !dw && !ds))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  int64_t smem = 0;
  const float* sf = static_cast<const float*>(s);
  if (dx != nullptr) {
    Product& pr = p.prod[p.nprod++];
    pr = Product{operand(dy, n, m * n, batch, 1),
                 operand(w, k, n * k, batch, 0), sf, nullptr, nullptr,
                 static_cast<float*>(dx), m, k, n, n, 0, 0};
    const int64_t f = plan_product(&pr);
    smem = f > smem ? f : smem;
  }
  if (dw != nullptr) {
    Product& pr = p.prod[p.nprod++];
    pr = Product{operand(dy, n, m * n, batch, 0),
                 operand(x, k, m * k, batch, 0), nullptr, nullptr, sf,
                 static_cast<float*>(dw), n, k, m, n, 0, 0};
    const int64_t f = plan_product(&pr);
    smem = f > smem ? f : smem;
  }
  if (ds != nullptr) {
    p.has_ds = 1;
    p.ds = Ds{operand(x, k, m * k, batch, 1), operand(w, k, n * k, batch, 1),
              operand(dy, n, m * n, batch, 0), static_cast<float*>(ds), m, n,
              k, 0};
    const int64_t f = plan_ds(&p.ds);
    smem = f > smem ? f : smem;
  }
  return launch(p, smem, batch, stream);
}
