// K9: fused posit softmax over the last axis, out[r, :] = e / sum(e) with
// e = exp(x[r, :] - max(x[r, :])), the division in posit.
//
// Replaces posit_softmax_fused_pallas (src/repro/kernels/posit_fused_div.py
// :188, pallas_call :210), reached through ops.posit_softmax_fused
// (src/repro/kernels/ops.py:220): row max, exp, fixed-order row sum and the
// SRT divide (K1, posit_srt.cuh), one launch, nothing in device memory but
// the input and the output.
//
// Bound: per element 8 bytes of traffic against a whole posit division (a
// few hundred integer operations at radix 4, twice the iterations at radix
// 2; chip_smoke.py div_ops counts them per plan), so by operations at any
// shape.  What sets the time on the router's (batch, 64) rows is latency:
// the row's serial sum (a tree would give other bits) and the divide's
// chain of dependent integer steps, the larger part.  When the rows fill
// the card it is the divides' integer issue.
//
// Design:
//   * one thread per column wherever C <= 1024: a row spans ceil(C/32)
//     warps, and narrow rows pack several to a block (up to 256 threads),
//     no more rows to a block than spreads R over the card's 132 SMs, so
//     the router's 8 rows run on 8 SMs.  Each column's SRT divide runs in
//     its own thread, none after another in series.  Rows wider than 1024
//     take 1024 threads and a strided loop;
//   * the row max is order-free: a shuffle tree per warp, then the row's
//     warp maxima from shared memory (a NaN anywhere makes it NaN, as
//     torch.amax and jnp.max do);
//   * each thread writes its columns' e = expf(x - m) to shared memory; one
//     thread of the row sums them left to right from 0 (the reference's
//     core/quire.fixed_order_rowsum), in one unrolled pass whose shared
//     loads are issued ahead of the adds, so the chain is set by the FADD
//     latency, not by load latency;
//   * every thread of the row then quantizes and decodes the divisor from
//     that sum itself, in parallel: timed against one thread preparing it
//     once into shared memory, that was 18-21% faster on the router's rows
//     (PERF.md section 6), as the serial prepare and its barrier came off
//     the row's critical path;
//   * rows that fill the card (R * C above 132 x 1024 elements) of a
//     one-word plan go one warp a row (warp_softmax_kernel), each lane
//     dividing C / 32 columns: there the integer issue of the divides sets
//     the time, and a thread per column prepares twice the divisors for
//     it.  At 4096 x 64 that was 12% faster than a thread per column at
//     posit16 and 2% at posit32, but 11% slower at posit64, whose longer
//     divide is better not doubled up (PERF.md section 6); fewer threads a
//     row were slower still.
// The reference pads columns to 128 and masks them; appended zeros are exact
// identities of the fixed-order sum, so here columns are taken as they come.
// Rows are independent, so a NaN row reaches no other row.  expf, never
// __expf, and no --use_fast_math: subnormal e must be kept.  Instantiated
// for the plans posit::kModelPlan names (every posit8, posit16, posit32 and
// posit64 plan; the two-word ones, posit32 srt_r4_scaled and posit64, hold a
// 48-byte divisor per thread), all in one library: the kernels are small.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "posit_srt.cuh"

namespace {

constexpr int kRowThreads = 1024;         // a row's threads: one per column up to here
constexpr int kPackThreads = 256;         // narrow rows pack into blocks of up to this many
constexpr int kWarpRows = 4;              // rows (warps) a block when the rows fill the card
constexpr int kSMs = 132;                 // H100 SXM
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmem = 227 * 1024;      // a block's dynamic shared memory on sm_90
// A row's shared memory beside its e values: its warp maxima (32 floats),
// the first of which then holds its sum.
constexpr int kRowExtra = 32 * 4;

__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || isnan(b)) ? b : a;
}

// s = 0 + e[0] + e[1] + ... + e[C-1], in that order.  The loads of a chunk
// of 16 are issued before its adds (and, unrolled, the next chunks'), so the
// serial chain waits on FADDs, not on shared memory.  er is 16-byte aligned.
__device__ __forceinline__ float row_sum(const float* er, int C) {
  float s = 0.0f;
  int j = 0;
#pragma unroll 4
  for (; j + 16 <= C; j += 16) {
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = reinterpret_cast<const float4*>(er + j)[u];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      s += v[u].x;
      s += v[u].y;
      s += v[u].z;
      s += v[u].w;
    }
  }
  for (; j < C; ++j) s += er[j];
  return s;
}

// Shared memory: each row's e (stride ld, a multiple of 4 floats), then each
// row's 32 warp maxima.
size_t smem_bytes(int rows, int ld) { return sizeof(float) * rows * (ld + 32); }

// Block: `rows` rows of T threads (T a multiple of 32, at most 1024);
// thread ci of a row takes columns ci, ci + T, ...
template <class P>
__global__ void __launch_bounds__(kRowThreads)
    softmax_kernel(const float* __restrict__ x, float* __restrict__ out, int R, int C, int T,
                   int ld) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = blockDim.x / T;
  float* e_s = reinterpret_cast<float*>(smem);
  float* wmax = e_s + rows * ld;
  const int lr = threadIdx.x / T, ci = threadIdx.x % T, lane = threadIdx.x % 32;
  const int row = blockIdx.x * rows + lr;
  const bool live = row < R;              // every thread reaches the barriers
  const float* xr = x + static_cast<size_t>(live ? row : 0) * C;
  float* er = e_s + lr * ld;

  float m = -INFINITY;
  if (live)
    for (int c = ci; c < C; c += T) m = nan_max(m, xr[c]);
  for (int off = 16; off > 0; off >>= 1) m = nan_max(m, __shfl_xor_sync(kFull, m, off));
  if (lane == 0) wmax[lr * 32 + ci / 32] = m;
  __syncthreads();
  m = wmax[lr * 32];
  for (int w = 1; w < T / 32; ++w) m = nan_max(m, wmax[lr * 32 + w]);

  if (live)
    for (int c = ci; c < C; c += T) er[c] = expf(xr[c] - m);
  __syncthreads();

  if (live && ci == 0) wmax[lr * 32] = row_sum(er, C);   // every thread has read the maxima
  __syncthreads();
  if (!live) return;

  const posit::DivisorOf<P> d = posit::prep_divisor<P>(wmax[lr * 32]);
  float* orow = out + static_cast<size_t>(row) * C;
  for (int c = ci; c < C; c += T) orow[c] = posit::divide_float<P>(er[c], d);
}

// When the rows fill the card: one warp a row, kWarpRows rows a block, lane
// l takes columns l, l + 32, ...; warp barriers only.
template <class P>
__global__ void __launch_bounds__(32 * kWarpRows)
    warp_softmax_kernel(const float* __restrict__ x, float* __restrict__ out, int R, int C,
                        int ld) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarpRows + warp;
  if (row >= R) return;                   // whole warps leave; no block barrier below
  const float* xr = x + static_cast<size_t>(row) * C;
  float* er = reinterpret_cast<float*>(smem) + warp * ld;

  float m = -INFINITY;
  for (int c = lane; c < C; c += 32) m = nan_max(m, xr[c]);
  for (int off = 16; off > 0; off >>= 1) m = nan_max(m, __shfl_xor_sync(kFull, m, off));
  for (int c = lane; c < C; c += 32) er[c] = expf(xr[c] - m);
  __syncwarp();
  float s = 0.0f;
  if (lane == 0) s = row_sum(er, C);
  s = __shfl_sync(kFull, s, 0);

  const posit::DivisorOf<P> d = posit::prep_divisor<P>(s);
  float* orow = out + static_cast<size_t>(row) * C;
  for (int c = lane; c < C; c += 32) orow[c] = posit::divide_float<P>(er[c], d);
}

}  // namespace

// x, out: (R, C) f32, contiguous on the device.  Returns 0, a cudaError_t,
// -1 when no compiled plan (posit::kModelPlan) matches the plan fields, -2
// when a row is too wide for shared memory (C > posit_softmax_max_cols()).
extern "C" int posit_softmax_max_cols() { return (kMaxSmem - kRowExtra) / 4 / 4 * 4; }

extern "C" int posit_softmax(int n, int radix, int red, int otf, int scaled, int nonrest,
                             int it, int shift, int gbits, const float* x, float* out, int R,
                             int C, void* stream) {
  if (C > posit_softmax_max_cols()) return -2;
  if (R <= 0 || C <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = -1;
  posit::dispatch_plan(n, radix, red, otf, scaled, nonrest, it, shift, gbits, [&](auto plan) {
    using P = decltype(plan);
    if constexpr (posit::kModelPlan<P>) {
      // one-word plans' rows that fill the card (more elements than the SMs
      // take at 1024 threads each) go one warp a row; the rest one thread a
      // column (a two-word divide's own chain is long enough that a second
      // one per thread costs more than the extra divisors save)
      const bool full = P::words == 1 && C <= kRowThreads &&
                        static_cast<long long>(R) * C > kSMs * 1024LL;
      // threads per row, rows per block, e's row stride
      const int T = full ? 32 : C <= kRowThreads ? (C + 31) / 32 * 32 : kRowThreads;
      int rows = 1;
      if (full) {
        rows = kWarpRows;
      } else if (T < kPackThreads) {
        // rows a block may take and still reach every SM
        const int spread = (R + kSMs - 1) / kSMs;
        rows = spread < kPackThreads / T ? spread : kPackThreads / T;
      }
      const int ld = C <= T ? T : (C + 3) / 4 * 4;
      const dim3 grid((R + rows - 1) / rows);
      const size_t bytes = smem_bytes(rows, ld);
      if (full) {
        warp_softmax_kernel<P><<<grid, 32 * kWarpRows, bytes, s>>>(x, out, R, C, ld);
        rc = static_cast<int>(cudaGetLastError());
        return;
      }
      auto kern = softmax_kernel<P>;
      if (bytes > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
        if (err != cudaSuccess) {
          rc = static_cast<int>(err);
          return;
        }
      }
      kern<<<grid, rows * T, bytes, s>>>(x, out, R, C, T, ld);
      rc = static_cast<int>(cudaGetLastError());
    }
  });
  return rc;
}
