// K2: row-broadcast fused posit division, out[r, c] = a[r, c] / b[r], and
// K10: elementwise fused posit division, out[i] = a[i] / b[i].
//
// K2 replaces posit_fused_div_rowwise_pallas (src/repro/kernels/
// posit_fused_div.py :127, pallas_call :149), reached through
// ops.posit_div_fused_rowwise (src/repro/kernels/ops.py:191); K10 replaces
// posit_fused_div_pallas (:86, pallas_call :103), reached through
// ops.posit_div_fused (src/repro/kernels/ops.py:172).  Both quantize to
// posit, run the SRT recurrence (K1, posit_srt.cuh) and dequantize, all in
// registers, one launch.
//
// Bound: 8 (K2) or 12 (K10) bytes of traffic against a whole division per
// element, so the integer operations bound both at any size; at decode's
// few rows K2's time is one element's dependent chain.  So the design cuts
// the instructions an element takes and spreads few rows over the card:
//   * the casts go straight between f32 and posit fields (K1's
//     float_to_fields, quotient_to_float): no pattern is built only to be
//     decoded again;
//   * one element a thread: two or four side by side, 16-byte vectors and a
//     grid-stride loop over one wave of blocks all measured slower at the
//     main path's shapes (PERF.md section 6);
//   * K2: a block is one row by kRowThreads columns, so decode's 8 rows of
//     960 spread over 64 SMs; its first thread prepares the row's divisor
//     into shared memory, which every thread copies into registers once
//     (measured against every thread preparing it and a broadcast from
//     lane 0); K10: each element prepares its own divisor (its semantics).
// Edges are masked, not padded (the reference pads the divisor with 1.0).
// K2's rows lie on gridDim.x (up to 2^31 - 1), its column tiles on
// gridDim.y (up to 65535 x kRowThreads columns), with 64-bit offsets.
//
// Both kernels are built for every row of posit_plans.inc, the two-word
// plans (posit32 srt_r4_scaled, posit64) included.
#include <cuda_runtime.h>
#include <stdint.h>

#include "posit_srt.cuh"

namespace {

constexpr int kRowThreads = 128;  // K2: threads a block, all on one row
constexpr int kThreads = 256;     // K10: threads a block

template <class P>
__global__ void __launch_bounds__(kRowThreads)
    rowwise_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ out, int C) {
  __shared__ posit::DivisorOf<P> prep;
  if (threadIdx.x == 0)
    prep = posit::prep_divisor_fields<P>(posit::float_to_fields<P::n>(b[blockIdx.x]));
  __syncthreads();
  const int col = blockIdx.y * kRowThreads + threadIdx.x;
  if (col >= C) return;
  const posit::DivisorOf<P> d = prep;
  const size_t i = static_cast<size_t>(blockIdx.x) * C + col;
  out[i] = posit::divide_to_float<P>(posit::float_to_fields<P::n>(a[i]), d);
}

template <class P>
__global__ void __launch_bounds__(kThreads)
    elementwise_kernel(const float* __restrict__ a, const float* __restrict__ b,
                       float* __restrict__ out, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  out[i] = posit::divide_to_float<P>(
      posit::float_to_fields<P::n>(a[i]),
      posit::prep_divisor_fields<P>(posit::float_to_fields<P::n>(b[i])));
}

}  // namespace

// a: (R, C) f32, b: (R,) f32, out: (R, C) f32, contiguous on the device.
// Returns 0, a cudaError_t from the launch, -1 when no compiled plan matches
// the plan fields, or -2 past 2^31 - 1 rows or 65535 column tiles.
extern "C" int posit_fused_div_rowwise(int n, int radix, int red, int otf, int scaled,
                                       int nonrest, int it, int shift, int gbits,
                                       const float* a, const float* b, float* out, long long R,
                                       int C, void* stream) {
  if (R <= 0 || C <= 0) return 0;
  const long long col_tiles = (C + kRowThreads - 1) / kRowThreads;
  if (R > 0x7FFFFFFFLL || col_tiles > 65535) return -2;
  const dim3 grid(static_cast<unsigned>(R), static_cast<unsigned>(col_tiles));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ok = posit::dispatch_plan(n, radix, red, otf, scaled, nonrest, it, shift, gbits,
                                       [&](auto plan) {
                                         using P = decltype(plan);
                                         rowwise_kernel<P><<<grid, kRowThreads, 0, s>>>(
                                             a, b, out, C);
                                       });
  if (!ok) return -1;
  return static_cast<int>(cudaGetLastError());
}

// K10: a, b, out hold n f32 each, contiguous on the device.  Returns as
// posit_fused_div_rowwise.
extern "C" int posit_fused_div(int n_, int radix, int red, int otf, int scaled, int nonrest,
                               int it, int shift, int gbits, const float* a, const float* b,
                               float* out, long long n, void* stream) {
  const unsigned grid = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ok = posit::dispatch_plan(n_, radix, red, otf, scaled, nonrest, it, shift, gbits,
                                       [&](auto plan) {
                                         using P = decltype(plan);
                                         if (n > 0)
                                           elementwise_kernel<P><<<grid, kThreads, 0, s>>>(
                                               a, b, out, n);
                                       });
  if (!ok) return -1;
  return static_cast<int>(cudaGetLastError());
}
