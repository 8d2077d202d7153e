// K2: row-broadcast fused posit division, out[r, c] = a[r, c] / b[r], and
// K10: elementwise fused posit division, out[i] = a[i] / b[i].
//
// Replaces posit_fused_div_rowwise_pallas (src/repro/kernels/posit_fused_div.py
// :127, pallas_call :149), reached through ops.posit_div_fused_rowwise
// (src/repro/kernels/ops.py:191): quantize to posit, run the SRT recurrence
// (K1, posit_srt.cuh), dequantize, all in registers, one launch.
//
// Design: one thread per output element; a block covers kRows rows by
// kCols columns.  The divisor's quantize/decode/didx/scaling is done once
// per row of the block by the row's first thread and shared through shared
// memory, so no broadcast denominator is ever formed.  Edges are masked,
// not padded (the reference pads the divisor with 1.0).  Row tiles lie on
// gridDim.x (up to 2^31 - 1 of them, where gridDim.y stopped at 65535) and
// column tiles on gridDim.y (up to 65535 x 128 columns), with 64-bit
// offsets, so any row count the card holds is taken.
//
// Bound: the work is integer ALU (decode, ~8 recurrence iterations for
// posit16 radix-4 on 32-bit words, 32 on 64-bit words for posit64, encode)
// per element, against 8 bytes of traffic per element; at the main path's
// shapes (R = batch x seq rows of 960) the launch is tiny and its time is
// set by latency, not by bytes.
//
// Both kernels are built for every row of posit_plans.inc, the two-word
// plans (posit32 srt_r4_scaled, posit64) included.
//
// K10 replaces posit_fused_div_pallas (src/repro/kernels/posit_fused_div.py
// :86, pallas_call :103), reached through ops.posit_div_fused
// (src/repro/kernels/ops.py:172): one thread per element of the flattened
// operands, each preparing its own divisor (nothing is shared, so no
// shared memory and no barrier); the ragged end is masked (the reference
// pads the divisor with 1.0).  12 bytes of traffic against a whole
// division per element: bound by the integer operations at any size.
#include <cuda_runtime.h>
#include <stdint.h>

#include "posit_srt.cuh"

namespace {

constexpr int kCols = 128;
constexpr int kRows = 4;

template <class P>
__global__ void __launch_bounds__(kCols* kRows)
    rowwise_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ out, long long R, int C) {
  __shared__ posit::DivisorOf<P> prep[kRows];
  const long long row = static_cast<long long>(blockIdx.x) * kRows + threadIdx.y;
  const int col = blockIdx.y * kCols + threadIdx.x;
  if (threadIdx.x == 0 && row < R) prep[threadIdx.y] = posit::prep_divisor<P>(b[row]);
  __syncthreads();
  if (row >= R || col >= C) return;
  const size_t i = static_cast<size_t>(row) * C + col;
  out[i] = posit::divide_float<P>(a[i], prep[threadIdx.y]);
}

constexpr int kThreads = 256;

template <class P>
__global__ void __launch_bounds__(kThreads)
    elementwise_kernel(const float* __restrict__ a, const float* __restrict__ b,
                       float* __restrict__ out, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  out[i] = posit::divide_float<P>(a[i], posit::prep_divisor<P>(b[i]));
}

}  // namespace

// a: (R, C) f32, b: (R,) f32, out: (R, C) f32, contiguous on the device.
// Returns 0, a cudaError_t from the launch, -1 when no compiled plan matches
// the plan fields, or -2 past 2^31 - 1 row tiles or 65535 column tiles.
extern "C" int posit_fused_div_rowwise(int n, int radix, int red, int otf, int scaled,
                                       int nonrest, int it, int shift, int gbits,
                                       const float* a, const float* b, float* out, long long R,
                                       int C, void* stream) {
  if (R <= 0 || C <= 0) return 0;
  const long long row_tiles = (R + kRows - 1) / kRows;
  const int col_tiles = (C + kCols - 1) / kCols;
  if (row_tiles > 0x7FFFFFFFLL || col_tiles > 65535) return -2;
  const dim3 block(kCols, kRows);
  const dim3 grid(static_cast<unsigned>(row_tiles), col_tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ok = posit::dispatch_plan(n, radix, red, otf, scaled, nonrest, it, shift, gbits,
                                       [&](auto plan) {
                                         using P = decltype(plan);
                                         rowwise_kernel<P><<<grid, block, 0, s>>>(a, b, out, R, C);
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
