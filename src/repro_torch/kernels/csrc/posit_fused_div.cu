// K2: row-broadcast fused posit division, out[r, c] = a[r, c] / b[r].
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
// not padded (the reference pads the divisor with 1.0).
//
// Bound: the work is integer ALU (decode, ~8 recurrence iterations for
// posit16 radix-4, encode) per element, against 8 bytes of traffic per
// element; at the main path's shapes (R = batch x seq rows of 960) the
// launch is tiny and its time is set by latency, not by bytes.
#include <cuda_runtime.h>
#include <stdint.h>

#include "posit_srt.cuh"

namespace {

constexpr int kCols = 128;
constexpr int kRows = 4;

template <class P>
__global__ void __launch_bounds__(kCols* kRows)
    rowwise_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ out, int R, int C) {
  __shared__ posit::Divisor prep[kRows];
  const int row = blockIdx.y * kRows + threadIdx.y;
  const int col = blockIdx.x * kCols + threadIdx.x;
  if (threadIdx.x == 0 && row < R) prep[threadIdx.y] = posit::prep_divisor<P>(b[row]);
  __syncthreads();
  if (row >= R || col >= C) return;
  const size_t i = static_cast<size_t>(row) * C + col;
  out[i] = posit::divide_float<P>(a[i], prep[threadIdx.y]);
}

}  // namespace

// Returns 0, a cudaError_t from the launch, or -1 when no compiled plan
// matches the plan fields.
extern "C" int posit_fused_div_rowwise(int n, int radix, int red, int otf, int scaled,
                                       int nonrest, int it, int shift, int gbits,
                                       const float* a, const float* b, float* out, int R,
                                       int C, void* stream) {
  if (R <= 0 || C <= 0) return 0;
  const dim3 block(kCols, kRows);
  const dim3 grid((C + kCols - 1) / kCols, (R + kRows - 1) / kRows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ok = posit::dispatch_plan(n, radix, red, otf, scaled, nonrest, it, shift, gbits,
                                       [&](auto plan) {
                                         using P = decltype(plan);
                                         rowwise_kernel<P><<<grid, block, 0, s>>>(a, b, out, R, C);
                                       });
  if (!ok) return -1;
  return static_cast<int>(cudaGetLastError());
}
