// K9: fused posit softmax over the last axis, out[r, :] = e / sum(e) with
// e = exp(x[r, :] - max(x[r, :])), the division in posit.
//
// Replaces posit_softmax_fused_pallas (src/repro/kernels/posit_fused_div.py
// :188, pallas_call :210), reached through ops.posit_softmax_fused
// (src/repro/kernels/ops.py:220): row max, exp, fixed-order row sum and the
// SRT divide (K1, posit_srt.cuh), one launch, nothing in device memory but
// the input and the output.
//
// Design: one warp per row, kRows rows a block.  The row max is order-free
// (a shuffle tree; a NaN anywhere makes it NaN, as torch.amax and jnp.max
// do).  Each lane writes its columns' e = expf(x - m) to shared memory; then
// lane 0 sums the row serially, left to right from 0 (the reference's
// core/quire.fixed_order_rowsum; a tree would give other bits).  Each lane
// prepares the row's divisor once and divides its columns through K1.  The
// reference pads columns to 128 and masks them; appended zeros are exact
// identities of the fixed-order sum, so here columns are taken as they come.
// Rows are independent, so a NaN row reaches no other row.  expf, never
// __expf, and no --use_fast_math: subnormal e must be kept.  Instantiated
// for the plans posit::kModelPlan names (every posit8, posit16, posit32 and
// posit64 plan; the two-word ones, posit32 srt_r4_scaled and posit64, hold a
// 48-byte divisor per lane), all in one library: the kernel is small.
//
// Bound: per element 8 bytes of traffic against a whole posit division
// (a few hundred integer operations at radix 4, twice the iterations at
// radix 2; chip_smoke.py div_ops counts them per plan), so by operations at
// any shape; on the router's (batch, 64) rows the launch is set by latency.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "posit_srt.cuh"

namespace {

constexpr int kRows = 4;                  // warps (rows) per block
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmem = 227 * 1024;      // a block's dynamic shared memory on sm_90

__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || isnan(b)) ? b : a;
}

template <class P>
__global__ void __launch_bounds__(32 * kRows)
    softmax_kernel(const float* __restrict__ x, float* __restrict__ out, int R, int C) {
  extern __shared__ float e_s[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRows + warp;
  if (row >= R) return;                   // whole warps leave; no block barrier below
  const float* xr = x + static_cast<size_t>(row) * C;
  float* er = e_s + static_cast<size_t>(warp) * C;

  float m = -INFINITY;
  for (int c = lane; c < C; c += 32) m = nan_max(m, xr[c]);
  for (int off = 16; off > 0; off >>= 1) m = nan_max(m, __shfl_xor_sync(kFull, m, off));

  for (int c = lane; c < C; c += 32) er[c] = expf(xr[c] - m);
  __syncwarp();

  float s = 0.0f;
  if (lane == 0) {
    for (int c = 0; c < C; ++c) s += er[c];
  }
  s = __shfl_sync(kFull, s, 0);

  const posit::DivisorOf<P> d = posit::prep_divisor<P>(s);
  float* orow = out + static_cast<size_t>(row) * C;
  for (int c = lane; c < C; c += 32) orow[c] = posit::divide_float<P>(er[c], d);
}

}  // namespace

// x, out: (R, C) f32, contiguous on the device.  Returns 0, a cudaError_t,
// -1 when no compiled plan (posit::kModelPlan) matches the plan fields, -2
// when a row is too wide for shared memory (C > posit_softmax_max_cols()).
extern "C" int posit_softmax_max_cols() { return kMaxSmem / (kRows * 4); }

extern "C" int posit_softmax(int n, int radix, int red, int otf, int scaled, int nonrest,
                             int it, int shift, int gbits, const float* x, float* out, int R,
                             int C, void* stream) {
  if (C > posit_softmax_max_cols()) return -2;
  if (R <= 0 || C <= 0) return 0;
  const int bytes = kRows * C * static_cast<int>(sizeof(float));
  const dim3 grid((R + kRows - 1) / kRows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = -1;
  posit::dispatch_plan(n, radix, red, otf, scaled, nonrest, it, shift, gbits, [&](auto plan) {
    using P = decltype(plan);
    if constexpr (posit::kModelPlan<P>) {
      auto kern = softmax_kernel<P>;
      if (bytes > 48 * 1024) {
        const cudaError_t err =
            cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (err != cudaSuccess) {
          rc = static_cast<int>(err);
          return;
        }
      }
      kern<<<grid, 32 * kRows, bytes, s>>>(x, out, R, C);
      rc = static_cast<int>(cudaGetLastError());
    }
  });
  return rc;
}
