// K11: posit division on bit patterns, out[i] = px[i] / pd[i], n <= 32.
//
// Replaces posit_div_pallas (src/repro/kernels/posit_div.py:635, pallas_call
// :652), reached through ops.posit_div (src/repro/kernels/ops.py:152): the
// reference's _divide_block (K1, posit_srt.cuh: decode, SRT recurrence,
// encode) on uint32 words, one thread per element of the flattened
// operands, each preparing its own divisor.  The ragged end is masked,
// never read (the reference pads the divisor with the +1 pattern).
//
// Plans: the 26 one-word rows of posit_plans.inc and its posit32
// srt_r4_scaled row (a two-word residual on one-word patterns), plus the
// nine posit10 rows of posit10_plans.inc (the paper's Table III examples),
// which no other kernel builds.  The posit64 rows are not built: their
// patterns do not fit a uint32 word (the reference's K11 refuses n > 32).
//
// Bound: 12 bytes of traffic against a whole division per element (about
// 400 integer operations for posit16 radix 4): the integer operations
// bound it at any size.
#include <cuda_runtime.h>
#include <stdint.h>

#include "posit_srt.cuh"

namespace {

constexpr int kThreads = 256;

template <class P>
__global__ void __launch_bounds__(kThreads)
    div_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ pd,
               uint32_t* __restrict__ out, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  out[i] = posit::divide_bits<P>(px[i], posit::prep_divisor_bits<P>(pd[i]));
}

}  // namespace

// px, pd, out: n uint32 words each, contiguous on the device.  Returns 0, a
// cudaError_t from the launch, or -1 when no compiled plan matches.
extern "C" int posit_div(int n_, int radix, int red, int otf, int scaled, int nonrest, int it,
                         int shift, int gbits, const uint32_t* px, const uint32_t* pd,
                         uint32_t* out, long long n, void* stream) {
  const unsigned grid = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  posit::dispatch_plan<true>(n_, radix, red, otf, scaled, nonrest, it, shift, gbits,
                             [&](auto plan) {
                               using P = decltype(plan);
                               if constexpr (P::n <= 32) {
                                 if (n > 0) div_kernel<P><<<grid, kThreads, 0, s>>>(px, pd, out, n);
                                 ok = true;
                               }
                             });
  if (!ok) return -1;
  return static_cast<int>(cudaGetLastError());
}
