// K12: f32 <-> posit casts, p[i] = float_to_posit(x[i]) (RNE, saturating)
// and x[i] = posit_to_float(p[i]), for posit8, posit16 and posit32.
//
// Replaces posit_quantize_pallas (src/repro/kernels/posit_cast.py:34,
// pallas_call :43) and posit_dequantize_pallas (:56, pallas_call :65),
// reached through ops.posit_quantize / ops.posit_dequantize
// (src/repro/kernels/ops.py:245, :255): K1's float_to_posit<N> and
// posit_to_float<N> (posit_srt.cuh), one thread per element of the
// flattened tensor, the ragged end masked.  Subnormal inputs quantize to
// minpos: f32 is classified by its bit fields and the build keeps
// subnormals (-ftz=false, no --use_fast_math).
//
// Bound: 8 bytes of traffic per element against some 60-80 integer
// operations (decode or float_decompose, then encode or ldexp_f32): at
// the card's rates the operations bound it, by a small factor.
#include <cuda_runtime.h>
#include <stdint.h>

#include "posit_srt.cuh"

namespace {

constexpr int kThreads = 256;

template <int N>
__global__ void __launch_bounds__(kThreads)
    quantize_kernel(const float* __restrict__ x, uint32_t* __restrict__ p, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n) p[i] = posit::float_to_posit<N>(x[i]);
}

template <int N>
__global__ void __launch_bounds__(kThreads)
    dequantize_kernel(const uint32_t* __restrict__ p, float* __restrict__ x, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n) x[i] = posit::posit_to_float<N>(p[i]);
}

// Calls f(Fmt<n>{}) for n in {8, 16, 32}; false for any other n.
template <class Fn>
bool dispatch_format(int n, Fn&& f) {
  switch (n) {
    case 8: f(posit::Fmt<8>{}); return true;
    case 16: f(posit::Fmt<16>{}); return true;
    case 32: f(posit::Fmt<32>{}); return true;
    default: return false;
  }
}

unsigned grid_for(long long n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

}  // namespace

// x: n f32, p: n uint32, contiguous on the device.  Both return 0, a
// cudaError_t from the launch, or -1 when n_ is not 8, 16 or 32.
extern "C" int posit_quantize(int n_, const float* x, uint32_t* p, long long n, void* stream) {
  if (n <= 0) return dispatch_format(n_, [](auto) {}) ? 0 : -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ok = dispatch_format(n_, [&](auto fmt) {
    quantize_kernel<decltype(fmt)::n><<<grid_for(n), kThreads, 0, s>>>(x, p, n);
  });
  if (!ok) return -1;
  return static_cast<int>(cudaGetLastError());
}

extern "C" int posit_dequantize(int n_, const uint32_t* p, float* x, long long n, void* stream) {
  if (n <= 0) return dispatch_format(n_, [](auto) {}) ? 0 : -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ok = dispatch_format(n_, [&](auto fmt) {
    dequantize_kernel<decltype(fmt)::n><<<grid_for(n), kThreads, 0, s>>>(p, x, n);
  });
  if (!ok) return -1;
  return static_cast<int>(cudaGetLastError());
}
