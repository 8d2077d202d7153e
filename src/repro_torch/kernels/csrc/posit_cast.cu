// K12: f32 <-> posit casts, p[i] = float_to_posit(x[i]) (RNE, saturating)
// and x[i] = posit_to_float(p[i]), for posit8, posit16 and posit32, and the
// rounding to the posit grid, y[i] = posit_to_float(float_to_posit(x[i])),
// in one pass on bf16 or f32.
//
// Replaces posit_quantize_pallas (src/repro/kernels/posit_cast.py:34,
// pallas_call :43) and posit_dequantize_pallas (:56, pallas_call :65),
// reached through ops.posit_quantize / ops.posit_dequantize
// (src/repro/kernels/ops.py:245, :255): K1's float_to_posit<N> and
// posit_to_float<N> (posit_srt.cuh), the ragged end masked.  Subnormal
// inputs quantize to minpos: f32 is classified by its bit fields and the
// build keeps subnormals (-ftz=false, no --use_fast_math).  The quantize
// writes the int64 lanes the public API gives (the unsigned pattern
// zero-extended) and the dequantize reads its patterns as they come (int64
// lanes, int32 words, packed uint16 or uint8: one instantiation a word
// type), so neither call widens or narrows in a pass of its own.
//
// The round kernel is the reference's posit_round_value (numerics/quant.py:
// posit_to_float(fmt, float_to_posit(fmt, x)), a jnp codec there, no Pallas
// kernel) as the posit-KV cache takes it: round_value<N> (K1's straight cast,
// no pattern built), read and written in the tensor's own dtype (bf16 as the
// card's conversion rounds, posit_srt.cuh bf16_bits), over two (src, dst,
// count) pairs in one grid, so a layer's K and V round in one launch with no
// copy to f32 and back around it.
//
// Bound: 8 bytes of traffic per element (12 for the quantize's int64 out,
// 4-12 for the dequantize) against some 60-130 integer operations: at the
// card's rates the operations bound the quantize and the round, the bytes
// the dequantize.  kVec elements a thread through one access of each array
// where a call holds at least kVecMin of them (fewer, wider threads lose at
// small sizes, where the launch and the few warps in flight set the time).
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "posit_srt.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;
constexpr long long kVecMin = 1LL << 20;

template <class T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// Thread t of block b maps elements [(b kThreads + t) V, + V) of x through
// f into y: one access of V elements where all V are in range, one at a
// time at the ragged end.
template <int V, class In, class Out, class Fn>
__device__ __forceinline__ void map_elements(const In* __restrict__ x, Out* __restrict__ y,
                                             long long n, long long block, Fn f) {
  const long long i0 = (block * kThreads + threadIdx.x) * V;
  if (i0 >= n) return;
  if (V == 1 || i0 + V <= n) {
    const Pack<In, V> a = *reinterpret_cast<const Pack<In, V>*>(x + i0);
    Pack<Out, V> b;
#pragma unroll
    for (int j = 0; j < V; ++j) b.v[j] = f(a.v[j]);
    *reinterpret_cast<Pack<Out, V>*>(y + i0) = b;
  } else {
    for (long long i = i0; i < n; ++i) y[i] = f(x[i]);
  }
}

template <int N, int V>
__global__ void __launch_bounds__(kThreads)
    quantize_kernel(const float* __restrict__ x, long long* __restrict__ p, long long n) {
  map_elements<V>(x, p, n, blockIdx.x, [](float v) {
    return static_cast<long long>(posit::float_to_posit<N>(v));
  });
}

template <int N, class W, int V>
__global__ void __launch_bounds__(kThreads)
    dequantize_kernel(const W* __restrict__ p, float* __restrict__ x, long long n) {
  map_elements<V>(p, x, n, blockIdx.x, [](W w) {
    return posit::posit_to_float<N>(static_cast<uint32_t>(w));
  });
}

// x rounded to the posit<N> grid in its own type: f32, or bf16's bits.
template <int N>
__device__ __forceinline__ float round_as(float x) {
  return posit::round_value<N>(x);
}
template <int N>
__device__ __forceinline__ uint16_t round_as(uint16_t x) {
  return posit::bf16_bits(posit::round_value<N>(posit::u2f(static_cast<uint32_t>(x) << 16)));
}

// Blocks [0, blocks0) round pair 0, the rest pair 1.
template <int N, class T, int V>
__global__ void __launch_bounds__(kThreads)
    posit_round_kernel(const T* __restrict__ x0, T* __restrict__ y0, long long n0,
                       long long blocks0, const T* __restrict__ x1, T* __restrict__ y1,
                       long long n1) {
  const long long b = blockIdx.x;
  const auto f = [](T v) { return round_as<N>(v); };
  if (b < blocks0) map_elements<V>(x0, y0, n0, b, f);
  else map_elements<V>(x1, y1, n1, b - blocks0, f);
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

// Calls f(T{}) for the word of `bytes` bytes; false for any other width.
template <class Fn>
bool dispatch_word(int bytes, Fn&& f) {
  switch (bytes) {
    case 8: f(int64_t{}); return true;
    case 4: f(uint32_t{}); return true;
    case 2: f(uint16_t{}); return true;
    case 1: f(uint8_t{}); return true;
    default: return false;
  }
}

// An array a call reads or writes, and the bytes of its elements.
struct Array {
  const void* ptr;
  int bytes;
};

// kVec when the call is large enough and every array takes its accesses.
template <class... Arrays>
int vec_for(long long n, Arrays... arrays) {
  if (kVec == 1 || n < kVecMin) return 1;
  const auto aligned = [](Array a) {
    return reinterpret_cast<uintptr_t>(a.ptr) % (a.bytes * kVec) == 0;
  };
  return (aligned(arrays) && ...) ? kVec : 1;
}

unsigned blocks_for(long long n, int v) {
  return static_cast<unsigned>((n + kThreads * v - 1) / (kThreads * v));
}

// launch(V) for V = v, a compile-time constant.
template <class Launch>
void launch_vec(int v, Launch&& launch) {
  if constexpr (kVec > 1) {
    if (v == kVec) return launch(std::integral_constant<int, kVec>{});
  }
  launch(std::integral_constant<int, 1>{});
}

}  // namespace

// x: n f32, p: n int64 lanes, contiguous on the device.  Each entry returns
// 0, a cudaError_t from the launch, or -1 when n_ is not 8, 16 or 32 (or,
// for the dequantize, word_bytes not 8, 4, 2 or 1; for the round, dtype not
// 0 f32 or 1 bf16).
extern "C" int posit_quantize(int n_, const float* x, long long* p, long long n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int v = vec_for(n, Array{x, 4}, Array{p, 8});
  const bool ok = dispatch_format(n_, [&](auto fmt) {
    if (n <= 0) return;
    launch_vec(v, [&](auto vv) {
      const unsigned grid = blocks_for(n, vv);
      quantize_kernel<decltype(fmt)::n, decltype(vv)::value><<<grid, kThreads, 0, s>>>(x, p, n);
    });
  });
  if (!ok) return -1;
  return static_cast<int>(cudaGetLastError());
}

// p: n patterns of word_bytes bytes each (the low 32 bits are the pattern).
extern "C" int posit_dequantize(int n_, int word_bytes, const void* p, float* x, long long n,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int v = vec_for(n, Array{p, word_bytes}, Array{x, 4});
  bool ok = false;
  dispatch_format(n_, [&](auto fmt) {
    ok = dispatch_word(word_bytes, [&](auto w) {
      using W = decltype(w);
      if (n <= 0) return;
      launch_vec(v, [&](auto vv) {
        const unsigned grid = blocks_for(n, vv);
        dequantize_kernel<decltype(fmt)::n, W, decltype(vv)::value><<<grid, kThreads, 0, s>>>(
            static_cast<const W*>(p), x, n);
      });
    });
  });
  if (!ok) return -1;
  return static_cast<int>(cudaGetLastError());
}

// (x0, y0, n0) and (x1, y1, n1): two contiguous arrays of one dtype on the
// device and their outputs, rounded in one launch (n1 = 0 for one array).
extern "C" int posit_round(int n_, int dtype, const void* x0, void* y0, long long n0,
                           const void* x1, void* y1, long long n1, void* stream) {
  if (dtype != 0 && dtype != 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bytes = dtype == 0 ? 4 : 2;
  const int v = vec_for(n0 + n1, Array{x0, bytes}, Array{y0, bytes}, Array{x1, bytes},
                        Array{y1, bytes});
  const bool ok = dispatch_format(n_, [&](auto fmt) {
    using Fm = decltype(fmt);
    if (n0 + n1 <= 0) return;
    launch_vec(v, [&](auto vv) {
      constexpr int V = decltype(vv)::value;
      const long long b0 = blocks_for(n0, V);
      const unsigned grid = b0 + blocks_for(n1, V);
      if (dtype == 0)
        posit_round_kernel<Fm::n, float, V><<<grid, kThreads, 0, s>>>(
            static_cast<const float*>(x0), static_cast<float*>(y0), n0, b0,
            static_cast<const float*>(x1), static_cast<float*>(y1), n1);
      else
        posit_round_kernel<Fm::n, uint16_t, V><<<grid, kThreads, 0, s>>>(
            static_cast<const uint16_t*>(x0), static_cast<uint16_t*>(y0), n0, b0,
            static_cast<const uint16_t*>(x1), static_cast<uint16_t*>(y1), n1);
    });
  });
  if (!ok) return -1;
  return static_cast<int>(cudaGetLastError());
}
