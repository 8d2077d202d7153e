// K11: posit division on bit patterns, out[i] = px[i] / pd[i], n <= 32.
//
// Replaces posit_div_pallas (src/repro/kernels/posit_div.py:635, pallas_call
// :652), reached through ops.posit_div (src/repro/kernels/ops.py:152): the
// reference's _divide_block (K1, posit_srt.cuh: decode, SRT recurrence,
// encode) on 32-bit patterns, each element preparing its own divisor
// (posit_srt.cuh divide_patterns).  The ragged end is masked, never read (the
// reference pads the divisor with the +1 pattern).  The operands are read as
// they come, int64 lanes or int32 words (the low 32 bits are the pattern),
// and the quotients written as the public API gives them, int64 lanes (the
// unsigned pattern zero-extended): a call is one launch, with no pass that
// widens or narrows.
//
// Plans: the 26 one-word rows of posit_plans.inc and its posit32
// srt_r4_scaled row (a two-word residual on one-word patterns), plus the
// nine posit10 rows of posit10_plans.inc (the paper's Table III examples),
// which no other kernel builds.  The posit64 rows are not built: their
// patterns do not fit a uint32 word (the reference's K11 refuses n > 32).
//
// Bound: 12-24 bytes of traffic against a whole division per element (about
// 400 integer operations for posit16 radix 4): the integer operations
// bound it at any size, the integer pipe's in practice (PERF.md section 6).
// kVec elements a thread where a call holds at least kVecMin of them: the
// card full, four independent divisions a thread hide each other's
// latency; below, more threads do.  A radix-4 digit (kSelection): one
// element a thread counts the thresholds its estimate reaches, with no
// branch on the estimate (5% faster at 64 x 1024 than the ladder K2-K10
// keep); four a thread take the ladder, whose branches skip compares the
// count makes (14% faster at 2^28 than the count, which spends 23% more
// static integer-pipe instructions there).
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "posit_srt.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;
constexpr long long kVecMin = 1LL << 20;

template <int V>
constexpr posit::Selection kSelection = V == 1 ? posit::Selection::count
                                               : posit::Selection::ladder;

template <class T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// The V patterns from element i0 of p (one access where all V are in
// range; past n, zeros that no one stores).
template <int V, class T>
__device__ __forceinline__ void load_patterns(const T* __restrict__ p, long long i0, long long n,
                                              uint32_t (&w)[V]) {
  if (V == 1 || i0 + V <= n) {
    const Pack<T, V> a = *reinterpret_cast<const Pack<T, V>*>(p + i0);
#pragma unroll
    for (int j = 0; j < V; ++j) w[j] = static_cast<uint32_t>(a.v[j]);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) w[j] = i0 + j < n ? static_cast<uint32_t>(p[i0 + j]) : 0u;
  }
}

// lanes: the operands are int64 lanes, else int32 words (one flag for the
// whole grid, so the division below is compiled once).
template <class P, int V>
__global__ void __launch_bounds__(kThreads)
    div_kernel(const void* __restrict__ px, const void* __restrict__ pd,
               long long* __restrict__ out, long long n, int lanes) {
  const long long i0 = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * V;
  if (i0 >= n) return;
  uint32_t x[V], d[V];
  if (lanes) {
    load_patterns<V>(static_cast<const long long*>(px), i0, n, x);
    load_patterns<V>(static_cast<const long long*>(pd), i0, n, d);
  } else {
    load_patterns<V>(static_cast<const uint32_t*>(px), i0, n, x);
    load_patterns<V>(static_cast<const uint32_t*>(pd), i0, n, d);
  }
  Pack<long long, V> q;
#pragma unroll
  for (int j = 0; j < V; ++j) q.v[j] = posit::divide_patterns<P, kSelection<V>>(x[j], d[j]);
  if (V == 1 || i0 + V <= n) {
    *reinterpret_cast<Pack<long long, V>*>(out + i0) = q;
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (i0 + j < n) out[i0 + j] = q.v[j];
  }
}

template <class P, int V>
void launch(const void* px, const void* pd, long long* out, long long n, int lanes,
            cudaStream_t s) {
  const long long per_block = static_cast<long long>(kThreads) * V;
  const unsigned grid = static_cast<unsigned>((n + per_block - 1) / per_block);
  div_kernel<P, V><<<grid, kThreads, 0, s>>>(px, pd, out, n, lanes);
}

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

}  // namespace

// px, pd: n int64 lanes (lanes = 1) or n int32 words (lanes = 0); out: n
// int64 lanes; contiguous on the device.  Returns 0, a cudaError_t from the
// launch, or -1 when no compiled plan matches.
extern "C" int posit_div(int n_, int radix, int red, int otf, int scaled, int nonrest, int it,
                         int shift, int gbits, const void* px, const void* pd, long long* out,
                         long long n, int lanes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int in_bytes = (lanes ? 8 : 4) * kVec;
  const bool vec = kVec > 1 && n >= kVecMin && aligned(px, in_bytes) && aligned(pd, in_bytes) &&
                   aligned(out, 8 * kVec);
  bool ok = false;
  posit::dispatch_plan<true>(n_, radix, red, otf, scaled, nonrest, it, shift, gbits,
                             [&](auto plan) {
                               using P = decltype(plan);
                               if constexpr (P::n <= 32) {
                                 ok = true;
                                 if (n <= 0) return;
                                 if constexpr (kVec > 1) {
                                   if (vec) return launch<P, kVec>(px, pd, out, n, lanes, s);
                                 }
                                 launch<P, 1>(px, pd, out, n, lanes, s);
                               }
                             });
  if (!ok) return -1;
  return static_cast<int>(cudaGetLastError());
}
