// K7 / K8: the recompute backward of the posit flash attention.
//
// Replaces the two backward pallas_calls of _flash_backward
// (src/repro/kernels/posit_flash_attn.py :557): K7 the dq kernel
// (_flash_bwd_dq_kernel :474, pallas_call :601) and K8 the dk/dv kernel over
// the grouped query heads (_flash_bwd_dkv_kernel :508, pallas_call :626).
// Both recompute score tiles from the forward's row residuals (m, l), with no
// (Sq, Sk) tensor anywhere:
//   s  = q k^T * scale,  e = exp(s - m) (0 where masked),
//   p  = e / l_safe through K1 as a rowwise posit divide (l_safe = l, or the
//        format's minpos where l == 0, so fully masked rows give p = 0),
//   dp = dO v^T,         ds = p * (dp - D),  D = rowsum(dO * o) (given).
// K7: one block per (q tile of kBQ rows, b*H + h); a loop over key tiles of
//     kBKq keys accumulates dq += ds k, scaled by `scale` at the end.
// K8: one block per (key tile of kBKk keys, b*KVH + kv head); a loop over the
//     G grouped query heads and their q tiles accumulates dv += p^T dO and
//     dk += ds^T q, dk scaled by `scale` at the end.
// Both grids put b*H + h (K8: b*KVH + kv head) on gridDim.x (up to
// 2^31 - 1; gridDim.y stopped them at 65535) and the tile on gridDim.y (up
// to 65535 tiles), offsets in 64 bits.
//
// Design (simple and correct first):
//   * each row's divisor is quantized and decoded once per q tile into shared
//     memory (as K2 does), so the SRT recurrence runs once per score element;
//   * the score step (tile_p_ds) is inlined once per kernel, its loop not
//     unrolled, to keep the build time of the nine plans short;
//   * every sum runs in a fixed order inside one block, with no atomics and
//     no split reduction, so two runs give the same bits;
//   * q tiles past the causal limit of a key tile, and key tiles past the
//     causal limit of a q tile, are skipped: they are exact no-ops (e = 0,
//     so p = 0 and ds = 0);
//   * s is computed in the forward kernel's order (one f32 FMA chain over
//     head_dim, then a separately rounded multiply by scale), so a recomputed
//     e is the forward's e.
//
// Instantiated for the plans posit::kModelPlan names, as K3/K6 are: every
// posit8, posit16, posit32 and posit64 plan; posit32 srt_r4_scaled and
// posit64 run p = e / l on K1's two-word frame with a 48-byte divisor per
// row.  K/V are bf16 or f32, a flag of the call (the tiles are f32 in
// shared memory either way); dk / dv are f32 and the caller casts them to
// K/V's dtype.  Built once per format and part, as posit_flash_attn.cu is
// (posit::kLibraryPlan): other (format, plan) pairs return -1.
//
// Bound: per attended (row, key) pair K7 does 6*hd f32 flops and K8 8*hd,
// and each does one posit division (a few hundred 32-bit operations at
// posit16, a few thousand at posit64; chip_smoke.py div_ops counts them per
// plan): both are bounded by operations, not bytes (they read q, dO, k, v
// and the row vectors once per tile).  The products run on CUDA cores in
// f32; tensor cores are left for a later version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "posit_srt.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kHdMax = 128;  // largest head_dim the kernels take
constexpr int kBQ = 16;      // query rows per q tile
constexpr int kBKq = 64;     // keys per key tile of K7
constexpr int kBKk = 32;     // keys per block of K8

// p and ds for a (kBQ, bk) score tile: query rows [0, rows) at positions
// qp0 + r against keys [k0, k0 + bk) (those at or past Sk are masked).
// sK/sV rows have stride hd + 1; sP may be null (K7 needs ds only).
template <class P>
__device__ void tile_p_ds(const float* sQ, const float* sG, const float* sK, const float* sV,
                          const posit::DivisorOf<P>* sDiv, const float* sM, const float* sD,
                          float* sP, float* sDS, int rows, int bk, int hd, int qp0, int k0,
                          int Sk, float scale, int causal, int window) {
#pragma unroll 1
  for (int i = threadIdx.x; i < kBQ * bk; i += kThreads) {
    const int r = i / bk, j = i % bk;
    const int qp = qp0 + r, kp = k0 + j;
    bool valid = r < rows && kp < Sk;
    if (causal) valid = valid && qp >= kp;
    if (window) valid = valid && qp - kp < window;
    float s = 0.f, dp = 0.f;
    for (int d = 0; d < hd; ++d) {
      s += sQ[r * hd + d] * sK[j * (hd + 1) + d];
      dp += sG[r * hd + d] * sV[j * (hd + 1) + d];
    }
    const float e = valid ? expf(__fmul_rn(s, scale) - sM[r]) : 0.f;
    const float p = posit::divide_float<P>(e, sDiv[r]);
    if (sP != nullptr) sP[i] = p;
    sDS[i] = p * (dp - sD[r]);
  }
}

// Rows [q0, q0 + rows) of head bh's q and dO into sQ / sG, and their m, D
// and prepared divisors (zero rows, minpos divisor past the edge).
template <class P>
__device__ void load_q_tile(const float* q, const float* g, const float* m, const float* l,
                            const float* D, float* sQ, float* sG, float* sM, float* sD,
                            posit::DivisorOf<P>* sDiv, int b, int h, int bh, int q0, int rows,
                            int Sq, int H, int hd, float eps) {
  for (int i = threadIdx.x; i < kBQ * hd; i += kThreads) {
    const int r = i / hd, d = i % hd;
    const size_t off = ((static_cast<size_t>(b) * Sq + q0 + r) * H + h) * hd + d;
    sQ[i] = r < rows ? q[off] : 0.f;
    sG[i] = r < rows ? g[off] : 0.f;
  }
  if (threadIdx.x < kBQ) {
    const int r = threadIdx.x;
    const size_t row = static_cast<size_t>(bh) * Sq + q0 + r;
    const float lv = r < rows ? l[row] : 0.f;
    sM[r] = r < rows ? m[row] : 0.f;
    sD[r] = r < rows ? D[row] : 0.f;
    sDiv[r] = posit::prep_divisor<P>(lv > 0.f ? lv : eps);
  }
}

// One K/V element as f32: from the f32 tensor where the call gave f32 K/V
// (f not null, the same in every block), else from the bf16 one, upcast
// exactly.  One select per element: on an H100 a branch per tile between
// two copies of the loop (posit_flash_attn.cu's form) cost K7 2-3%, this
// form left it 5% faster (PERF.md section 6).
__device__ __forceinline__ float kv_at(const __nv_bfloat16* b, const float* f, size_t off) {
  return f != nullptr ? f[off] : __bfloat162float(b[off]);
}

// Keys [k0, k0 + bk) of kv head kvh into sK / sV (stride hd + 1), as f32.
__device__ void load_kv_tile(const __nv_bfloat16* k, const __nv_bfloat16* v, const float* kf,
                             const float* vf, float* sK, float* sV, int b, int kvh, int k0,
                             int bk, int Sk, int KVH, int hd) {
  for (int i = threadIdx.x; i < bk * hd; i += kThreads) {
    const int j = i / hd, d = i % hd;
    const int kp = k0 + j;
    const bool in = kp < Sk;
    const size_t off = ((static_cast<size_t>(b) * Sk + (in ? kp : 0)) * KVH + kvh) * hd + d;
    sK[j * (hd + 1) + d] = in ? kv_at(k, kf, off) : 0.f;
    sV[j * (hd + 1) + d] = in ? kv_at(v, vf, off) : 0.f;
  }
}

// The per-row divisors first (28 bytes each, 48 on the two-word frame: the
// floats after them stay aligned), then the float tiles.
template <class P>
size_t smem_bytes(int bk, int hd) {
  return sizeof(posit::DivisorOf<P>) * kBQ +
         sizeof(float) * (2 * kBQ * hd + 2 * bk * (hd + 1) + 2 * kBQ * bk + 2 * kBQ);
}

template <class P>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const float* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const float* __restrict__ kf,
                        const float* __restrict__ vf, const float* __restrict__ g,
                        const float* __restrict__ m, const float* __restrict__ l,
                        const float* __restrict__ D, float* __restrict__ dq, int Sq, int Sk,
                        int H, int KVH, int hd, float scale, int causal, int window,
                        int q_offset, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  posit::DivisorOf<P>* sDiv = reinterpret_cast<posit::DivisorOf<P>*>(smem);
  float* sQ = reinterpret_cast<float*>(sDiv + kBQ);
  float* sG = sQ + kBQ * hd;
  float* sK = sG + kBQ * hd;
  float* sV = sK + kBKq * (hd + 1);
  float* sDS = sV + kBKq * (hd + 1);
  float* sM = sDS + kBQ * kBKq;
  float* sD = sM + kBQ;

  constexpr int kAcc = kBQ * kHdMax / kThreads;
  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KVH);
  const int q0 = blockIdx.y * kBQ;
  const int rows = min(kBQ, Sq - q0);
  const int qp0 = q_offset + q0;

  load_q_tile<P>(q, g, m, l, D, sQ, sG, sM, sD, sDiv, b, h, bh, q0, rows, Sq, H, hd, eps);
  float acc[kAcc];
#pragma unroll
  for (int a = 0; a < kAcc; ++a) acc[a] = 0.f;

  int kv_end = Sk;
  if (causal) kv_end = min(kv_end, qp0 + rows);  // last row's position + 1
  const int ntiles = kv_end > 0 ? (kv_end + kBKq - 1) / kBKq : 0;
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * kBKq;
    __syncthreads();
    load_kv_tile(k, v, kf, vf, sK, sV, b, kvh, k0, kBKq, Sk, KVH, hd);
    __syncthreads();
    tile_p_ds<P>(sQ, sG, sK, sV, sDiv, sM, sD, nullptr, sDS, rows, kBKq, hd, qp0, k0, Sk, scale,
                 causal, window);
    __syncthreads();
#pragma unroll
    for (int a = 0; a < kAcc; ++a) {
      const int i = tid + a * kThreads;
      if (i < kBQ * hd) {
        const int r = i / hd, d = i % hd;
        float s = 0.f;
        for (int j = 0; j < kBKq; ++j) s += sDS[r * kBKq + j] * sK[j * (hd + 1) + d];
        acc[a] += s;
      }
    }
  }
#pragma unroll
  for (int a = 0; a < kAcc; ++a) {
    const int i = tid + a * kThreads;
    if (i < rows * hd) {
      const int r = i / hd, d = i % hd;
      dq[((static_cast<size_t>(b) * Sq + q0 + r) * H + h) * hd + d] = acc[a] * scale;
    }
  }
}

template <class P>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const float* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, const float* __restrict__ kf,
                         const float* __restrict__ vf, const float* __restrict__ g,
                         const float* __restrict__ m, const float* __restrict__ l,
                         const float* __restrict__ D, float* __restrict__ dk,
                         float* __restrict__ dv, int Sq, int Sk, int H, int KVH, int hd,
                         float scale, int causal, int window, int q_offset, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  posit::DivisorOf<P>* sDiv = reinterpret_cast<posit::DivisorOf<P>*>(smem);
  float* sQ = reinterpret_cast<float*>(sDiv + kBQ);
  float* sG = sQ + kBQ * hd;
  float* sK = sG + kBQ * hd;
  float* sV = sK + kBKk * (hd + 1);
  float* sP = sV + kBKk * (hd + 1);
  float* sDS = sP + kBQ * kBKk;
  float* sM = sDS + kBQ * kBKk;
  float* sD = sM + kBQ;

  constexpr int kAcc = kBKk * kHdMax / kThreads;
  const int tid = threadIdx.x;
  const int b = blockIdx.x / KVH, kvh = blockIdx.x % KVH;
  const int G = H / KVH;
  const int k0 = blockIdx.y * kBKk;
  const int nkeys = min(kBKk, Sk - k0);
  const int nq = (Sq + kBQ - 1) / kBQ;
  // first q tile holding a row at or past key k0 (the earlier ones are fully
  // masked under the causal mask)
  const int i0 = causal && k0 > q_offset ? (k0 - q_offset) / kBQ : 0;

  load_kv_tile(k, v, kf, vf, sK, sV, b, kvh, k0, kBKk, Sk, KVH, hd);
  float acc_k[kAcc], acc_v[kAcc];
#pragma unroll
  for (int a = 0; a < kAcc; ++a) acc_k[a] = acc_v[a] = 0.f;

  for (int gi = 0; gi < G; ++gi) {
    const int h = kvh * G + gi;
    const int bh = b * H + h;
    for (int it = i0; it < nq; ++it) {
      const int q0 = it * kBQ;
      const int rows = min(kBQ, Sq - q0);
      __syncthreads();
      load_q_tile<P>(q, g, m, l, D, sQ, sG, sM, sD, sDiv, b, h, bh, q0, rows, Sq, H, hd, eps);
      __syncthreads();
      tile_p_ds<P>(sQ, sG, sK, sV, sDiv, sM, sD, sP, sDS, rows, kBKk, hd, q_offset + q0, k0, Sk,
                   scale, causal, window);
      __syncthreads();
#pragma unroll
      for (int a = 0; a < kAcc; ++a) {
        const int i = tid + a * kThreads;
        if (i < kBKk * hd) {
          const int j = i / hd, d = i % hd;
          float sv = 0.f, sk = 0.f;
          for (int r = 0; r < kBQ; ++r) {
            sv += sP[r * kBKk + j] * sG[r * hd + d];
            sk += sDS[r * kBKk + j] * sQ[r * hd + d];
          }
          acc_v[a] += sv;
          acc_k[a] += sk;
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < kAcc; ++a) {
    const int i = tid + a * kThreads;
    if (i < nkeys * hd) {
      const int j = i / hd, d = i % hd;
      const size_t off = ((static_cast<size_t>(b) * Sk + k0 + j) * KVH + kvh) * hd + d;
      dk[off] = acc_k[a] * scale;
      dv[off] = acc_v[a];
    }
  }
}

template <class Kern>
int prepare(Kern kern, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

// k / v as the kernels take them: the bf16 pair, or the f32 pair.
struct KV {
  const __nv_bfloat16 *k, *v;
  const float *kf, *vf;
};

KV kv_of(const void* k, const void* v, int kv_f32) {
  if (kv_f32) return {nullptr, nullptr, static_cast<const float*>(k),
                      static_cast<const float*>(v)};
  return {static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v), nullptr,
          nullptr};
}

}  // namespace

// Shapes (all contiguous on the device): q, g (dO), dq: (B, Sq, H, hd) f32;
// k, v: (B, Sk, KVH, hd) bf16, or f32 where kv_f32 is not 0; dk, dv:
// (B, Sk, KVH, hd) f32; m, l, D:
// (B*H, Sq) f32.  Each returns 0, a cudaError_t, -1 when no plan compiled
// into this library (posit::kLibraryPlan) matches, -2 for a head_dim above
// kHdMax, a bad head split, B*H past 2^31 - 1 or more than 65535 tiles.
extern "C" int posit_flash_bwd_dq(int n, int radix, int red, int otf, int scaled, int nonrest,
                                  int it, int shift, int gbits, int kv_f32, const float* q,
                                  const void* k,
                                  const void* v, const float* g, const float* m, const float* l,
                                  const float* D, float* dq, int B, int Sq, int Sk, int H,
                                  int KVH, int hd, float scale, int causal, int window,
                                  int q_offset, float eps, void* stream) {
  if (hd > kHdMax || hd <= 0 || KVH <= 0 || H % KVH) return -2;
  if (B <= 0 || Sq <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = -1;
  posit::dispatch_plan(n, radix, red, otf, scaled, nonrest, it, shift, gbits, [&](auto plan) {
    using P = decltype(plan);
    if constexpr (posit::kLibraryPlan<P>) {
      auto kern = flash_bwd_dq_kernel<P>;
      const size_t bytes = smem_bytes<P>(kBKq, hd);
      rc = prepare(kern, bytes);
      if (rc != 0) return;
      const long long heads = static_cast<long long>(B) * H;
      const int tiles = (Sq + kBQ - 1) / kBQ;
      if (heads > 0x7FFFFFFFLL || tiles > 65535) {
        rc = -2;
        return;
      }
      const dim3 grid(static_cast<unsigned>(heads), tiles);
      const KV kv = kv_of(k, v, kv_f32);
      kern<<<grid, kThreads, bytes, s>>>(q, kv.k, kv.v, kv.kf, kv.vf, g, m, l, D, dq, Sq, Sk,
                                         H, KVH, hd, scale, causal, window, q_offset, eps);
      rc = static_cast<int>(cudaGetLastError());
    }
  });
  return rc;
}

extern "C" int posit_flash_bwd_dkv(int n, int radix, int red, int otf, int scaled, int nonrest,
                                   int it, int shift, int gbits, int kv_f32, const float* q,
                                   const void* k,
                                   const void* v, const float* g, const float* m, const float* l,
                                   const float* D, float* dk, float* dv, int B, int Sq, int Sk,
                                   int H, int KVH, int hd, float scale, int causal, int window,
                                   int q_offset, float eps, void* stream) {
  if (hd > kHdMax || hd <= 0 || KVH <= 0 || H % KVH) return -2;
  if (B <= 0 || Sk <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = -1;
  posit::dispatch_plan(n, radix, red, otf, scaled, nonrest, it, shift, gbits, [&](auto plan) {
    using P = decltype(plan);
    if constexpr (posit::kLibraryPlan<P>) {
      auto kern = flash_bwd_dkv_kernel<P>;
      const size_t bytes = smem_bytes<P>(kBKk, hd);
      rc = prepare(kern, bytes);
      if (rc != 0) return;
      const long long heads = static_cast<long long>(B) * KVH;
      const int tiles = (Sk + kBKk - 1) / kBKk;
      if (heads > 0x7FFFFFFFLL || tiles > 65535) {
        rc = -2;
        return;
      }
      const dim3 grid(static_cast<unsigned>(heads), tiles);
      const KV kv = kv_of(k, v, kv_f32);
      kern<<<grid, kThreads, bytes, s>>>(q, kv.k, kv.v, kv.kf, kv.vf, g, m, l, D, dk, dv, Sq,
                                         Sk, H, KVH, hd, scale, causal, window, q_offset, eps);
      rc = static_cast<int>(cudaGetLastError());
    }
  });
  return rc;
}
