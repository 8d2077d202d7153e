// K3 / K6: flash-attention forward with the posit SRT normalizer (dense
// layout), optionally saving the row residuals (m, l).
//
// Replaces the dense branch (pages = 0, has_seg = False) of _flash_kernel /
// _flash_call (src/repro/kernels/posit_flash_attn.py :96-:357, pallas_call
// :330): save_res = False reached through posit_flash_attention (K3, the
// serving path), save_res = True through posit_flash_attention_fwd :424
// (K6, the training forward).  It computes the
// online-softmax kv scan carrying (m, l, acc), GQA by head index, the
// causal / window / kv_start / kv_len / q_pos masks, and the final acc / l
// through K1 as a rowwise posit divide, minpos for fully masked rows.
//
// Design (simple and correct first):
//   * one block per (q tile of bq rows, b*H + h), bq = 16 (1 for decode);
//     the KV head is h / G, so K/V are read in place, never repeated;
//   * a loop over kv tiles of kBK keys staged in shared memory as f32 (the
//     bf16 K/V are upcast in registers, exactly), QK^T and PV as f32 FMA;
//   * each row's m and l and the block's acc stay in registers (acc) or a
//     few shared floats (m, l, corr); every per-row reduction runs
//     sequentially in key order, with no atomics and no split of the scan;
//   * kv tiles are anchored at the row's kv_start: tile t covers keys
//     [kv_start + t*kBK, kv_start + (t+1)*kBK).  A request's real keys then
//     fall into the same tiles whatever its left-pad length, so its rows are
//     bit-identical solo, batched or admitted mid-flight.  Tiles past kv_len
//     (and past the causal limit) are skipped; they would be exact no-ops;
//   * K6 is the same kernel with two more outputs: each row's final m and l,
//     f32, laid out (B*H, Sq).  Null pointers mean no residuals, so K3 and
//     K6 share every instantiation (build time follows their count).
//
// Instantiated for the posit16 plans only, with bf16 K/V (what the serving
// path runs: posit16 numerics over the bf16 cache); other formats and f32
// K/V return -1.
//
// Bound: decode reads the bf16 KV cache once (B*Sk*KV*hd*2 bytes per K and
// per V) and is memory-bound; prefill does 4*B*H*Sq*Sk*hd f32 FMA flops.
// Tensor cores are left for a later version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "posit_srt.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBK = 64;        // keys per kv tile
constexpr int kHdMax = 128;    // largest head_dim the kernel takes
constexpr int kBQMax = 16;     // query rows per block (prefill)
constexpr float kNegInf = -1e30f;


inline size_t smem_bytes(int bq, int hd) {
  return sizeof(posit::Divisor) * bq                       // per-row divisor
         + sizeof(float) * (bq * hd + kBK * (hd + 1) + kBK * hd + bq * kBK + 3 * bq)
         + bq * kBK;                                       // mask bytes
}

// bq (1 or kBQMax) is the number of query rows of a block's tile; a row's
// result does not depend on it, so decode (Sq == 1) takes one-row tiles.
template <class P>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const float* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ m_out, float* __restrict__ l_out,
                 const int* __restrict__ kv_start, const int* __restrict__ kv_len,
                 const int* __restrict__ q_pos, int bq, int Sq, int Sk, int H, int KVH,
                 int hd, float scale, int causal, int window, int q_offset, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  posit::Divisor* sDiv = reinterpret_cast<posit::Divisor*>(smem);
  float* sQ = reinterpret_cast<float*>(sDiv + bq);
  float* sK = sQ + bq * hd;
  float* sV = sK + kBK * (hd + 1);  // K rows padded: no bank conflicts in QK^T
  float* sS = sV + kBK * hd;
  float* sM = sS + bq * kBK;
  float* sL = sM + bq;
  float* sC = sL + bq;
  unsigned char* sMask = reinterpret_cast<unsigned char*>(sC + bq);

  constexpr int kAcc = (kBQMax * kHdMax + kThreads - 1) / kThreads;
  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KVH);
  const int q0 = blockIdx.x * bq;
  const int rows = min(bq, Sq - q0);
  const int ks = kv_start[b];
  const int kl = min(kv_len[b], Sk);
  const int qp0 = q_pos[b] + q_offset + q0;

  for (int i = tid; i < bq * hd; i += kThreads) {
    const int r = i / hd, d = i % hd;
    sQ[i] = r < rows ? q[((static_cast<size_t>(b) * Sq + q0 + r) * H + h) * hd + d] : 0.f;
  }
  if (tid < bq) {
    sM[tid] = kNegInf;
    sL[tid] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int a = 0; a < kAcc; ++a) acc[a] = 0.f;

  int kv_end = kl;
  if (causal) kv_end = min(kv_end, qp0 + rows);  // last row's q_pos + 1
  const int ntiles = kv_end > ks ? (kv_end - ks + kBK - 1) / kBK : 0;

  for (int t = 0; t < ntiles; ++t) {
    const int base = ks + t * kBK;
    __syncthreads();
    for (int i = tid; i < kBK * hd; i += kThreads) {
      const int j = i / hd, d = i % hd;
      const int kp = base + j;
      const bool in = kp >= 0 && kp < Sk;
      const size_t off = ((static_cast<size_t>(b) * Sk + (in ? kp : 0)) * KVH + kvh) * hd + d;
      sK[j * (hd + 1) + d] = in ? __bfloat162float(k[off]) : 0.f;
      sV[i] = in ? __bfloat162float(v[off]) : 0.f;
    }
    __syncthreads();
    // scores s = (q . k) * scale, masked as the reference does
    for (int i = tid; i < bq * kBK; i += kThreads) {
      const int r = i / kBK, j = i % kBK;
      const int kp = base + j, qp = qp0 + r;
      bool valid = r < rows && kp >= ks && kp < kl;
      if (causal) valid = valid && qp >= kp;
      if (window) valid = valid && qp - kp < window;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s += sQ[r * hd + d] * sK[j * (hd + 1) + d];
      sS[i] = valid ? s * scale : kNegInf;
      sMask[i] = valid;
    }
    __syncthreads();
    // online-softmax statistics, one thread per row, keys in order
    if (tid < bq) {
      const int r = tid;
      const float m = sM[r];
      float m_new = m;
      for (int j = 0; j < kBK; ++j) m_new = fmaxf(m_new, sS[r * kBK + j]);
      float sum = 0.f;
      for (int j = 0; j < kBK; ++j) {
        const float p = sMask[r * kBK + j] ? expf(sS[r * kBK + j] - m_new) : 0.f;
        sS[r * kBK + j] = p;
        sum += p;
      }
      const float corr = expf(m - m_new);
      sL[r] = sL[r] * corr + sum;
      sM[r] = m_new;
      sC[r] = corr;
    }
    __syncthreads();
    // acc = acc * corr + p @ v
#pragma unroll
    for (int a = 0; a < kAcc; ++a) {
      const int i = tid + a * kThreads;
      if (i < bq * hd) {
        const int r = i / hd, d = i % hd;
        float s = 0.f;
        for (int j = 0; j < kBK; ++j) s += sS[r * kBK + j] * sV[j * hd + d];
        acc[a] = acc[a] * sC[r] + s;
      }
    }
  }

  // epilogue: o = acc / l through K1, the row divisor prepared once per row;
  // a fully masked row has l == 0 and divides 0 by minpos instead.  acc goes
  // through shared memory (sQ is free now) so the divide is inlined once.
  __syncthreads();
#pragma unroll
  for (int a = 0; a < kAcc; ++a) {
    const int i = tid + a * kThreads;
    if (i < bq * hd) sQ[i] = acc[a];
  }
  if (tid < bq) sDiv[tid] = posit::prep_divisor<P>(sL[tid] > 0.f ? sL[tid] : eps);
  __syncthreads();
#pragma unroll 1
  for (int i = tid; i < rows * hd; i += kThreads) {
    const int r = i / hd, d = i % hd;
    out[((static_cast<size_t>(b) * Sq + q0 + r) * H + h) * hd + d] =
        posit::divide_float<P>(sQ[i], sDiv[r]);
  }
  // K6: each row's final m and l, stored last.  Stored before the output
  // loop, the same store left K3 (null pointers) 5-11% slower on an H100:
  // ptxas then scheduled the tile loop worse (PERF.md, section 6).
  if (m_out != nullptr && tid < rows) {
    const size_t row = static_cast<size_t>(bh) * Sq + q0 + tid;
    m_out[row] = sM[tid];
    l_out[row] = sL[tid];
  }
}

template <class P>
int launch(const float* q, const __nv_bfloat16* k, const __nv_bfloat16* v, float* out,
           float* m_out, float* l_out, const int* kv_start, const int* kv_len,
           const int* q_pos, int B, int Sq, int Sk, int H, int KVH, int hd, float scale,
           int causal, int window, int q_offset, float eps,
           cudaStream_t s) {
  auto kern = flash_kernel<P>;
  const int bq = Sq == 1 ? 1 : kBQMax;
  const size_t bytes = smem_bytes(bq, hd);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + bq - 1) / bq, B * H);
  kern<<<grid, kThreads, bytes, s>>>(q, k, v, out, m_out, l_out, kv_start, kv_len, q_pos, bq,
                                     Sq, Sk, H, KVH, hd, scale, causal, window, q_offset,
                                     eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (B, Sq, H, hd) f32; k, v: (B, Sk, KVH, hd) bf16; out: (B, Sq, H, hd)
// f32; m_out / l_out: (B*H, Sq) f32, or both null (K3: no residuals);
// kv_start / kv_len / q_pos: (B,) int32; all contiguous on the device.
// Returns 0, a cudaError_t, -1 when no compiled posit16 plan matches, -2 for
// a head_dim above kHdMax or a bad head split.
extern "C" int posit_flash_attn_fwd(int n, int radix, int red, int otf, int scaled, int nonrest,
                                    int it, int shift, int gbits, const float* q,
                                    const void* k, const void* v, float* out, float* m_out,
                                    float* l_out, const int* kv_start, const int* kv_len,
                                    const int* q_pos,
                                    int B, int Sq, int Sk, int H, int KVH, int hd, float scale,
                                    int causal, int window, int q_offset, float eps,
                                    void* stream) {
  if (hd > kHdMax || hd <= 0 || KVH <= 0 || H % KVH) return -2;
  if (B <= 0 || Sq <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = -1;
  posit::dispatch_plan(n, radix, red, otf, scaled, nonrest, it, shift, gbits, [&](auto plan) {
    using P = decltype(plan);
    if constexpr (P::n == 16) {
      rc = launch<P>(q, static_cast<const __nv_bfloat16*>(k),
                     static_cast<const __nv_bfloat16*>(v), out, m_out, l_out, kv_start,
                     kv_len, q_pos, B, Sq, Sk, H, KVH, hd, scale, causal, window, q_offset, eps, s);
    }
  });
  return rc;
}
