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
// Both grids put b*H + h (K8: b*KVH + kv head) on gridDim.x (up to
// 2^31 - 1; gridDim.y stopped them at 65535) and the tile on gridDim.y (up
// to 65535 tiles), offsets in 64 bits.  Every sum runs in a fixed order
// inside one block, with no atomics and no split reduction, so two runs give
// the same bits.
//
// Bound: per attended (row, key) pair K7 does 6*hd flops of products and K8
// 8*hd, and each does one posit division (a few hundred 32-bit operations at
// posit16, a few thousand at posit64; chip_smoke.py div_ops counts them per
// plan): both are bounded by the divisions' integer operations, not by
// bytes (they read q, dO, k, v and the row vectors once per tile) and not
// by the products, a small share of the work at the tensor cores' rate.
//
// K7: one block of four warps per (q tile of kQRows = 16 rows, b*H + h),
// the heaviest q tile first under the causal mask (blockIdx.y = 0 is the
// last tile, which attends the most keys); a loop over key steps of kQKeys
// = 32 keys accumulates dq += ds k, scaled by `scale` at the end.  Like K8,
// it is bound by its divides, so the design keeps every warp dividing and
// divides only pairs the mask can reach:
//   * the q rows are fixed for the block: q and dO are staged once (f32,
//     zero-padded to the MMA depth), and lane (g, t) holds rows g and g + 8
//     of the tile, so it prepares those two rows' divisors (and m, D) once
//     per block, in registers;
//   * each step, warp w computes s = Q K^T and dp = dO V^T for keys
//     [8w, 8w + 8) of the step on the tensor cores (mma.sync m16n8k8 TF32
//     in 3xTF32, each three-product sum started from zero and added in f32,
//     as K8) and divides its C fragments in place: lane (g, t)'s four pairs
//     (rows g, g + 8; keys 2t, 2t + 1), two side by side per row so that
//     their SRT chains overlap; ds goes to a shared (rows, keys) tile;
//   * after a barrier warp w accumulates dq += ds K over the step's 32 keys
//     for a quarter of the head's columns on the tensor cores (ds as A
//     fragments, the k-step's keys in the order (0, 2, 4, 6, 1, 3, 5, 7) as
//     in K8), so each dq element is one warp's sum in a fixed order: no
//     atomics, no reduction across warps;
//   * key steps outside the block's causal / window range are not visited,
//     and a warp whose 8 keys no row of the tile attends writes ds = 0
//     without products or divides (masked pairs have p = 0 exactly);
//   * K/V arrive as bf16 or f32 and are copied as they are (cp.async of 16
//     or 4 bytes, zeros past Sk) into one staging buffer, then widened to
//     f32 tiles; the next step's copy is in flight while a step computes.
//     So f32 K/V holding bf16 values give the bf16 call's bits.  Rows whose
//     bytes are not a multiple of 4 are read straight from the tensors.
// s is not the forward's FMA order, so e may differ from the forward's by an
// f32 ulp and p by one posit step (within BWD_TOL, as K8).  Measured
// on an H100 (PERF.md section 6): 64-key steps (16 keys a warp) were 14%
// slower at posit16, and with its four divides a step side by side 19%; the
// two-word plans are built for three blocks an SM, since at four ptxas
// spilled posit64 nrd's two side-by-side 63-iteration chains (428 bytes).

// K8: one block of four warps per (key tile of kKeys = 16 keys, b*KVH + kv
// head).  What bounds it is the divisions: with them replaced by a multiply
// an earlier form of it ran several times faster, so its time is set by how
// evenly the divides spread over the SMs and how many of each SM's four
// schedulers issue them.  Under the causal mask key tile 0 walks every q
// tile of the G grouped heads and the last tile one per head: the first
// forms, warps of 16 keys over 64- or 32-key tiles, left a few SMs with most
// of the divides and ran no faster than the simple kernel, or slower.
// The design:
//   * small blocks, the heaviest first: one block covers 16 keys (one m16
//     row block), so the training shape launches 640 blocks, four resident
//     on an SM, and blockIdx.y = 0 (the heaviest, under the causal mask)
//     starts first; as blocks finish, the SMs even out (the reversed order
//     was 14-21% slower, tile j paired with tile nk - 1 - j in one block
//     9-14%: PERF.md section 6);
//   * every step (a q tile of kRows = 32 rows) keeps all four warps dividing:
//     warp w computes s^T = K Q^T and dp^T = V dO^T for rows [8w, 8w + 8) on
//     the tensor cores and stages them in shared memory; its lane (r, j)
//     prepares row r's divisor in registers (before the products, which it
//     overlaps) and runs p = e / l_safe through K1 (posit::divide_float) for
//     keys [4j, 4j + 4), kDivUnroll at a time so that their SRT chains
//     overlap; masked and past-edge pairs have e = 0 exactly; then, after a
//     barrier, warp w accumulates dv += p^T dO and dk += ds^T Q over all 32
//     rows for a quarter of the head's columns.  Each dk / dv element is one
//     warp's sum in registers: no reduction across warps, no atomics;
//   * all four products run on the tensor cores (mma.sync m16n8k8 TF32, f32
//     accumulate) with q, dO, p and ds (and K, V) split into tf32 hi and lo
//     parts (3xTF32), so they keep about f32's accuracy; p and ds feed the
//     second pair as A fragments in the C fragments' own layout (the
//     reduction's order within a k-step is permuted to match);
//   * the q tiles (q, dO, m, l, D) are double-buffered with cp.async: tile
//     i + 1 loads while tile i computes; a warp whose rows attend none of the
//     block's keys skips the tile's products and divides;
//   * K/V are staged once, as f32 whatever type arrives (bf16 upcast
//     exactly), so f32 K/V holding bf16 values give the bf16 call's bits;
//   * head_dim up to kBwdHdMax (256), zero-padded to a multiple of 8 (the
//     MMA depth); the tiles' row stride hd8 + 4 makes the fragment loads
//     conflict-free.  The head-dim class is a template parameter of both
//     kernels (kHdMax up to 128, kBwdHdMax past it): it sizes the
//     accumulators a thread holds, so the hd <= 128 instantiations keep
//     their code and the 256 class runs one block an SM.
// The MMA, load and staging code are plain device functions (the MMA and
// staging helpers, shared with the forward's tile loop, in flash_stage.cuh);
// only the divide depends on the plan, to keep the build of the nine plans
// short.
//
// Instantiated for the plans posit::kModelPlan names, as K3/K6 are: every
// posit8, posit16, posit32 and posit64 plan; posit32 srt_r4_scaled and
// posit64 run p = e / l on K1's two-word frame with a 48-byte divisor per
// row.  K/V are bf16 or f32, a flag of the call (the tiles are f32 in
// shared memory either way); dk / dv are f32 and the caller casts them to
// K/V's dtype.  Built once per format and part, as posit_flash_attn.cu is
// (posit::kLibraryPlan): other (format, plan) pairs return -1.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_stage.cuh"
#include "posit_srt.cuh"

namespace {

// ------------------------------------------------------------------- K7

constexpr int kQRows = 16;           // query rows per K7 block: one m16 row block
constexpr int kQScr = kQKeys + 8;    // row stride of K7's (kQRows, kQKeys) ds tile

// K7's shared memory: q and dO (kQRows rows), the f32 K and V tiles (kQKeys
// rows), the ds tile, then the staging buffer of the raw K and V rows
// (kQKeys rows of hd elements each of raw_elt bytes; none where the rows are
// read straight from the tensors).
__host__ __device__ inline size_t dq_smem_bytes(int hd, int raw_elt) {
  const int hdp = dkv_hdp(hd);
  return sizeof(float) * (2 * kQRows * hdp + 2 * kQKeys * hdp + kQRows * kQScr) +
         static_cast<size_t>(2) * kQKeys * hd * raw_elt;
}

// The warp's s = Q K^T and dp = dO V^T (16 rows, the 8 keys at sK / sV rows
// [key0, key0 + 8)) as C fragments: lane (g, t) holds rows g, g + 8 and
// keys 2t, 2t + 1.
__device__ __forceinline__ void dq_score_tile(const float* sQ, const float* sG, const float* sK,
                                              const float* sV, int hdp, int key0, int lane,
                                              float (&s)[4], float (&dp)[4]) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i] = dp[i] = 0.f;
  const float* qr = sQ + g * hdp + t;
  const float* gr = sG + g * hdp + t;
  const float* kr = sK + (key0 + g) * hdp + t;
  const float* vr = sV + (key0 + g) * hdp + t;
  const int depth = hdp - 4;
#pragma unroll 1
  for (int c = 0; c < depth; c += 8) {
    const FragA qa = frag_a(qr[c], qr[8 * hdp + c], qr[c + 4], qr[8 * hdp + c + 4]);
    const FragA ga = frag_a(gr[c], gr[8 * hdp + c], gr[c + 4], gr[8 * hdp + c + 4]);
    mma3(s, qa, frag_b(kr[c], kr[c + 4]));
    mma3(dp, ga, frag_b(vr[c], vr[c + 4]));
  }
}

// dq += ds K over the step's kQKeys keys for the warp's n-tiles [nd0, nd0 +
// ndn) of the head's columns.  Each k-step of 8 keys is taken in the order
// (0, 2, 4, 6, 1, 3, 5, 7): lane (g, t) holds A = ds's (g, 2t), (g + 8, 2t),
// (g, 2t + 1), (g + 8, 2t + 1) and B's key rows 2t and 2t + 1.
template <int kHd>
__device__ __forceinline__ void accumulate_dq(const float* sDS, const float* sK, int hdp,
                                              int nd0, int ndn, int lane,
                                              float (&acc)[kNtPartOf<kHd>][4]) {
  constexpr int kNtPart = kNtPartOf<kHd>;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int kk = 0; kk < kQKeys; kk += 8) {
    const float2 a0 = *reinterpret_cast<const float2*>(sDS + g * kQScr + kk + 2 * t);
    const float2 a1 = *reinterpret_cast<const float2*>(sDS + (g + 8) * kQScr + kk + 2 * t);
    const FragA da = frag_a(a0.x, a1.x, a0.y, a1.y);
    const float* kr = sK + (kk + 2 * t) * hdp + nd0 * 8 + g;
#pragma unroll
    for (int nd = 0; nd < kNtPart; ++nd)
      if (nd < ndn) mma3(acc[nd], da, frag_b(kr[nd * 8], kr[hdp + nd * 8]));
  }
}

// One block of four warps per (q tile of kQRows rows, b*H + h): see the
// note at the top.  chunk: the staging copies' size in bytes (16 or 4), or 0
// where K/V rows are read straight from the tensors.  kHd, the head-dim
// class (kHdMax or kBwdHdMax), sizes acc: 16 floats a thread at kHdMax, 32
// at kBwdHdMax, one block an SM there (its shared memory is 135-168 KB), so
// the kHdMax instantiations keep their code.
template <class P, int kHd>
__global__ void __launch_bounds__(kThreads, kHd > kHdMax ? 1 : P::words == 1 ? 4 : 3)
    flash_bwd_dq_kernel(const float* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const float* __restrict__ kf,
                        const float* __restrict__ vf, const float* __restrict__ g,
                        const float* __restrict__ m, const float* __restrict__ l,
                        const float* __restrict__ D, float* __restrict__ dq, int Sq, int Sk,
                        int H, int KVH, int hd, float scale, int causal, int window,
                        int q_offset, float eps, int chunk) {
  constexpr int kNtPart = kNtPartOf<kHd>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int hdp = dkv_hdp(hd), hd8 = hdp - 4;
  float* sQ = reinterpret_cast<float*>(smem);
  float* sG = sQ + kQRows * hdp;
  float* sK = sG + kQRows * hdp;
  float* sV = sK + kQKeys * hdp;
  float* sDS = sV + kQKeys * hdp;
  unsigned char* raw = chunk ? reinterpret_cast<unsigned char*>(sDS + kQRows * kQScr) : nullptr;
  const int elt = kf != nullptr ? 4 : 2;
  const unsigned char* kraw = kf != nullptr ? reinterpret_cast<const unsigned char*>(kf)
                                            : reinterpret_cast<const unsigned char*>(k);
  const unsigned char* vraw = kf != nullptr ? reinterpret_cast<const unsigned char*>(vf)
                                            : reinterpret_cast<const unsigned char*>(v);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, t = lane % 4;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int kvh = h / (H / KVH);
  // under the causal mask the last q tile attends the most keys: it goes
  // first, so the last blocks to start are the lightest
  const int nq = (Sq + kQRows - 1) / kQRows;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.y)) * kQRows;
  const int rows = min(kQRows, Sq - q0);
  const int qp0 = q_offset + q0;
  // the keys some row of the tile attends: [k_lo, k_hi)
  int k_hi = Sk;
  if (causal) k_hi = min(k_hi, qp0 + rows);   // the last row's position + 1
  int k_lo = 0;
  if (window) k_lo = max(0, qp0 - window + 1);  // the first row's first key
  const int t0 = k_lo / kQKeys;
  const int t1 = k_hi > k_lo ? (k_hi + kQKeys - 1) / kQKeys : t0;
  if (raw != nullptr && t0 < t1)
    start_kv_copy(kraw, vraw, raw, raw + kQKeys * hd * elt, b, kvh, t0 * kQKeys, Sk, KVH, hd,
                 elt, chunk);

  // the tile's q and dO rows (zeros past Sq and in the columns [hd, hd8))
  for (int i = threadIdx.x; i < kQRows * hd8; i += kThreads) {
    const int r = i / hd8, d = i % hd8;
    const bool in = r < rows && d < hd;
    const size_t off = ((static_cast<size_t>(b) * Sq + q0 + (in ? r : 0)) * H + h) * hd +
                       (in ? d : 0);
    sQ[r * hdp + d] = in ? q[off] : 0.f;
    sG[r * hdp + d] = in ? g[off] : 0.f;
  }
  // rows gq and gq + 8: m, D and the divisor l_safe, once per block
  float mr[2], Dr[2], lr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = gq + 8 * i;
    const size_t row = static_cast<size_t>(bh) * Sq + q0 + (r < rows ? r : 0);
    mr[i] = r < rows ? m[row] : 0.f;
    Dr[i] = r < rows ? D[row] : 0.f;
    lr[i] = r < rows ? l[row] : 0.f;
  }
  const posit::DivisorOf<P> div0 = posit::prep_divisor<P>(lr[0] > 0.f ? lr[0] : eps);
  const posit::DivisorOf<P> div1 = posit::prep_divisor<P>(lr[1] > 0.f ? lr[1] : eps);

  // the warp's n-tiles of the head's columns: a quarter of them
  const int nts = hd8 / 8;
  const int nd0 = warp * nts / kWarps, ndn = (warp + 1) * nts / kWarps - nd0;
  float acc[kNtPart][4];
#pragma unroll
  for (int nd = 0; nd < kNtPart; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nd][i] = 0.f;

  for (int st = t0; st < t1; ++st) {
    const int k0 = st * kQKeys;
    cp_async_wait_all();
    __syncthreads();   // the step's rows have landed; every warp is done with the last step
    widen_kv(raw, k, v, kf, vf, sK, sV, b, kvh, k0, Sk, KVH, hd, hdp);
    __syncthreads();
    if (raw != nullptr && st + 1 < t1)
      start_kv_copy(kraw, vraw, raw, raw + kQKeys * hd * elt, b, kvh, k0 + kQKeys, Sk, KVH, hd,
                   elt, chunk);
    const int kw = k0 + 8 * warp;   // the warp's first key
    float2* ds0 = reinterpret_cast<float2*>(sDS + gq * kQScr + 8 * warp + 2 * t);
    float2* ds1 = reinterpret_cast<float2*>(sDS + (gq + 8) * kQScr + 8 * warp + 2 * t);
    if (kw >= k_hi || kw + 8 <= k_lo) {
      // no row of the tile attends the warp's keys: p = 0 and ds = 0
      *ds0 = *ds1 = make_float2(0.f, 0.f);
    } else {
      float s[4], dp[4];
      dq_score_tile(sQ, sG, sK, sV, hdp, 8 * warp, lane, s, dp);
      // p = e / l_safe per pair through K1, ds = p (dp - D): masked and
      // past-edge pairs have e = 0 exactly, so p = 0.  Row gq, then row gq
      // + 8, each with its two keys side by side.
#pragma unroll 1
      for (int i = 0; i < 2; ++i) {
        const int r = gq + 8 * i;
        const int qp = qp0 + r;
        const float sa = i ? s[2] : s[0], sb = i ? s[3] : s[1];
        const float da = i ? dp[2] : dp[0], db = i ? dp[3] : dp[1];
        const float mi = i ? mr[1] : mr[0], Di = i ? Dr[1] : Dr[0];
        const posit::DivisorOf<P> dl = i ? div1 : div0;
        const int ka = kw + 2 * t, kb = ka + 1;
        bool va = r < rows && ka < Sk, vb = r < rows && kb < Sk;
        if (causal) {
          va = va && qp >= ka;
          vb = vb && qp >= kb;
        }
        if (window) {
          va = va && qp - ka < window;
          vb = vb && qp - kb < window;
        }
        const float ea = va ? expf(__fmul_rn(sa, scale) - mi) : 0.f;
        const float eb = vb ? expf(__fmul_rn(sb, scale) - mi) : 0.f;
        const float pa = posit::divide_float<P>(ea, dl);
        const float pb = posit::divide_float<P>(eb, dl);
        *(i ? ds1 : ds0) = make_float2(pa * (da - Di), pb * (db - Di));
      }
    }
    __syncthreads();   // every warp's ds is in the tile
    accumulate_dq<kHd>(sDS, sK, hdp, nd0, ndn, lane, acc);
  }

#pragma unroll
  for (int nd = 0; nd < kNtPart; ++nd) {
    if (nd < ndn) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = gq + (i >= 2 ? 8 : 0);
        const int d = (nd0 + nd) * 8 + 2 * t + (i & 1);
        if (r < rows && d < hd)
          dq[((static_cast<size_t>(b) * Sq + q0 + r) * H + h) * hd + d] = acc[nd][i] * scale;
      }
    }
  }
}

// ------------------------------------------------------------------- K8

constexpr int kKeys = 16;                // keys per K8 block: one m16 row block
constexpr int kRows = 32;                // query rows per K8 q tile
constexpr int kWarpRows = kRows / kWarps;  // a warp's rows of a tile in the score step
constexpr int kScr = kRows + 8;          // row stride of the (kKeys, kRows) scratch tiles
constexpr int kDivUnroll = 2;            // pairs a lane divides side by side

// K8's shared memory, in floats: K and V tiles (kKeys rows), two q / dO tile
// buffers (kRows rows), the row vectors m, l, D of both buffers, and two
// (kKeys, kRows) scratch tiles; rows have stride hdp.
struct DkvSmem {
  float *k, *v, *q, *g, *m, *l, *d, *scratch;
};

__host__ __device__ inline size_t dkv_smem_floats(int hd) {
  const int hdp = dkv_hdp(hd);
  return 2 * kKeys * hdp + 4 * kRows * hdp + 6 * kRows + 2 * kKeys * kScr;
}

__device__ __forceinline__ DkvSmem dkv_smem(float* base, int hdp) {
  DkvSmem s;
  s.k = base;
  s.v = s.k + kKeys * hdp;
  s.q = s.v + kKeys * hdp;
  s.g = s.q + 2 * kRows * hdp;
  s.m = s.g + 2 * kRows * hdp;
  s.l = s.m + 2 * kRows;
  s.d = s.l + 2 * kRows;
  s.scratch = s.d + 2 * kRows;
  return s;
}

// Keys [k0, k0 + kKeys) of kv head kvh into sK / sV as f32, whatever type
// arrives: zeros past Sk and in the columns [hd, hd8).  So f32 K/V holding
// bf16 values stage the bf16 call's bits.
__device__ void stage_kv(const __nv_bfloat16* k, const __nv_bfloat16* v, const float* kf,
                         const float* vf, float* sK, float* sV, int b, int kvh, int k0, int Sk,
                         int KVH, int hd, int hdp) {
  const int hd8 = hdp - 4;
  for (int i = threadIdx.x; i < kKeys * hd8; i += kThreads) {
    const int j = i / hd8, d = i % hd8;
    const int kp = k0 + j;
    const bool in = kp < Sk && d < hd;
    const size_t off =
        ((static_cast<size_t>(b) * Sk + (in ? kp : 0)) * KVH + kvh) * hd + (in ? d : 0);
    sK[j * hdp + d] = in ? kv_at(k, kf, off) : 0.f;
    sV[j * hdp + d] = in ? kv_at(v, vf, off) : 0.f;
  }
}

// The columns [hd, hd8) of both q / dO buffers are zeros; cp.async never
// writes them.
__device__ void zero_q_pads(float* sQ, float* sG, int hd, int hdp) {
  const int pad = hdp - 4 - hd;
  for (int i = threadIdx.x; i < 2 * kRows * pad; i += kThreads) {
    const int r = i / pad, d = hd + i % pad;
    sQ[r * hdp + d] = 0.f;
    sG[r * hdp + d] = 0.f;
  }
}

// Starts the copy of rows [q0, q0 + kRows) of head bh's q, dO, m, l and D
// into one buffer (rows past Sq as zeros) and commits it as one group.
// vec: 16-byte copies (hd % 4 == 0 and q, dO 16-byte aligned).
__device__ void issue_q_tile(const float* q, const float* g, const float* m, const float* l,
                             const float* D, float* sQ, float* sG, float* sM, float* sL,
                             float* sD, int b, int h, int bh, int q0, int Sq, int H, int hd,
                             int hdp, int vec) {
  const int step = vec ? 4 : 1, per_row = hd / step;
  for (int i = threadIdx.x; i < kRows * per_row; i += kThreads) {
    const int r = i / per_row, d = (i % per_row) * step;
    const bool in = q0 + r < Sq;
    const size_t off = ((static_cast<size_t>(b) * Sq + (in ? q0 + r : 0)) * H + h) * hd + d;
    if (vec) {
      cp_async16(sQ + r * hdp + d, q + off, in);
      cp_async16(sG + r * hdp + d, g + off, in);
    } else {
      cp_async4(sQ + r * hdp + d, q + off, in);
      cp_async4(sG + r * hdp + d, g + off, in);
    }
  }
  if (threadIdx.x < kRows) {
    const int r = threadIdx.x;
    const bool in = q0 + r < Sq;
    const size_t row = static_cast<size_t>(bh) * Sq + (in ? q0 + r : 0);
    cp_async4(sM + r, m + row, in);
    cp_async4(sL + r, l + row, in);
    cp_async4(sD + r, D + row, in);
  }
  cp_async_commit();
}

// The warp's s^T = K Q^T and dp^T = V dO^T tiles, (16 keys, kWarpRows
// rows), as C fragments: n-tile nt holds query rows [8 nt, 8 nt + 8).
__device__ __forceinline__ void score_tiles(const float* sK, const float* sV, const float* sQ,
                                            const float* sG, int hdp, int lane,
                                            float (&s)[kWarpRows / 8][4],
                                            float (&dp)[kWarpRows / 8][4]) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int nt = 0; nt < kWarpRows / 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[nt][i] = dp[nt][i] = 0.f;
  const float* kr = sK + g * hdp + t;
  const float* vr = sV + g * hdp + t;
  const float* qr = sQ + g * hdp + t;
  const float* gr = sG + g * hdp + t;
  const int depth = hdp - 4;
#pragma unroll 1
  for (int c = 0; c < depth; c += 8) {
    const FragA ka = frag_a(kr[c], kr[8 * hdp + c], kr[c + 4], kr[8 * hdp + c + 4]);
    const FragA va = frag_a(vr[c], vr[8 * hdp + c], vr[c + 4], vr[8 * hdp + c + 4]);
#pragma unroll
    for (int nt = 0; nt < kWarpRows / 8; ++nt) {
      const float* qn = qr + nt * 8 * hdp + c;
      const float* gn = gr + nt * 8 * hdp + c;
      mma3(s[nt], ka, frag_b(qn[0], qn[4]));
      mma3(dp[nt], va, frag_b(gn[0], gn[4]));
    }
  }
}

// C fragments (16, kWarpRows) into a scratch tile whose rows are keys.
__device__ __forceinline__ void stage_tile(float* scr, const float (&c)[kWarpRows / 8][4],
                                           int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int nt = 0; nt < kWarpRows / 8; ++nt) {
    *reinterpret_cast<float2*>(scr + g * kScr + nt * 8 + 2 * t) = make_float2(c[nt][0], c[nt][1]);
    *reinterpret_cast<float2*>(scr + (g + 8) * kScr + nt * 8 + 2 * t) =
        make_float2(c[nt][2], c[nt][3]);
  }
}

// dv += p^T dO and dk += ds^T Q over the tile's kRows query rows, for the
// warp's n-tiles [nd0, nd0 + ndn) of the head's columns; p and ds from the
// scratch tiles.  The reduction runs over query rows in k-steps
// of 8, each taken in the order (0, 2, 4, 6, 1, 3, 5, 7): lane (g, t) then
// holds A = p^T's (g, 2t), (g + 8, 2t), (g, 2t + 1), (g + 8, 2t + 1), the C
// fragment's own layout, and B's rows 2t and 2t + 1.
template <int kHd>
__device__ __forceinline__ void accumulate_dkv(const float* sP, const float* sDS,
                                               const float* sQ, const float* sG, int hdp,
                                               int nd0, int ndn, int lane,
                                               float (&dk)[kNtPartOf<kHd>][4],
                                               float (&dv)[kNtPartOf<kHd>][4]) {
  constexpr int kNtPart = kNtPartOf<kHd>;
  const int g = lane / 4, t = lane % 4;
#pragma unroll 1
  for (int kq = 0; kq < kRows; kq += 8) {
    const float2 p0 = *reinterpret_cast<const float2*>(sP + g * kScr + kq + 2 * t);
    const float2 p1 = *reinterpret_cast<const float2*>(sP + (g + 8) * kScr + kq + 2 * t);
    const float2 s0 = *reinterpret_cast<const float2*>(sDS + g * kScr + kq + 2 * t);
    const float2 s1 = *reinterpret_cast<const float2*>(sDS + (g + 8) * kScr + kq + 2 * t);
    const FragA pa = frag_a(p0.x, p1.x, p0.y, p1.y);
    const FragA sa = frag_a(s0.x, s1.x, s0.y, s1.y);
    const float* gr = sG + (kq + 2 * t) * hdp + nd0 * 8 + g;
    const float* qr = sQ + (kq + 2 * t) * hdp + nd0 * 8 + g;
#pragma unroll
    for (int nd = 0; nd < kNtPart; ++nd) {
      if (nd < ndn) {
        mma3(dv[nd], pa, frag_b(gr[nd * 8], gr[hdp + nd * 8]));
        mma3(dk[nd], sa, frag_b(qr[nd * 8], qr[hdp + nd * 8]));
      }
    }
  }
}

// One block per (key tile of kKeys = 16 keys, b*KVH + kv head), four warps,
// walking every q tile of kRows rows of the G grouped query heads,
// double-buffered.  In the score step warp w takes rows [8w, 8w + 8) of
// the tile (s, dp, the divides); after a barrier it accumulates a quarter
// of the head's columns of the tile's dk and dv rows over all its rows.  So
// each dk / dv element is one warp's sum: no reduction across warps, no
// atomics; and every block keeps all four of the SM's schedulers busy.
// kHd, the head-dim class, sizes acc_k and acc_v: 32 floats a thread
// together at kHdMax (four blocks an SM, 128 registers a thread), 64 at
// kBwdHdMax, where the shared memory (172 KB at head_dim 256) leaves one
// block an SM anyway and the bound lets a thread take 255 registers.
template <class P, int kHd>
__global__ void __launch_bounds__(kThreads, kHd > kHdMax ? 1 : 4)
    flash_bwd_dkv_kernel(const float* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, const float* __restrict__ kf,
                         const float* __restrict__ vf, const float* __restrict__ g,
                         const float* __restrict__ m, const float* __restrict__ l,
                         const float* __restrict__ D, float* __restrict__ dk,
                         float* __restrict__ dv, int Sq, int Sk, int H, int KVH, int hd,
                         float scale, int causal, int window, int q_offset, float eps,
                         int vec) {
  constexpr int kNtPart = kNtPartOf<kHd>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int hdp = dkv_hdp(hd);
  const DkvSmem sm = dkv_smem(reinterpret_cast<float*>(smem), hdp);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* sP = sm.scratch;                // s, then p
  float* sDS = sP + kKeys * kScr;        // dp, then ds
  // the warp's n-tiles of the head's columns: a quarter of them
  const int nts = (hdp - 4) / 8;
  const int nd0 = warp * nts / kWarps, ndn = (warp + 1) * nts / kWarps - nd0;

  const int b = blockIdx.x / KVH, kvh = blockIdx.x % KVH;
  const int G = H / KVH;
  // under the causal mask key tile 0 walks every q tile: the heaviest go
  // first, so the last blocks to start are the lightest
  const int k0 = blockIdx.y * kKeys;
  const int kl = min(k0 + kKeys, Sk) - 1;   // the block's last key
  const int nq = (Sq + kRows - 1) / kRows;
  // q tiles that can hold a row attending some key of the block: from the
  // first holding a row at or past key k0 (causal), to the last holding a
  // row within `window` of the block's last key
  const int i0 = causal && k0 > q_offset ? (k0 - q_offset) / kRows : 0;
  int i1 = nq;
  if (window) {
    const long long lim = static_cast<long long>(window) + kl - q_offset;
    i1 = lim <= 0 ? 0
                  : static_cast<int>(min(static_cast<long long>(nq), (lim + kRows - 1) / kRows));
  }
  const int nit = max(0, i1 - i0);
  const int steps = G * nit;

  stage_kv(k, v, kf, vf, sm.k, sm.v, b, kvh, k0, Sk, KVH, hd, hdp);
  zero_q_pads(sm.q, sm.g, hd, hdp);
  float acc_k[kNtPart][4], acc_v[kNtPart][4];
#pragma unroll
  for (int nd = 0; nd < kNtPart; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_k[nd][i] = acc_v[nd][i] = 0.f;

  auto issue = [&](int st) {
    const int h = kvh * G + st / nit, buf = st & 1;
    issue_q_tile(q, g, m, l, D, sm.q + buf * kRows * hdp, sm.g + buf * kRows * hdp,
                 sm.m + buf * kRows, sm.l + buf * kRows, sm.d + buf * kRows, b, h, b * H + h,
                 (i0 + st % nit) * kRows, Sq, H, hd, hdp, vec);
  };
  if (steps > 0) issue(0);
  for (int st = 0; st < steps; ++st) {
    const int buf = st & 1;
    cp_async_wait_all();
    __syncthreads();   // tile st has landed; every warp is done with tile st - 1
    if (st + 1 < steps) issue(st + 1);
    const int q0 = (i0 + st % nit) * kRows;
    const float* sQ = sm.q + buf * kRows * hdp;
    const float* sG = sm.g + buf * kRows * hdp;
    // the block's keys attend nothing in this tile, or the warp's rows attend
    // none of them: p = 0 and ds = 0 there, an exact no-op
    const int rows = min(kRows, Sq - q0);
    bool idle = false;
    if (causal) idle = q_offset + q0 + rows - 1 < k0;
    if (window) idle = idle || q_offset + q0 - kl >= window;
    const int r0 = kWarpRows * warp, wrows = min(kWarpRows, rows - r0);
    bool quiet = idle || wrows <= 0;
    if (causal) quiet = quiet || q_offset + q0 + r0 + wrows - 1 < k0;
    if (window) quiet = quiet || q_offset + q0 + r0 - kl >= window;
    if (quiet) {
      if (!idle)
        for (int i = lane; i < kKeys * kWarpRows; i += 32) {
          sP[(i / kWarpRows) * kScr + r0 + i % kWarpRows] = 0.f;
          sDS[(i / kWarpRows) * kScr + r0 + i % kWarpRows] = 0.f;
        }
    } else {
      // lane (kq, r) divides row r0 + r's pairs with keys [4 kq, 4 kq + 4):
      // its divisor, quantized and decoded once a tile, first, so that it
      // overlaps with the products
      const int r = r0 + lane % kWarpRows, kq = lane / kWarpRows;
      const float lv = sm.l[buf * kRows + r];
      const posit::DivisorOf<P> dl = posit::prep_divisor<P>(lv > 0.f ? lv : eps);
      const float mr = sm.m[buf * kRows + r], Dr = sm.d[buf * kRows + r];
      float s[kWarpRows / 8][4], dp[kWarpRows / 8][4];
      score_tiles(sm.k, sm.v, sQ + r0 * hdp, sG + r0 * hdp, hdp, lane, s, dp);
      stage_tile(sP + r0, s, lane);
      stage_tile(sDS + r0, dp, lane);
      __syncwarp();
      // p = e / l_safe per pair through K1, ds = p (dp - D): masked and
      // past-edge pairs have e = 0 exactly, so p = 0 and ds = 0
      const int qp = q_offset + q0 + r;
      constexpr int kPer = kKeys * kWarpRows / 32;   // pairs a lane divides
#pragma unroll 1
      for (int j = kPer * kq; j < kPer * kq + kPer; j += kDivUnroll) {
#pragma unroll
        for (int u = 0; u < kDivUnroll; ++u) {
          const int kp = k0 + j + u;
          bool valid = r < rows && kp < Sk;
          if (causal) valid = valid && qp >= kp;
          if (window) valid = valid && qp - kp < window;
          float* ps = sP + (j + u) * kScr + r;
          float* ds = sDS + (j + u) * kScr + r;
          const float e = valid ? expf(__fmul_rn(*ps, scale) - mr) : 0.f;
          const float p = posit::divide_float<P>(e, dl);
          *ds = p * (*ds - Dr);
          *ps = p;
        }
      }
    }
    __syncthreads();   // every row's p and ds are in the scratch tiles
    if (!idle) accumulate_dkv<kHd>(sP, sDS, sQ, sG, hdp, nd0, ndn, lane, acc_k, acc_v);
  }

  const int gq = lane / 4, t = lane % 4;
#pragma unroll
  for (int nd = 0; nd < kNtPart; ++nd) {
    if (nd < ndn) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kp = k0 + gq + (i >= 2 ? 8 : 0);
        const int d = (nd0 + nd) * 8 + 2 * t + (i & 1);
        if (kp < Sk && d < hd) {
          const size_t off = ((static_cast<size_t>(b) * Sk + kp) * KVH + kvh) * hd + d;
          dk[off] = acc_k[nd][i] * scale;
          dv[off] = acc_v[nd][i];
        }
      }
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
// kBwdHdMax, a bad head split, B*H past 2^31 - 1 or more than 65535 tiles.
// A head_dim up to kHdMax launches the kHdMax class, one past it the
// kBwdHdMax class.
extern "C" int posit_flash_bwd_dq(int n, int radix, int red, int otf, int scaled, int nonrest,
                                  int it, int shift, int gbits, int kv_f32, const float* q,
                                  const void* k,
                                  const void* v, const float* g, const float* m, const float* l,
                                  const float* D, float* dq, int B, int Sq, int Sk, int H,
                                  int KVH, int hd, float scale, int causal, int window,
                                  int q_offset, float eps, void* stream) {
  if (hd > kBwdHdMax || hd <= 0 || KVH <= 0 || H % KVH) return -2;
  if (B <= 0 || Sq <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = -1;
  posit::dispatch_plan(n, radix, red, otf, scaled, nonrest, it, shift, gbits, [&](auto plan) {
    using P = decltype(plan);
    if constexpr (posit::kLibraryPlan<P>) {
      auto kern = hd <= kHdMax ? flash_bwd_dq_kernel<P, kHdMax>
                               : flash_bwd_dq_kernel<P, kBwdHdMax>;
      // K/V rows staged by cp.async where each row's bytes (and the bases)
      // take 16- or 4-byte copies, else read straight from the tensors
      const int elt = kv_f32 ? 4 : 2;
      const int chunk = kv_chunk(k, v, hd, elt);
      const size_t bytes = dq_smem_bytes(hd, chunk ? elt : 0);
      rc = prepare(kern, bytes);
      if (rc != 0) return;
      const long long heads = static_cast<long long>(B) * H;
      const int tiles = (Sq + kQRows - 1) / kQRows;
      if (heads > 0x7FFFFFFFLL || tiles > 65535) {
        rc = -2;
        return;
      }
      const dim3 grid(static_cast<unsigned>(heads), tiles);
      const KV kv = kv_of(k, v, kv_f32);
      kern<<<grid, kThreads, bytes, s>>>(q, kv.k, kv.v, kv.kf, kv.vf, g, m, l, D, dq, Sq, Sk,
                                         H, KVH, hd, scale, causal, window, q_offset, eps,
                                         chunk);
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
  if (hd > kBwdHdMax || hd <= 0 || KVH <= 0 || H % KVH) return -2;
  if (B <= 0 || Sk <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = -1;
  posit::dispatch_plan(n, radix, red, otf, scaled, nonrest, it, shift, gbits, [&](auto plan) {
    using P = decltype(plan);
    if constexpr (posit::kLibraryPlan<P>) {
      auto kern = hd <= kHdMax ? flash_bwd_dkv_kernel<P, kHdMax>
                               : flash_bwd_dkv_kernel<P, kBwdHdMax>;
      const size_t bytes = sizeof(float) * dkv_smem_floats(hd);
      rc = prepare(kern, bytes);
      if (rc != 0) return;
      const long long heads = static_cast<long long>(B) * KVH;
      const int tiles = (Sk + kKeys - 1) / kKeys;
      if (heads > 0x7FFFFFFFLL || tiles > 65535) {
        rc = -2;
        return;
      }
      const dim3 grid(static_cast<unsigned>(heads), tiles);
      const KV kv = kv_of(k, v, kv_f32);
      const int vec = hd % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(g) % 16 == 0;
      kern<<<grid, kThreads, bytes, s>>>(q, kv.k, kv.v, kv.kf, kv.vf, g, m, l, D, dk, dv, Sq,
                                         Sk, H, KVH, hd, scale, causal, window, q_offset, eps,
                                         vec);
      rc = static_cast<int>(cudaGetLastError());
    }
  });
  return rc;
}
