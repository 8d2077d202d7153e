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
// K7 (simple and correct first): one block per (q tile of kBQ rows,
// b*H + h); a loop over key tiles of kBKq keys accumulates dq += ds k,
// scaled by `scale` at the end.  Each row's divisor is quantized and
// decoded once per q tile into shared memory (as K2 does); the score step
// (tile_p_ds) is inlined once, its loop not unrolled, to keep the build time
// short; s is computed in the forward kernel's order (one f32 FMA chain over
// head_dim, then a separately rounded multiply by scale), so a recomputed e
// is the forward's e.  Its products run on CUDA cores in f32; tensor cores
// are left for a later version.
//
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
//   * head_dim up to kHdMax, zero-padded to a multiple of 8 (the MMA depth);
//     the tiles' row stride hd8 + 4 makes the fragment loads conflict-free.
// The MMA, load and staging code are plain device functions; only the
// divide depends on the plan, to keep the build of the nine plans short.
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

#include "posit_srt.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kHdMax = 128;  // largest head_dim the kernels take
constexpr int kBQ = 16;      // query rows per q tile of K7
constexpr int kBKq = 64;     // keys per key tile of K7

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

// ------------------------------------------------------------------- K8
//
// Tensor-core helpers (mma.sync m16n8k8, TF32 operands, f32 accumulate).
// Fragment layouts (PTX ISA, m16n8k8 .tf32), g = lane / 4, t = lane % 4:
//   A (16 x 8): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
//   B (8 x 8):  b0 (t, g), b1 (t + 4, g);
//   C (16 x 8): c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).
// 3xTF32: each f32 operand x is split into hi = tf32(x) and lo = tf32(x - hi)
// (x - hi is exact), and a b takes hi*hi + hi*lo + lo*hi, about f32's
// accuracy.  K and V staged from bf16 have lo = 0.

constexpr int kKeys = 16;                // keys per K8 block: one m16 row block
constexpr int kRows = 32;                // query rows per K8 q tile
constexpr int kWarps = kThreads / 32;
constexpr int kWarpRows = kRows / kWarps;  // a warp's rows of a tile in the score step
constexpr int kScr = kRows + 8;          // row stride of the (kKeys, kRows) scratch tiles
constexpr int kNtPart = kHdMax / 8 / kWarps;  // n-tiles of a warp's part of dk / dv's columns
constexpr int kDivUnroll = 2;            // pairs a lane divides side by side

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An A fragment and a B fragment, split into their tf32 hi and lo parts.
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2, float a3) {
  FragA f;
  split(a0, f.hi[0], f.lo[0]);
  split(a1, f.hi[1], f.lo[1]);
  split(a2, f.hi[2], f.lo[2]);
  split(a3, f.hi[3], f.lo[3]);
  return f;
}

__device__ __forceinline__ FragB frag_b(float b0, float b1) {
  FragB f;
  split(b0, f.hi[0], f.lo[0]);
  split(b1, f.hi[1], f.lo[1]);
  return f;
}

// d += a b in 3xTF32, the small products first.  The three products sum
// on the tensor core from zero, and that sum is added to d by an f32 add
// (round to nearest): the tensor core's own accumulation truncates, which
// over a long chain of products drifts one way.  A first form that
// accumulated every product on the tensor core was 9.2e-5 from its twin at
// posit64, where the scalar f32 form it replaced was 5.3e-6; this one is
// back at that order (PERF.md section 6).
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, const FragB& b) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(t, a.lo, b.hi);
  mma_tf32(t, a.hi, b.lo);
  mma_tf32(t, a.hi, b.hi);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += t[i];
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// K8's shared memory, in floats: K and V tiles (kKeys rows), two q / dO tile
// buffers (kRows rows), the row vectors m, l, D of both buffers, and two
// (kKeys, kRows) scratch tiles.  Rows have stride hdp = hd8 + 4
// (hd8: head_dim rounded up to 8, the MMA depth), so every fragment load
// below hits 32 distinct banks.
struct DkvSmem {
  float *k, *v, *q, *g, *m, *l, *d, *scratch;
};

__host__ __device__ inline int dkv_hdp(int hd) { return ((hd + 7) & ~7) + 4; }

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
__device__ __forceinline__ void accumulate_dkv(const float* sP, const float* sDS,
                                               const float* sQ, const float* sG, int hdp,
                                               int nd0, int ndn, int lane,
                                               float (&dk)[kNtPart][4],
                                               float (&dv)[kNtPart][4]) {
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
template <class P>
__global__ void __launch_bounds__(kThreads, 4)
    flash_bwd_dkv_kernel(const float* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, const float* __restrict__ kf,
                         const float* __restrict__ vf, const float* __restrict__ g,
                         const float* __restrict__ m, const float* __restrict__ l,
                         const float* __restrict__ D, float* __restrict__ dk,
                         float* __restrict__ dv, int Sq, int Sk, int H, int KVH, int hd,
                         float scale, int causal, int window, int q_offset, float eps,
                         int vec) {
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
    if (!idle) accumulate_dkv(sP, sDS, sQ, sG, hdp, nd0, ndn, lane, acc_k, acc_v);
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
