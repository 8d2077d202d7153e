// K3 / K4 / K5 / K6: flash-attention forward with the posit SRT normalizer,
// over a dense, a paged or a packed kv layout, optionally saving the row
// residuals (m, l).
//
// Replaces _flash_kernel / _flash_call (src/repro/kernels/posit_flash_attn.py
// :96-:357, pallas_call :330) in its three layouts:
//   * dense (pages = 0, has_seg = False): save_res = False reached through
//     posit_flash_attention (K3, the serving path), save_res = True through
//     posit_flash_attention_fwd :424 (K6, the training forward);
//   * paged (pages > 0, :116-121, :145-163, :242-273): K4, the paged decode,
//     k/v read in place from the block pools through the block table;
//   * packed (has_seg, :123-133, :176-181, :285-306): K5, the packed
//     multi-prompt prefill with a block-diagonal segment mask.
// It computes the online-softmax kv scan carrying (m, l, acc), GQA by head
// index, the causal / window / kv_start / kv_len / q_pos masks, and the final
// acc / l through K1 as a rowwise posit divide, minpos for fully masked rows.
//
// Two loops, one launch each; the wrapper picks one by the kind of call
// (kernels/posit_flash_attn.py flash_loop), never by Sq, and passes it as
// `loop`:
//   * the one-row loop (flash_kernel): the decode calls, K3 with q_pos and
//     K4, one query row a block;
//   * the tile loop (flash_tile_kernel): every other call, K3's whole and
//     suffix prefills, K5 and K6, 16-row q tiles.
// A row's result does not depend on the launch that carries it (its tile,
// its place in the tile, the tile's causal limit, the layout), so a
// one-token suffix prefill gives the bits of the same row of the whole
// prompt's prefill and a packed segment the bits of its solo prefill.  Both
// loops anchor their kv tiles at the row's kv_start: tile t covers keys
// [kv_start + t*64, kv_start + (t+1)*64).  A request's real keys then fall
// into the same tiles whatever its left-pad length, so its rows are
// bit-identical solo, batched or admitted mid-flight; masked and past-edge
// keys are exact no-ops (p = 0, corr = exp(0) = 1), and tiles wholly outside
// a block's keys are skipped.
//
// The one-row loop (simple and correct first; K3 decode and K4 beat SDPA
// with it, PERF.md section 6):
//   * one block per (b*H + h, query row): b*H + h on gridDim.x (up to
//     2^31 - 1; gridDim.y stopped it at 65535), the row on gridDim.y, offsets
//     in 64 bits; the KV head is h / G, so K/V are read in place, never
//     repeated;
//   * a loop over kv tiles of kBK keys staged in shared memory as f32 (the
//     bf16 K/V are upcast in registers, exactly), QK^T and PV as f32 FMA;
//     every per-row reduction runs sequentially in key order;
//   * K4 (paged) changes only the tile load: key kp of sequence b is pool
//     row bt[b*max_blocks + kp/bs] (clamped to [0, NB)), offset kp % bs.
//     Each tile's pool rows are looked up once into shared memory; keys
//     outside [kv_start, kv_len) load as 0 (a page row past a sequence's
//     end may hold a previous owner's values).  The tiles, the masks and
//     every sum are K3's, so K4 gives K3 decode's bits on a dense cache that
//     holds the same logical rows; block_size is free of the tile size.
// The layout is a template flag, so the dense instantiation holds none of
// the paged code (its schedule is ptxas-sensitive, PERF.md section 6).
//
// The tile loop carries K7's structure (posit_flash_bwd.cu) over to the
// forward, with its MMA and K/V staging helpers (flash_stage.cuh):
//   * one block of four warps per (q tile of bq rows, b*H + h), bq = 16
//     (K5: min(16, segment width), so no block straddles two segments),
//     the heaviest q tile first under the causal mask;
//   * posit32 and posit64 run both products on the tensor cores (mma.sync
//     m16n8k8 TF32 in 3xTF32, each three-product sum from zero and added
//     in f32, as K7), in 32-key steps, two per twin tile, as K7 steps:
//     warp w computes s = Q K^T for keys [8w, 8w + 8) of the step by K7's
//     score code into a shared (16, 32) tile, and after the softmax step
//     P V for a quarter of the head's columns, as K7 accumulates dq (p as
//     A fragments, the k-step's keys in K7's order), so each acc element
//     is one warp's sum in a fixed order.  Posit8 and posit16 run both as
//     f32 FMAs in the one-row loop's order (the twin's), in 64-key steps
//     (the twin's BLOCK_K, its rescaling): thread (rg, c) sums s = q . k in
//     head-column order for rows rg and rg + 8 and keys c + 16 i (i < 4),
//     and p v over the step's keys in order for four or eight columns, so
//     their outputs (and K6's m, l) are that loop's bits (kTileMma and
//     kStepKeys say why);
//   * the softmax step is the same for both: thread (rg, c) takes the row
//     max of its rows over their half-warp by shuffles, writes p = exp(s -
//     m) into the p tile, and one thread a row sums the step's p in key
//     order; acc = acc * corr + p v with the step's p v summed from zero;
//   * K/V are copied by cp.async as they arrive (bf16 or f32) into a staging
//     buffer and widened to f32 tiles, the next step's copy in flight while
//     a step computes: f32 K/V holding bf16 values give the bf16 call's
//     bits; head_dim up to 128, zero-padded to a multiple of 8 (the padding's
//     FMAs add zeros: exact), rows of stride hd8 + 4;
//   * K5 (packed) takes per-position segment ids seg_q (B, Sq) and seg_kv
//     (B, Sk); each block takes its segment from its rows (query pads
//     carry -2 and attend nothing), anchors its steps at the segment's first
//     key and masks every key of another segment (its V rows zeroed): a
//     segment walks the tiles its solo K3 prefill walks;
//   * the epilogue divides o = acc / l in registers: each thread prepares
//     its two rows' divisors once and divides its elements two side by side
//     through K1's straight casts (float_to_fields, prep_divisor_fields,
//     divide_to_float, the bits of divide_float); K6 stores each row's final
//     m and l, f32, (B*H, Sq).
//
// Instantiated for the plans posit::kModelPlan names (the one-row loop in the
// dense and paged layouts, the tile loop in the dense and packed ones):
// every posit8, posit16, posit32 and posit64 plan; posit32 srt_r4_scaled and
// posit64 run o / l on K1's two-word frame with a 48-byte divisor per row.
// K/V may be bf16 or f32 (the reference upcasts K/V to f32 before its
// kernel), a flag of the call, not of the instantiation: the one-row loop
// branches on it per tile (load_kv), the tile loop stages whatever arrives.
// The source is built once per format (posit64: per part, -DPOSIT_MODEL_N,
// -DPOSIT_MODEL_PART, posit::kLibraryPlan): a library returns -1 for another
// library's plan.
//
// Bound: decode reads the KV cache (or the pages each sequence attends)
// once and is memory-bound; prefill does 4*B*H*Sq*Sk*hd flops of products
// (K5: over the block-diagonal causal pairs), bounded at the TF32 tensor
// cores' rate, and a posit division per output, bounded at the instruction
// rate: the divisions set the bound (chip_smoke.py bound_ms).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <type_traits>

#include "flash_stage.cuh"
#include "posit_srt.cuh"

namespace {

// kThreads, kHdMax and the staging helpers: flash_stage.cuh
constexpr int kBK = 64;        // keys per kv tile of the one-row loop
constexpr int kBQMax = 16;     // query rows per block, at most
constexpr float kNegInf = -1e30f;

enum Layout { kDense = 0, kPaged = 1, kPacked = 2 };
enum Loop { kRowLoop = 0, kTileLoop = 1 };

template <class P>
size_t smem_bytes(int bq, int hd, int layout) {
  // the divisors first (32 bytes each, 48 on the two-word frame: a multiple
  // of their 4- or 8-byte alignment, so the floats after them stay aligned
  // at any bq); the pointers in flash_kernel follow this order exactly
  const size_t bytes = sizeof(posit::DivisorOf<P>) * bq    // per-row divisor
                       + sizeof(float) * (bq * hd + kBK * (hd + 1) + kBK * hd + bq * kBK + 3 * bq)
                       + bq * kBK;                          // mask bytes
  if (layout == kDense) return bytes;
  // paged: a tile's pool rows, after the mask bytes at int alignment
  return (bytes + 3) / 4 * 4 + sizeof(int) * kBK;
}

// Where the paged layout finds its keys.  Sk is the virtual kv length
// (max_blocks * bs).
struct KvIndex {
  const int* bt;      // paged: (B, max_blocks) block table
  int max_blocks, bs, NB;
};

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }

// One kv tile of kBK keys from base into sK (rows padded to hd + 1) and sV,
// as f32 (bf16 upcast exactly); keys outside the sequence and the page
// table's masked rows (sKey -1) load as 0.  The
// kernel calls it for one element type or the other, by a branch that
// every block takes the same way: the bf16 loop is the one the kernel had
// before f32 K/V, so K3 decode kept its time on an H100, where one select
// per element cost it 2% (PERF.md section 6).
template <int kLayout, class T>
__device__ __forceinline__ void load_kv(const T* __restrict__ k, const T* __restrict__ v,
                                        float* sK, float* sV, const int* sKey, int base,
                                        int b, int Sk, int KVH, int kvh, int hd) {
  for (int i = threadIdx.x; i < kBK * hd; i += kThreads) {
    const int j = i / hd, d = i % hd;
    const int kp = base + j;
    bool in;
    size_t off;
    if constexpr (kLayout == kPaged) {
      const int row = sKey[j];
      in = row >= 0;
      off = ((static_cast<size_t>(in ? row : 0)) * KVH + kvh) * hd + d;
    } else {
      in = kp >= 0 && kp < Sk;
      off = ((static_cast<size_t>(b) * Sk + (in ? kp : 0)) * KVH + kvh) * hd + d;
    }
    sK[j * (hd + 1) + d] = in ? to_f32(k[off]) : 0.f;
    sV[i] = in ? to_f32(v[off]) : 0.f;
  }
}

// The one-row loop.  bq is the number of query rows of a block's tile (the
// C entry launches it with 1; a row's result does not depend on it).  K/V
// come as bf16 (k, v) or, where kf is not null, as f32 (kf, vf).
template <class P, int kLayout>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const float* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const float* __restrict__ kf,
                 const float* __restrict__ vf, float* __restrict__ out,
                 float* __restrict__ m_out, float* __restrict__ l_out,
                 const int* __restrict__ kv_start, const int* __restrict__ kv_len,
                 const int* __restrict__ q_pos, int bq, int Sq, int Sk, int H, int KVH,
                 int hd, float scale, int causal, int window, int q_offset, float eps,
                 KvIndex ix) {
  extern __shared__ __align__(16) unsigned char smem[];
  posit::DivisorOf<P>* sDiv = reinterpret_cast<posit::DivisorOf<P>*>(smem);
  float* sQ = reinterpret_cast<float*>(sDiv + bq);
  float* sK = sQ + bq * hd;
  float* sV = sK + kBK * (hd + 1);  // K rows padded: no bank conflicts in QK^T
  float* sS = sV + kBK * hd;
  float* sM = sS + bq * kBK;
  float* sL = sM + bq;
  float* sC = sL + bq;
  unsigned char* sMask = reinterpret_cast<unsigned char*>(sC + bq);
  // paged only (smem_bytes reserves it for that layout): a tile's pool rows
  int* sKey = reinterpret_cast<int*>(
      (reinterpret_cast<uintptr_t>(sMask + bq * kBK) + 3) & ~uintptr_t(3));

  constexpr int kAcc = (kBQMax * kHdMax + kThreads - 1) / kThreads;
  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KVH);
  const int q0 = blockIdx.y * bq;
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
    if constexpr (kLayout == kPaged) {
      // this tile's pool rows (-1: a masked key, loaded as 0 so no stale
      // page row reaches a sum); the previous tile's loads finished before
      // its second barrier
      if (tid < kBK) {
        const int kp = base + tid;
        int row = -1;
        if (kp >= ks && kp < kl) {
          const int blk = ix.bt[static_cast<size_t>(b) * ix.max_blocks + kp / ix.bs];
          row = min(max(blk, 0), ix.NB - 1) * ix.bs + kp % ix.bs;
        }
        sKey[tid] = row;
      }
    }
    __syncthreads();
    if (kf != nullptr) load_kv<kLayout>(kf, vf, sK, sV, sKey, base, b, Sk, KVH, kvh, hd);
    else load_kv<kLayout>(k, v, sK, sV, sKey, base, b, Sk, KVH, kvh, hd);
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

// ------------------------------------------------------------- the tile loop

constexpr int kFRows = 16;                 // query rows of a tile block
constexpr int kFCols = kHdMax / 64;        // a thread's 4-column chunks of acc, at most

// The tile loop's shared memory for steps of `keys` keys: q (kFRows rows),
// the f32 K and V tiles (`keys` rows), rows of stride hdp; the p tile (row
// stride keys + 4); the step's corr and the running l of each row; the
// step's key segment ids and the segment's first key (packed); then the
// staging buffer of the raw K and V rows (keys / kQKeys parts of kQKeys K
// rows and kQKeys V rows of hd elements of raw_elt bytes; none where the
// rows are read straight from the tensors).  Every part is a multiple of
// 16 bytes, so the staging buffer takes 16-byte copies.
__host__ __device__ inline size_t tile_smem_bytes(int hd, int raw_elt, int keys) {
  const int hdp = dkv_hdp(hd);
  return sizeof(float) * (kFRows * hdp + 2 * keys * hdp + kFRows * (keys + 4) + 2 * kFRows) +
         sizeof(int) * (keys + 4) + static_cast<size_t>(2) * keys * hd * raw_elt;
}

// Which products of the tile loop run on the tensor cores: posit32's and
// posit64's.  Posit8 and posit16 keep both in f32 FMAs in the twin's
// order.  Both round acc and l to the format before they divide, so where
// an f32-ulp difference from the twin's sums meets a rounding boundary an
// output moves: at posit16 by 2^-10 of its value at |acc| or l in [16,
// 64), past FLASH_TOL (chip_smoke.py) where |o| >= 0.5, a few times in
// 10^8 outputs at the training shape for sums in another order
// (tools/flash_rounding.py); at posit8 by two steps where acc and l both
// cross, past its one-step gate.  On an H100 a tensor-core tile loop broke
// a K5 gate in each format so (PERF.md section 6).  A posit32 or posit64
// step is 2^-20 of the value or finer, far below FLASH_TOL.
template <class P>
constexpr bool kTileMma = P::n >= 32;

// Keys per step: 64, the twin's BLOCK_K, where the tile loop keeps the
// twin's order (its online-softmax rescaling once per 64-key tile), else
// 32, two steps per twin tile, as K7 steps (PERF.md section 6 has the A/B).
template <class P>
constexpr int kStepKeys = kTileMma<P> ? 32 : 64;

// The warp's unscaled s = Q K^T for keys [kKeys / 4 w, kKeys / 4 (w + 1))
// of the step (C fragments of 8 keys), into the p tile: each 8-key sum in K7's
// order (dq_score_tile in posit_flash_bwd.cu: 3xTF32 over the head's
// columns, 8 at a time), so K7 recomputes the forward's s, bit for bit.  A
// warp whose keys no row of the block attends writes zeros, which the mask
// then replaces.
template <int kKeys>
__device__ __forceinline__ void tile_scores_mma(const float* sQ, const float* sK, float* sP,
                                                int hdp, int warp, int lane, bool idle) {
  constexpr int kNt = kKeys / 32, kPs = kKeys + 4;   // a warp's 8-key n-tiles; p's stride
  const int g = lane / 4, t = lane % 4;
  float s[kNt][4];
#pragma unroll
  for (int n = 0; n < kNt; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
  if (!idle) {
    const float* qr = sQ + g * hdp + t;
    const float* kr = sK + (8 * kNt * warp + g) * hdp + t;
    const int depth = hdp - 4;
#pragma unroll 1
    for (int c = 0; c < depth; c += 8) {
      const FragA qa = frag_a(qr[c], qr[8 * hdp + c], qr[c + 4], qr[8 * hdp + c + 4]);
#pragma unroll
      for (int n = 0; n < kNt; ++n)
        mma3(s[n], qa, frag_b(kr[8 * n * hdp + c], kr[8 * n * hdp + c + 4]));
    }
  }
#pragma unroll
  for (int n = 0; n < kNt; ++n) {
    const int j = 8 * kNt * warp + 8 * n + 2 * t;
    *reinterpret_cast<float2*>(sP + g * kPs + j) = make_float2(s[n][0], s[n][1]);
    *reinterpret_cast<float2*>(sP + (g + 8) * kPs + j) = make_float2(s[n][2], s[n][3]);
  }
}

// pv = P V over the step's kKeys keys for the warp's n-tiles [nd0, nd0 +
// ndn) of the head's columns, as K7 accumulates dq (accumulate_dq): p from
// the p tile as A fragments, each k-step's 8 keys in the order (0, 2, 4, 6,
// 1, 3, 5, 7) (lane (g, t) holds p's (g, 2t), (g + 8, 2t), (g, 2t + 1),
// (g + 8, 2t + 1) and V's key rows 2t and 2t + 1), 3xTF32.
template <int kKeys>
__device__ __forceinline__ void tile_pv_mma(const float* sP, const float* sV, int hdp, int nd0,
                                            int ndn, int lane, float (&pv)[kNtPart][4]) {
  constexpr int kPs = kKeys + 4;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int nd = 0; nd < kNtPart; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) pv[nd][e] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < kKeys; kk += 8) {
    const float2 a0 = *reinterpret_cast<const float2*>(sP + g * kPs + kk + 2 * t);
    const float2 a1 = *reinterpret_cast<const float2*>(sP + (g + 8) * kPs + kk + 2 * t);
    const FragA pa = frag_a(a0.x, a1.x, a0.y, a1.y);
    const float* vr = sV + (kk + 2 * t) * hdp + nd0 * 8 + g;
#pragma unroll
    for (int nd = 0; nd < kNtPart; ++nd)
      if (nd < ndn) mma3(pv[nd], pa, frag_b(vr[nd * 8], vr[hdp + nd * 8]));
  }
}

// The multi-row forward (K3 prefill, K5, K6): one block of four warps per
// (q tile of bq <= kFRows rows, b*H + h), the heaviest q tile first under
// the causal mask (blockIdx.y = 0 is the last tile); see the note at the
// top.  Thread (rg, c) = (tid / 16, tid % 16) holds rows rg and rg + 8 of
// the tile: their scores with keys c + 16 i of a step (i < kKeys / 16), so a
// row's scores live in one half-warp, and in the FMA layout their acc in
// the columns [4 c + 64 i, 4 c + 64 i + 4) (i < kFCols).  chunk: the staging copies' size in
// bytes (16 or 4), or 0 where K/V rows are read straight from the tensors.
// seg_q / seg_kv: K5's segment ids (packed layout only).
template <class P, int kLayout>
__global__ void __launch_bounds__(kThreads, P::words == 1 ? 4 : 3)
    flash_tile_kernel(const float* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const float* __restrict__ kf,
                      const float* __restrict__ vf, float* __restrict__ out,
                      float* __restrict__ m_out, float* __restrict__ l_out,
                      const int* __restrict__ kv_start, const int* __restrict__ kv_len,
                      const int* __restrict__ q_pos, const int* __restrict__ seg_q,
                      const int* __restrict__ seg_kv, int bq, int Sq, int Sk, int H, int KVH,
                      int hd, float scale, int causal, int window, int q_offset, float eps,
                      int chunk) {
  constexpr int kKeys = kStepKeys<P>;     // keys per step
  constexpr int kParts = kKeys / kQKeys;  // staging calls per step
  constexpr int kPs = kKeys + 4;          // row stride of the (kFRows, kKeys) p tile
  constexpr int kSi = kKeys / 16;         // a thread's keys of a step in the FMA layout
  extern __shared__ __align__(16) unsigned char smem[];
  const int hdp = dkv_hdp(hd), hd8 = hdp - 4;
  float* sQ = reinterpret_cast<float*>(smem);
  float* sK = sQ + kFRows * hdp;
  float* sV = sK + kKeys * hdp;
  float* sP = sV + kKeys * hdp;
  float* sC = sP + kFRows * kPs;   // each row's corr of the step
  float* sL = sC + kFRows;         // each row's l
  int* sSeg = reinterpret_cast<int*>(sL + kFRows);  // [kKeys]: the segment's first key
  unsigned char* raw = chunk ? reinterpret_cast<unsigned char*>(sSeg + kKeys + 4) : nullptr;
  const int elt = kf != nullptr ? 4 : 2;
  const unsigned char* kraw = kf != nullptr ? reinterpret_cast<const unsigned char*>(kf)
                                            : reinterpret_cast<const unsigned char*>(k);
  const unsigned char* vraw = kf != nullptr ? reinterpret_cast<const unsigned char*>(vf)
                                            : reinterpret_cast<const unsigned char*>(v);
  const int part = 2 * kQKeys * hd * elt;   // bytes of one staging part
  const int tid = threadIdx.x, rg = tid / 16, c = tid % 16;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  // the MMA layout's P V: warp w takes the n-tiles [nd0, nd0 + ndn) of the
  // head's columns
  const int nts = hd8 / 8;
  const int nd0 = warp * nts / kWarps, ndn = (warp + 1) * nts / kWarps - nd0;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int kvh = h / (H / KVH);
  // under the causal mask the last q tile attends the most keys: it goes
  // first, so the last blocks to start are the lightest
  const int nq = (Sq + bq - 1) / bq;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.y)) * bq;
  const int rows = min(bq, Sq - q0);
  int ks = max(kv_start[b], 0);   // the steps' anchor (no key precedes key 0)
  const int kl = min(kv_len[b], Sk);
  const int qp0 = q_pos[b] + q_offset + q0;
  // rows rg and rg + 8: their positions, and whether they are rows of the
  // block (of its segment)
  int qp[2], seg = 0;
  bool rin[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qp[i] = qp0 + rg + 8 * i;
    rin[i] = rg + 8 * i < rows;
  }
  if constexpr (kLayout == kPacked) {
    // the block's rows hold one segment id (or -2: query pads); its steps
    // are anchored at the segment's first key
    const size_t row0 = static_cast<size_t>(b) * Sq + q0;
    seg = -2;
    for (int r = 0; r < rows; ++r) seg = max(seg, seg_q[row0 + r]);
#pragma unroll
    for (int i = 0; i < 2; ++i) rin[i] = rin[i] && seg_q[row0 + rg + 8 * i] == seg && seg >= 0;
    if (tid == 0) sSeg[kKeys] = Sk;
    __syncthreads();
    if (seg >= 0) {
      for (int kp = tid; kp < Sk; kp += kThreads) {
        if (seg_kv[static_cast<size_t>(b) * Sk + kp] == seg) {
          atomicMin(&sSeg[kKeys], kp);
          break;
        }
      }
    }
    __syncthreads();
    ks = sSeg[kKeys];   // Sk (no steps) when the block holds only pads
  }
  // the keys some row of the tile attends, [k_lo, k_hi): steps wholly
  // outside are exact no-ops for every row (p = 0, corr = 1), not visited
  int k_hi = kl;
  if (causal) k_hi = min(k_hi, qp0 + rows);   // the last row's position + 1
  int k_lo = ks;
  if (window) k_lo = max(k_lo, qp0 - window + 1);   // the first row's first key
  const int t0 = (k_lo - ks) / kKeys;
  const int t1 = k_hi > k_lo ? (k_hi - ks + kKeys - 1) / kKeys : t0;
  auto copy = [&](int st) {   // starts the copies of step st's K/V rows
#pragma unroll
    for (int p = 0; p < kParts; ++p)
      start_kv_copy(kraw, vraw, raw + p * part, raw + p * part + part / 2, b, kvh,
                    ks + st * kKeys + p * kQKeys, Sk, KVH, hd, elt, chunk);
  };
  if (raw != nullptr && t0 < t1) copy(t0);

  // the tile's q rows (zeros past `rows` and in the columns [hd, hd8))
  for (int i = tid; i < kFRows * hd8; i += kThreads) {
    const int r = i / hd8, d = i % hd8;
    const bool in = r < rows && d < hd;
    const size_t off = ((static_cast<size_t>(b) * Sq + q0 + (in ? r : 0)) * H + h) * hd +
                       (in ? d : 0);
    sQ[r * hdp + d] = in ? q[off] : 0.f;
  }
  if (tid < kFRows) sL[tid] = 0.f;
  // acc: in the FMA layout acc[r kFCols + i] holds row rg + 8 r's columns
  // [4 c + 64 i, 4 c + 64 i + 4); in the MMA layout acc[nd] is n-tile nd0 +
  // nd's C fragment (rows g, g + 8)
  static_assert(2 * kFCols == kNtPart, "both layouts hold 16 acc elements a thread");
  float acc[kNtPart][4];
#pragma unroll
  for (int i = 0; i < kNtPart; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};

  for (int st = t0; st < t1; ++st) {
    const int base = ks + st * kKeys;
    cp_async_wait_all();
    __syncthreads();   // the step's rows have landed; every thread is done with the last step
#pragma unroll
    for (int p = 0; p < kParts; ++p)
      widen_kv(raw != nullptr ? raw + p * part : nullptr, k, v, kf, vf, sK + p * kQKeys * hdp,
               sV + p * kQKeys * hdp, b, kvh, base + p * kQKeys, Sk, KVH, hd, hdp);
    if constexpr (kLayout == kPacked) {
      if (tid < kKeys) {
        const int kp = base + tid;
        sSeg[tid] = kp < Sk ? seg_kv[static_cast<size_t>(b) * Sk + kp] : -1;
      }
    }
    __syncthreads();
    if (raw != nullptr && st + 1 < t1) copy(st + 1);
    if constexpr (kLayout == kPacked) {
      // another segment's keys are masked; their V rows are zeroed, so that
      // p v is an exact no-op there whatever they hold (a K row only meets
      // masked scores)
      for (int i = tid; i < kKeys * hd8; i += kThreads)
        if (sSeg[i / hd8] != seg) sV[i / hd8 * hdp + i % hd8] = 0.f;
      __syncthreads();
    }
    // s = q . k: on the tensor cores through the p tile, or over the head's
    // columns in order, one f32 FMA each (the one-row loop's and the twin's
    // order); then * scale, masked as the reference does
    float s[2][kSi];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int i = 0; i < kSi; ++i) s[r][i] = 0.f;
    if constexpr (kTileMma<P>) {
      const int kw = base + kKeys / 4 * warp;   // the warp's first key
      tile_scores_mma<kKeys>(sQ, sK, sP, hdp, warp, lane, kw >= k_hi || kw + kKeys / 4 <= k_lo);
      __syncthreads();
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int i = 0; i < kSi; ++i) s[r][i] = sP[(rg + 8 * r) * kPs + c + 16 * i];
    } else {
    const float* q0r = sQ + rg * hdp;
    const float* q1r = q0r + 8 * hdp;
#pragma unroll 2
    for (int d = 0; d < hd8; d += 4) {
      const float4 a0 = *reinterpret_cast<const float4*>(q0r + d);
      const float4 a1 = *reinterpret_cast<const float4*>(q1r + d);
#pragma unroll
      for (int i = 0; i < kSi; ++i) {
        const float4 kx = *reinterpret_cast<const float4*>(sK + (c + 16 * i) * hdp + d);
        s[0][i] = fmaf(a0.x, kx.x, s[0][i]);
        s[0][i] = fmaf(a0.y, kx.y, s[0][i]);
        s[0][i] = fmaf(a0.z, kx.z, s[0][i]);
        s[0][i] = fmaf(a0.w, kx.w, s[0][i]);
        s[1][i] = fmaf(a1.x, kx.x, s[1][i]);
        s[1][i] = fmaf(a1.y, kx.y, s[1][i]);
        s[1][i] = fmaf(a1.z, kx.z, s[1][i]);
        s[1][i] = fmaf(a1.w, kx.w, s[1][i]);
      }
    }
    }
    unsigned valid = 0;   // bit 4 r + i: the pair of s[r][i]
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int i = 0; i < kSi; ++i) {
        const int kp = base + c + 16 * i;
        bool ok = rin[r] && kp < kl;
        if (causal) ok = ok && qp[r] >= kp;
        if (window) ok = ok && qp[r] - kp < window;
        if constexpr (kLayout == kPacked) ok = ok && sSeg[c + 16 * i] == seg;
        valid |= static_cast<unsigned>(ok) << (4 * r + i);
        s[r][i] = ok ? __fmul_rn(s[r][i], scale) : kNegInf;
      }
    }
    // each row's max over the step (its half-warp's), p = exp(s - m) into
    // the p tile (masked pairs exactly 0), corr = exp(m_old - m)
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = s[r][0];
#pragma unroll
      for (int i = 1; i < kSi; ++i) mx = fmaxf(mx, s[r][i]);
#pragma unroll
      for (int o = 1; o < 16; o *= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_run[r], mx);
#pragma unroll
      for (int i = 0; i < kSi; ++i)
        sP[(rg + 8 * r) * kPs + c + 16 * i] =
            valid >> (4 * r + i) & 1u ? expf(s[r][i] - m_new) : 0.f;
      corr[r] = expf(m_run[r] - m_new);
      m_run[r] = m_new;
      if (c == 0) sC[rg + 8 * r] = corr[r];
    }
    __syncthreads();   // the p tile and every row's corr are in
    // l = l * corr + the step's p summed in key order, one thread a row
    // (threads 0-3 of each warp), as the one-row loop sums it
    if (tid % 32 < 4) {
      const int r = tid / 32 * 4 + tid % 32;
      const float* pr = sP + r * kPs;
      float sum = 0.f;
#pragma unroll 4
      for (int j = 0; j < kKeys; j += 4) {
        const float4 p4 = *reinterpret_cast<const float4*>(pr + j);
        sum += p4.x;
        sum += p4.y;
        sum += p4.z;
        sum += p4.w;
      }
      sL[r] = fmaf(sL[r], sC[r], sum);
    }
    // acc = acc * corr + p v, the step's p v summed from zero: on the tensor
    // cores, or over its keys in order, one f32 FMA each (the one-row loop's
    // order)
    float pv[kNtPart][4];
    if constexpr (kTileMma<P>) {
      tile_pv_mma<kKeys>(sP, sV, hdp, nd0, ndn, lane, pv);
      const float cg[2] = {sC[g], sC[g + 8]};
#pragma unroll
      for (int nd = 0; nd < kNtPart; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nd][e] = fmaf(acc[nd][e], cg[e / 2], pv[nd][e]);
    } else {
#pragma unroll
    for (int i = 0; i < kNtPart; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[i][e] = 0.f;
    const float* p0r = sP + rg * kPs;
    const float* p1r = p0r + 8 * kPs;
#pragma unroll 2
    for (int j = 0; j < kKeys; j += 4) {
      const float4 p0 = *reinterpret_cast<const float4*>(p0r + j);
      const float4 p1 = *reinterpret_cast<const float4*>(p1r + j);
      const float pa[2][4] = {{p0.x, p0.y, p0.z, p0.w}, {p1.x, p1.y, p1.z, p1.w}};
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int i = 0; i < kFCols; ++i) {
          const int col = 4 * c + 64 * i;
          if (col < hd8) {
            const float4 vx = *reinterpret_cast<const float4*>(sV + (j + jj) * hdp + col);
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              float* o = pv[r * kFCols + i];
              o[0] = fmaf(pa[r][jj], vx.x, o[0]);
              o[1] = fmaf(pa[r][jj], vx.y, o[1]);
              o[2] = fmaf(pa[r][jj], vx.z, o[2]);
              o[3] = fmaf(pa[r][jj], vx.w, o[3]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int i = 0; i < kFCols; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[r * kFCols + i][e] = fmaf(acc[r * kFCols + i][e], corr[r], pv[r * kFCols + i][e]);
    }
  }

  // epilogue: o = acc / l through K1 in registers, each row's divisor
  // prepared once from its fields (a fully masked row has l == 0 and
  // divides 0 by minpos instead); a thread divides its elements two side by
  // side, the pairs rotating through pr[0] so that the loop, and the divide
  // inlined in it, is not unrolled.  The thread's rows: rg and rg + 8 in the
  // FMA layout, g and g + 8 in the MMA one.
  __syncthreads();   // every row's l is in
  const int er = kTileMma<P> ? g : rg;
  float l_row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) l_row[r] = sL[er + 8 * r];
  const posit::DivisorOf<P> div0 =
      posit::prep_divisor_fields<P>(posit::float_to_fields<P::n>(l_row[0] > 0.f ? l_row[0] : eps));
  const posit::DivisorOf<P> div1 =
      posit::prep_divisor_fields<P>(posit::float_to_fields<P::n>(l_row[1] > 0.f ? l_row[1] : eps));
  constexpr int kPairs = 2 * kNtPart;   // (row, column pair) pairs of a thread
  float2 pr[kPairs];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int i = 0; i < kNtPart; ++i) {
      if constexpr (kTileMma<P>)
        pr[r * kNtPart + i] = make_float2(acc[i][2 * r], acc[i][2 * r + 1]);
      else
        pr[r * kNtPart + i] = make_float2(acc[r * kFCols + i / 2][i % 2 * 2],
                                          acc[r * kFCols + i / 2][i % 2 * 2 + 1]);
    }
#pragma unroll 1
  for (int n = 0; n < kPairs; ++n) {
    const int r = n / kNtPart, i = n % kNtPart;
    const int d = kTileMma<P> ? (nd0 + i) * 8 + 2 * t : 4 * c + 64 * (i / 2) + 2 * (i % 2);
    const bool mine = !kTileMma<P> || i < ndn;
    if (mine && er + 8 * r < rows && d < hd) {
      const posit::DivisorOf<P> dl = r ? div1 : div0;
      const float oa = posit::divide_to_float<P>(posit::float_to_fields<P::n>(pr[0].x), dl);
      const float ob = posit::divide_to_float<P>(posit::float_to_fields<P::n>(pr[0].y), dl);
      const size_t off = ((static_cast<size_t>(b) * Sq + q0 + er + 8 * r) * H + h) * hd + d;
      out[off] = oa;
      if (d + 1 < hd) out[off + 1] = ob;
    }
#pragma unroll
    for (int j = 0; j + 1 < kPairs; ++j) pr[j] = pr[j + 1];
  }
  // K6: each row's final m and l (thread (rg, 0) of each row's half-warp)
  if (m_out != nullptr && c == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rg + 8 * r < rows) {
        const size_t row = static_cast<size_t>(bh) * Sq + q0 + rg + 8 * r;
        m_out[row] = m_run[r];
        l_out[row] = sL[rg + 8 * r];
      }
    }
  }
}

// ------------------------------------------------------------------ launches

// The arguments every launch takes, as the C entry received them.
struct Call {
  const float* q;
  const void *k, *v;
  int kv_f32;
  float *out, *m_out, *l_out;
  const int *kv_start, *kv_len, *q_pos;
  int B, Sq, Sk, H, KVH, hd;
  float scale;
  int causal, window, q_offset;
  float eps;
  int bq;
  KvIndex ix;
  const int *seg_q, *seg_kv;
  cudaStream_t stream;
};

// One launch of the one-row loop (flash_kernel) or, kTile, the tile loop
// (flash_tile_kernel).
template <class P, int kLayout, bool kTile>
int launch(const Call& c) {
  const long long heads = static_cast<long long>(c.B) * c.H;
  const int q_tiles = (c.Sq + c.bq - 1) / c.bq;
  if (heads > 0x7FFFFFFFLL || q_tiles > 65535) return -2;
  const dim3 grid(static_cast<unsigned>(heads), q_tiles);
  const auto* kb = static_cast<const __nv_bfloat16*>(c.kv_f32 ? nullptr : c.k);
  const auto* vb = static_cast<const __nv_bfloat16*>(c.kv_f32 ? nullptr : c.v);
  const auto* kf = static_cast<const float*>(c.kv_f32 ? c.k : nullptr);
  const auto* vf = static_cast<const float*>(c.kv_f32 ? c.v : nullptr);
  auto prepare = [](auto kern, size_t bytes) {
    return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(bytes));
  };
  if constexpr (kTile) {
    // K/V rows staged by cp.async where each row's bytes (and the bases)
    // take 16- or 4-byte copies, else read straight from the tensors
    const int elt = c.kv_f32 ? 4 : 2;
    const int chunk = kv_chunk(c.k, c.v, c.hd, elt);
    const size_t bytes = tile_smem_bytes(c.hd, chunk ? elt : 0, kStepKeys<P>);
    const cudaError_t err = prepare(flash_tile_kernel<P, kLayout>, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_tile_kernel<P, kLayout><<<grid, kThreads, bytes, c.stream>>>(
        c.q, kb, vb, kf, vf, c.out, c.m_out, c.l_out, c.kv_start, c.kv_len, c.q_pos, c.seg_q,
        c.seg_kv, c.bq, c.Sq, c.Sk, c.H, c.KVH, c.hd, c.scale, c.causal, c.window, c.q_offset,
        c.eps, chunk);
  } else {
    const size_t bytes = smem_bytes<P>(c.bq, c.hd, kLayout);
    const cudaError_t err = prepare(flash_kernel<P, kLayout>, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_kernel<P, kLayout><<<grid, kThreads, bytes, c.stream>>>(
        c.q, kb, vb, kf, vf, c.out, c.m_out, c.l_out, c.kv_start, c.kv_len, c.q_pos, c.bq,
        c.Sq, c.Sk, c.H, c.KVH, c.hd, c.scale, c.causal, c.window, c.q_offset, c.eps, c.ix);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int kLayout, bool kTile>
int dispatch(int n, int radix, int red, int otf, int scaled, int nonrest, int it, int shift,
             int gbits, const Call& c) {
  if (c.hd > kHdMax || c.hd <= 0 || c.KVH <= 0 || c.H % c.KVH || c.bq < 1 || c.bq > kBQMax)
    return -2;
  if (c.B <= 0 || c.Sq <= 0) return 0;
  int rc = -1;
  posit::dispatch_plan(n, radix, red, otf, scaled, nonrest, it, shift, gbits, [&](auto plan) {
    using P = decltype(plan);
    if constexpr (posit::kLibraryPlan<P>) {
      rc = launch<P, kLayout, kTile>(c);
    }
  });
  return rc;
}

}  // namespace

// One launch of the flash forward.  loop 0 (the one-row loop: the decode
// calls, K3 with q_pos and K4) takes layout 0 (dense) or 1 (paged: K4);
// loop 1 (the tile loop: K3 prefill, K5, K6) takes layout 0 (dense: K3, or
// K6 with m_out / l_out) or 2 (packed: K5).  The caller routes
// (kernels/posit_flash_attn.py flash_loop).
// q: (B, Sq, H, hd) f32; out: (B, Sq, H, hd) f32; m_out / l_out: (B*H, Sq)
// f32, or both null (no residuals; null for K4 and K5); kv_start / kv_len /
// q_pos: (B,) int32; all contiguous on the device.  k and v are bf16, or f32
// where kv_f32 is not 0:
//   * dense and packed: k, v (B, Sk, KVH, hd);
//   * paged: k, v are block pools (NB, bs, KVH, hd) and block_tables
//     (B, max_blocks) int32 maps logical row r of sequence b to pool row
//     (block_tables[b, r / bs], r % bs); Sk is ignored, the virtual kv length
//     is max_blocks * bs;
//   * packed: seg_q (B, Sq) and seg_kv (B, Sk) int32 segment ids (query pads
//     -2, key pads -1) and bq query rows per block, chosen by the caller so
//     that no block straddles two segments; each segment's first key takes
//     the place of kv_start.  The other layouts ignore bq (the one-row loop
//     takes one-row blocks, the dense tile loop kFRows rows).
// Returns 0, a cudaError_t, -1 when no instantiation matches the plan and
// layout, -2 for a head_dim above kHdMax, a bad head split, a layout the
// loop does not take, B*H past 2^31 - 1 or more than 65535 q tiles.
extern "C" int posit_flash_attn(int n, int radix, int red, int otf, int scaled, int nonrest,
                                int it, int shift, int gbits, int layout, int loop, int kv_f32,
                                const float* q, const void* k, const void* v, float* out,
                                float* m_out, float* l_out, const int* kv_start,
                                const int* kv_len, const int* q_pos, const int* block_tables,
                                const int* seg_q, const int* seg_kv, int B, int Sq, int Sk,
                                int H, int KVH, int hd, int NB, int bs, int max_blocks,
                                float scale, int causal, int window, int q_offset, float eps,
                                int bq, void* stream) {
  if (layout == kPaged) {
    if (NB <= 0 || bs <= 0 || max_blocks <= 0) return -2;
    Sk = max_blocks * bs;
  }
  if (loop == kRowLoop) bq = 1;
  else if (layout != kPacked) bq = kFRows;
  Call c{};
  c.q = q, c.k = k, c.v = v, c.kv_f32 = kv_f32, c.out = out, c.m_out = m_out, c.l_out = l_out;
  c.kv_start = kv_start, c.kv_len = kv_len, c.q_pos = q_pos;
  c.B = B, c.Sq = Sq, c.Sk = Sk, c.H = H, c.KVH = KVH, c.hd = hd;
  c.scale = scale, c.causal = causal, c.window = window, c.q_offset = q_offset, c.eps = eps;
  c.bq = bq, c.ix = KvIndex{block_tables, max_blocks, bs, NB}, c.seg_q = seg_q, c.seg_kv = seg_kv;
  c.stream = static_cast<cudaStream_t>(stream);
  auto run = [&](auto layout_tag, auto tile_tag) {
    return dispatch<decltype(layout_tag)::value, decltype(tile_tag)::value>(
        n, radix, red, otf, scaled, nonrest, it, shift, gbits, c);
  };
  using std::integral_constant;
  using Rows = integral_constant<bool, false>;
  using Tiles = integral_constant<bool, true>;
  if (loop == kRowLoop && layout == kDense) return run(integral_constant<int, kDense>{}, Rows{});
  if (loop == kRowLoop && layout == kPaged) return run(integral_constant<int, kPaged>{}, Rows{});
  if (loop == kTileLoop && layout == kDense) return run(integral_constant<int, kDense>{}, Tiles{});
  if (loop == kTileLoop && layout == kPacked)
    return run(integral_constant<int, kPacked>{}, Tiles{});
  return -2;
}
