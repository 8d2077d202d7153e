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
//   * the decode loop (flash_decode_kernel): the decode calls, K3 with
//     q_pos and K4, one query row a block;
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
// The decode loop (flash_decode_kernel; K3 decode and K4):
//   * one block of kDecWarps warps per (b*H + h, query row): b*H + h on
//     gridDim.x (up to 2^31 - 1), the row on gridDim.y, offsets in 64 bits;
//     the KV head is h / G, so K/V are read in place, never repeated;
//   * the row's kv tiles go in chunks of kDecWarps tiles, one tile a warp.
//     A tile's K and V rows are copied as they arrive (bf16 or f32) by
//     cp.async into the warp's buffers, 16-byte copies where the rows and
//     bases allow, the next chunk's copies in flight while a chunk computes;
//   * the parent loop's sums are sequential over the tiles only through the
//     running max m, and max is exact in any order.  So each warp takes its
//     tile's scores (q . k over the head's columns in order, one f32 FMA
//     each, then * scale) and their max; the block forms each tile's prefix
//     max m_t; each warp then takes p = exp(s - m_t), the tile's p summed in
//     key order from zero (one lane) and its p v summed over the keys in
//     order from zero (the lanes across the head's columns); and the block
//     combines the tiles in order, l = fma(l, corr_t, sum_t) and acc =
//     fma(acc, corr_t, pv_t) with corr_t = exp(m_{t-1} - m_t).  Those are
//     the operations of the one-tile-at-a-time scan on the same values in
//     the same order: the same bits in every format;
//   * K4 (paged) changes only the copies: key kp of sequence b is pool
//     row bt[b*max_blocks + kp/bs] (clamped to [0, NB)), offset kp % bs,
//     looked up once a key; keys outside [kv_start, kv_len) load as 0 (a
//     page row past a sequence's end may hold a previous owner's values).
//     The tiles, the masks and every sum are K3's, so K4 gives K3 decode's
//     bits on a dense cache that holds the same logical rows; block_size
//     is free of the tile size;
//   * the epilogue divides o = acc / l in registers, a column a thread,
//     through K1's straight casts (float_to_fields, prep_divisor_fields,
//     divide_to_float: the bits of divide_float).
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
//     f32 FMAs in the decode loop's order (the twin's), in 64-key steps
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
// Instantiated for the plans posit::kModelPlan names (the decode loop in the
// dense and paged layouts, the tile loop in the dense and packed ones):
// every posit8, posit16, posit32 and posit64 plan; posit32 srt_r4_scaled and
// posit64 run o / l on K1's two-word frame with a 48-byte divisor per row.
// K/V may be bf16 or f32 (the reference upcasts K/V to f32 before its
// kernel), a flag of the call, not of the instantiation: both loops stage
// whatever arrives, the decode loop's scores and P V read it by its type.
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
constexpr int kBK = 64;        // keys per kv tile (the twin's BLOCK_K)
constexpr float kNegInf = -1e30f;

enum Layout { kDense = 0, kPaged = 1, kPacked = 2 };
enum Loop { kRowLoop = 0, kTileLoop = 1 };

// Where the paged layout finds its keys.  Sk is the virtual kv length
// (max_blocks * bs).
struct KvIndex {
  const int* bt;      // paged: (B, max_blocks) block table
  int max_blocks, bs, NB;
};

// ----------------------------------------------------------- the decode loop

constexpr int kDecWarps = 4;                 // a chunk's tiles, one a warp
constexpr int kDecThreads = 32 * kDecWarps;

// A staged K or V row's stride in bytes: an odd number of 16-byte vectors,
// at least one more than the row needs, so that eight lanes' 16-byte loads
// of eight rows hit 32 banks, and a lane's loads past the row's end (zeros
// in K, so the score loop reads whole vectors) stay inside its row.
__host__ __device__ inline int dec_row_stride(int hd, int elt) {
  return 16 * (((hd * elt + 15) / 16 + 1) | 1);
}

// The decode loop's shared memory: q (kHdMax floats, zeros past hd); each
// tile's max, corr and sum of p (kDecWarps floats each, and a spare row);
// each warp's p tile (kBK floats) and p v (kHdMax floats); each warp's
// pool rows (kBK ints, paged); then each warp's K rows and, unless they
// share K's buffer (kv_shared), its V rows: kBK rows of dec_row_stride
// bytes each.  Every part is a multiple of 16 bytes.
constexpr int kDecFixed = sizeof(float) * (kHdMax + 4 * kDecWarps + kDecWarps * (kBK + kHdMax)) +
                          sizeof(int) * kDecWarps * kBK;

__host__ __device__ inline size_t dec_smem_bytes(int hd, int elt, bool kv_shared) {
  return kDecFixed + static_cast<size_t>(kv_shared ? 1 : 2) * kDecWarps * kBK *
                         dec_row_stride(hd, elt);
}
constexpr size_t kDecSmemMax = 232448;   // an H100 block's dynamic shared memory, at most

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// A lane's share of a tile's copies.  A row is per = row_bytes / chunk
// copies; where per <= 32 the warp takes kpi = 32 / per rows at a time and
// lane l makes copy c0 = l % per of rows j0 + kpi i (j0 = l / per; lanes
// past kpi * per idle), else lane l makes copies l, l + 32, ... of every
// row.  chunk 0: plain loads and stores, two bytes at a time.
struct DecCopy {
  int row_bytes, rs, chunk, kpi, j0, c0;
  bool active;
};

// The rows of keys [base, base + kBK) of one of K or V (src, raw bytes of
// rows of row_bytes) into dst (rows of stride rs): by cp.async where
// cc.chunk is 16 or 4 (the caller commits the group), else by plain loads
// and stores.  Out-of-range keys (dense: outside [0, Sk); paged: keyrow
// -1) load as 0.
template <int kLayout>
__device__ __forceinline__ void dec_stage(const unsigned char* __restrict__ src,
                                          unsigned char* dst, const int* keyrow,
                                          const DecCopy& cc, int base, int b, int Sk, int KVH,
                                          int kvh, int lane) {
  auto row_of = [&](int j, bool& in) {
    size_t r;
    if constexpr (kLayout == kPaged) {
      const int pr = keyrow[j];
      in = pr >= 0;
      r = static_cast<size_t>(in ? pr : 0);
    } else {
      const int kp = base + j;
      in = kp >= 0 && kp < Sk;
      r = static_cast<size_t>(b) * Sk + (in ? kp : 0);
    }
    return src + (r * KVH + kvh) * cc.row_bytes;
  };
  if (cc.chunk == 0) {
    const int elt_words = cc.row_bytes / 2;   // 2-byte words of a row
    for (int j = 0; j < kBK; ++j) {
      bool in;
      const auto* s = reinterpret_cast<const uint16_t*>(row_of(j, in));
      auto* d = reinterpret_cast<uint16_t*>(dst + j * cc.rs);
      for (int e = lane; e < elt_words; e += 32) d[e] = in ? s[e] : 0;
    }
    return;
  }
  if (!cc.active) return;
  for (int j = cc.j0; j < kBK; j += cc.kpi) {
    bool in;
    const unsigned char* s = row_of(j, in);
    unsigned char* d = dst + j * cc.rs;
    for (int c = cc.c0 * cc.chunk; c < cc.row_bytes; c += 32 * cc.chunk) {
      if (cc.chunk == 16) cp_async16(d + c, s + c, in);
      else cp_async4(d + c, s + c, in);
    }
  }
}

// The pool rows of keys [base, base + kBK) into keyrow (-1: a key outside
// [ks, kl), loaded as 0 so that no stale page row reaches a sum).
__device__ __forceinline__ void dec_lookup(int* keyrow, const KvIndex& ix, int base, int b,
                                           int ks, int kl, int lane) {
  for (int j = lane; j < kBK; j += 32) {
    const int kp = base + j;
    int row = -1;
    if (kp >= ks && kp < kl) {
      const int blk = ix.bt[static_cast<size_t>(b) * ix.max_blocks + kp / ix.bs];
      row = min(max(blk, 0), ix.NB - 1) * ix.bs + kp % ix.bs;
    }
    keyrow[j] = row;
  }
}

// A 16-byte vector of K as f32: eight bf16 (upcast exactly) or four f32.
template <class T>
__device__ __forceinline__ void dec_unpack(const uint4& w, float* x) {
  if constexpr (std::is_same<T, float>::value) {
    x[0] = __uint_as_float(w.x), x[1] = __uint_as_float(w.y);
    x[2] = __uint_as_float(w.z), x[3] = __uint_as_float(w.w);
  } else {
    const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(u[i] << 16);
      x[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
}

// The unscaled scores of keys lane and lane + 32 of the warp's K rows kb:
// q . k over the head's columns in order, one f32 FMA each, from zero (q
// and the rows' tails are zero past hd, so the padding's FMAs add zeros).
template <class T>
__device__ __forceinline__ void dec_scores(const float* sQ, const unsigned char* kb, int rs,
                                           int hd, int lane, float& s0, float& s1) {
  constexpr int kE = 16 / sizeof(T);    // elements of a 16-byte vector
  const int nvec = (hd * static_cast<int>(sizeof(T)) + 15) / 16;
  const unsigned char* k0 = kb + lane * rs;
  const unsigned char* k1 = k0 + 32 * rs;
  s0 = 0.f;
  s1 = 0.f;
#pragma unroll 2
  for (int i = 0; i < nvec; ++i) {
    float a[kE], c[kE];
    dec_unpack<T>(*reinterpret_cast<const uint4*>(k0 + 16 * i), a);
    dec_unpack<T>(*reinterpret_cast<const uint4*>(k1 + 16 * i), c);
#pragma unroll
    for (int e = 0; e < kE; e += 4) {
      const float4 q4 = *reinterpret_cast<const float4*>(sQ + kE * i + e);
      const float qv[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        s0 = fmaf(qv[f], a[e + f], s0);
        s1 = fmaf(qv[f], c[e + f], s1);
      }
    }
  }
}

// kC columns of a V row as f32, from the row's bytes at column d0.
template <class T, int kC>
__device__ __forceinline__ void dec_cols(const unsigned char* row, int d0, float (&x)[kC]) {
  const T* r = reinterpret_cast<const T*>(row) + d0;
  if constexpr (std::is_same<T, float>::value && kC == 4) {
    const float4 v = *reinterpret_cast<const float4*>(r);
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  } else if constexpr (std::is_same<T, float>::value && kC == 2) {
    const float2 v = *reinterpret_cast<const float2*>(r);
    x[0] = v.x, x[1] = v.y;
  } else if constexpr (!std::is_same<T, float>::value && kC == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(r);
    x[0] = __uint_as_float(v.x << 16), x[1] = __uint_as_float(v.x & 0xffff0000u);
    x[2] = __uint_as_float(v.y << 16), x[3] = __uint_as_float(v.y & 0xffff0000u);
  } else if constexpr (!std::is_same<T, float>::value && kC == 2) {
    const unsigned v = *reinterpret_cast<const unsigned*>(r);
    x[0] = __uint_as_float(v << 16), x[1] = __uint_as_float(v & 0xffff0000u);
  } else {
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      if constexpr (std::is_same<T, float>::value) x[c] = r[c];
      else x[c] = __uint_as_float(static_cast<unsigned>(reinterpret_cast<const uint16_t*>(r)[c]) << 16);
    }
  }
}

// The tile's p v into pv: the lane's kC columns [kC lane, kC lane + kC),
// each summed over the tile's keys in order from zero, one f32 FMA each.
template <class T, int kC>
__device__ __forceinline__ void dec_pv(const float* sPw, const unsigned char* vb, int rs, int hd,
                                       int lane, float* pv) {
  const int d0 = kC * lane;
  if (d0 >= hd) return;
  float o[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) o[c] = 0.f;
#pragma unroll 2
  for (int j = 0; j < kBK; j += 4) {
    const float4 p4 = *reinterpret_cast<const float4*>(sPw + j);
    const float pj[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      float x[kC];
      dec_cols<T, kC>(vb + (j + jj) * rs, d0, x);
#pragma unroll
      for (int c = 0; c < kC; ++c) o[c] = fmaf(pj[jj], x[c], o[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < kC; ++c)
    if (d0 + c < hd) pv[d0 + c] = o[c];
}

template <class T>
__device__ __forceinline__ void dec_pv_any(const float* sPw, const unsigned char* vb, int rs,
                                           int hd, int lane, float* pv) {
  if (hd <= 32) dec_pv<T, 1>(sPw, vb, rs, hd, lane, pv);
  else if (hd <= 64) dec_pv<T, 2>(sPw, vb, rs, hd, lane, pv);
  else if (hd <= 96) dec_pv<T, 3>(sPw, vb, rs, hd, lane, pv);
  else dec_pv<T, 4>(sPw, vb, rs, hd, lane, pv);
}

// The decode loop (see the note at the top): one block of kDecWarps warps
// per (b*H + h, query row).  K/V come as raw rows of elt bytes an element
// (2: bf16, 4: f32); chunk: the copies' size (16 or 4 bytes, 0 for plain
// loads); kv_shared: V is staged into K's buffer once the scores are done
// (where two buffers would not fit).
template <class P, int kLayout>
__global__ void __launch_bounds__(kDecThreads)
    flash_decode_kernel(const float* __restrict__ q, const unsigned char* __restrict__ k,
                        const unsigned char* __restrict__ v, int elt, float* __restrict__ out,
                        float* __restrict__ m_out, float* __restrict__ l_out,
                        const int* __restrict__ kv_start, const int* __restrict__ kv_len,
                        const int* __restrict__ q_pos, int Sq, int Sk, int H, int KVH, int hd,
                        float scale, int causal, int window, int q_offset, float eps,
                        KvIndex ix, int chunk, int kv_shared) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sMax = sQ + kHdMax;           // [kDecWarps] each tile's max
  float* sCorr = sMax + kDecWarps;     // [kDecWarps] exp(m_{t-1} - m_t)
  float* sSum = sCorr + kDecWarps;     // [kDecWarps] the tile's p summed
  float* sP = sSum + 2 * kDecWarps;    // [kDecWarps][kBK]
  float* sPV = sP + kDecWarps * kBK;   // [kDecWarps][kHdMax]
  int* sKey = reinterpret_cast<int*>(sPV + kDecWarps * kHdMax);   // [kDecWarps][kBK]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rs = dec_row_stride(hd, elt);
  unsigned char* sK = reinterpret_cast<unsigned char*>(sKey + kDecWarps * kBK) + warp * kBK * rs;
  unsigned char* sV = kv_shared ? sK : sK + kDecWarps * kBK * rs;
  float* sPw = sP + warp * kBK;
  int* keyrow = sKey + warp * kBK;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KVH);
  const int row = blockIdx.y;
  const int ks = kv_start[b];
  const int kl = min(kv_len[b], Sk);
  const int qp = q_pos[b] + q_offset + row;
  int kv_end = kl;
  if (causal) kv_end = min(kv_end, qp + 1);
  const int ntiles = kv_end > ks ? (kv_end - ks + kBK - 1) / kBK : 0;

  DecCopy cc;
  cc.row_bytes = hd * elt, cc.rs = rs, cc.chunk = chunk;
  const int per = chunk ? cc.row_bytes / chunk : 1;
  cc.kpi = per <= 32 ? 32 / per : 1;
  cc.j0 = per <= 32 ? lane / per : 0;
  cc.c0 = per <= 32 ? lane % per : lane;
  cc.active = per > 32 || lane < cc.kpi * per;

  // the copies of tile t (K, then V unless it shares K's buffer)
  int t = warp;
  auto stage_k = [&](int tile) {
    const int base = ks + tile * kBK;
    if constexpr (kLayout == kPaged) {
      dec_lookup(keyrow, ix, base, b, ks, kl, lane);
      __syncwarp();
    }
    dec_stage<kLayout>(k, sK, keyrow, cc, base, b, Sk, KVH, kvh, lane);
    cp_async_commit();
  };
  auto stage_v = [&](int tile) {
    dec_stage<kLayout>(v, sV, keyrow, cc, ks + tile * kBK, b, Sk, KVH, kvh, lane);
    cp_async_commit();
  };
  if (t < ntiles) {
    stage_k(t);
    if (!kv_shared) stage_v(t);
  }
  // q (zeros past hd) and, where a row's bytes are not a multiple of 16,
  // zeros in the K rows' tails, which no copy writes
  for (int d = tid; d < kHdMax; d += kDecThreads)
    sQ[d] = d < hd ? q[((static_cast<size_t>(b) * Sq + row) * H + h) * hd + d] : 0.f;
  const int tail = ((cc.row_bytes + 15) & ~15) - cc.row_bytes;
  if (tail) {
    for (int j = lane; j < kBK; j += 32)
      for (int c = 0; c < tail; c += 2)
        *reinterpret_cast<uint16_t*>(sK + j * rs + cc.row_bytes + c) = 0;
  }
  __syncthreads();   // q is in

  float m_run = kNegInf, l = 0.f, acc = 0.f;
  const int nchunks = (ntiles + kDecWarps - 1) / kDecWarps;
  for (int ch = 0; ch < nchunks; ++ch, t += kDecWarps) {
    const bool live = t < ntiles, next = t + kDecWarps < ntiles;
    const int base = ks + t * kBK;
    const int nact = min(kDecWarps, ntiles - ch * kDecWarps);
    // scores s = (q . k) * scale, masked as the reference does, and the
    // tile's max
    float s[2] = {kNegInf, kNegInf};
    bool valid[2] = {false, false};
    if (live) {
      if (kv_shared) cp_async_wait_all();
      else cp_async_wait_one();
      __syncwarp();
      if (elt == 4) dec_scores<float>(sQ, sK, rs, hd, lane, s[0], s[1]);
      else dec_scores<__nv_bfloat16>(sQ, sK, rs, hd, lane, s[0], s[1]);
      float mx = kNegInf;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int kp = base + lane + 32 * i;
        bool ok = kp >= ks && kp < kl;
        if (causal) ok = ok && qp >= kp;
        if (window) ok = ok && qp - kp < window;
        valid[i] = ok;
        s[i] = ok ? __fmul_rn(s[i], scale) : kNegInf;
        mx = fmaxf(mx, s[i]);
      }
#pragma unroll
      for (int o = 1; o < 32; o *= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      if (lane == 0) sMax[warp] = mx;
    }
    __syncthreads();   // every tile's max is in; every warp is done with its K rows
    // the prefix max: m_t of this warp's tile, m_{t-1}, and the chunk's last
    float m_prev = m_run, m_t = m_run, mc = m_run;
    for (int i = 0; i < nact; ++i) {
      const float mn = fmaxf(mc, sMax[i]);
      if (i == warp) {
        m_prev = mc;
        m_t = mn;
      }
      mc = mn;
    }
    if (live) {
      if (kv_shared) stage_v(t);
      else if (next) stage_k(t + kDecWarps);
      // p = exp(s - m_t) (masked keys exactly 0), corr_t = exp(m_{t-1} - m_t)
#pragma unroll
      for (int i = 0; i < 2; ++i) sPw[lane + 32 * i] = valid[i] ? expf(s[i] - m_t) : 0.f;
      if (lane == 0) sCorr[warp] = expf(m_prev - m_t);
      if (kv_shared || !next) cp_async_wait_all();
      else cp_async_wait_one();
      __syncwarp();   // the p tile and the V rows are in
      // the tile's p summed in key order from zero (lane 0), and its p v
      if (lane == 0) {
        float sum = 0.f;
#pragma unroll 4
        for (int j = 0; j < kBK; j += 4) {
          const float4 p4 = *reinterpret_cast<const float4*>(sPw + j);
          sum += p4.x;
          sum += p4.y;
          sum += p4.z;
          sum += p4.w;
        }
        sSum[warp] = sum;
      }
      float* pv = sPV + warp * kHdMax;
      if (elt == 4) dec_pv_any<float>(sPw, sV, rs, hd, lane, pv);
      else dec_pv_any<__nv_bfloat16>(sPw, sV, rs, hd, lane, pv);
      __syncwarp();   // every lane is done with the V rows
      if (next) {
        if (kv_shared) stage_k(t + kDecWarps);
        else stage_v(t + kDecWarps);
      }
    }
    __syncthreads();   // every tile's sum, corr and p v are in
    // the tiles in order: l = l * corr + sum, acc = acc * corr + p v
    for (int i = 0; i < nact; ++i) {
      const float corr = sCorr[i];
      l = fmaf(l, corr, sSum[i]);
      if (tid < hd) acc = fmaf(acc, corr, sPV[i * kHdMax + tid]);
    }
    m_run = mc;
  }

  // epilogue: o = acc / l through K1 in registers, a column a thread; a
  // fully masked row has l == 0 and divides 0 by minpos instead
  if (tid < hd) {
    const posit::DivisorOf<P> dl =
        posit::prep_divisor_fields<P>(posit::float_to_fields<P::n>(l > 0.f ? l : eps));
    out[((static_cast<size_t>(b) * Sq + row) * H + h) * hd + tid] =
        posit::divide_to_float<P>(posit::float_to_fields<P::n>(acc), dl);
  }
  // the row's final m and l, where the caller asks for them
  if (m_out != nullptr && tid == 0) {
    const size_t r = static_cast<size_t>(bh) * Sq + row;
    m_out[r] = m_run;
    l_out[r] = l;
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
    // columns in order, one f32 FMA each (the decode loop's and the twin's
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
    // (threads 0-3 of each warp), as the decode loop sums it
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
    // cores, or over its keys in order, one f32 FMA each (the decode loop's
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

// One launch of the decode loop (flash_decode_kernel, a query row a block)
// or, kTile, the tile loop (flash_tile_kernel, c.bq rows a block).
template <class P, int kLayout, bool kTile>
int launch(const Call& c) {
  const long long heads = static_cast<long long>(c.B) * c.H;
  const int q_tiles = kTile ? (c.Sq + c.bq - 1) / c.bq : c.Sq;
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
    // K/V rows copied by cp.async where each row's bytes (and the bases)
    // take 16- or 4-byte copies, else by plain loads; V shares K's buffer
    // where two would not fit (f32 K/V past head_dim 104)
    const int elt = c.kv_f32 ? 4 : 2;
    const int chunk = kv_chunk(c.k, c.v, c.hd, elt);
    const bool shared = dec_smem_bytes(c.hd, elt, false) > kDecSmemMax;
    const size_t bytes = dec_smem_bytes(c.hd, elt, shared);
    const cudaError_t err = prepare(flash_decode_kernel<P, kLayout>, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_decode_kernel<P, kLayout><<<grid, kDecThreads, bytes, c.stream>>>(
        c.q, static_cast<const unsigned char*>(c.k), static_cast<const unsigned char*>(c.v),
        elt, c.out, c.m_out, c.l_out, c.kv_start, c.kv_len, c.q_pos, c.Sq, c.Sk, c.H, c.KVH,
        c.hd, c.scale, c.causal, c.window, c.q_offset, c.eps, c.ix, chunk, shared);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int kLayout, bool kTile>
int dispatch(int n, int radix, int red, int otf, int scaled, int nonrest, int it, int shift,
             int gbits, const Call& c) {
  if (c.hd > kHdMax || c.hd <= 0 || c.KVH <= 0 || c.H % c.KVH) return -2;
  if (kTile && (c.bq < 1 || c.bq > kFRows)) return -2;
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

// One launch of the flash forward.  loop 0 (the decode loop: the decode
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
//     the place of kv_start.  The other layouts ignore bq (the decode loop
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
  if (loop == kTileLoop && layout != kPacked) bq = kFRows;
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
