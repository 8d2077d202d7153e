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
// It computes the
// online-softmax kv scan carrying (m, l, acc), GQA by head index, the
// causal / window / kv_start / kv_len / q_pos masks, and the final acc / l
// through K1 as a rowwise posit divide, minpos for fully masked rows.
//
// Design (simple and correct first):
//   * one block per (b*H + h, q tile of bq rows), bq = 16 (1 for decode):
//     b*H + h on gridDim.x (up to 2^31 - 1; gridDim.y stopped it at
//     65535), the q tile on gridDim.y (up to 65535 tiles), offsets in 64
//     bits;
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
//   * K4 (paged) changes only the tile load: key kp of sequence b is pool
//     row bt[b*max_blocks + kp/bs] (clamped to [0, NB)), offset kp % bs.
//     Each tile's pool rows are looked up once into shared memory; keys
//     outside [kv_start, kv_len) load as 0 (a page row past a sequence's
//     end may hold a previous owner's values).  The tiles, the masks and
//     every sum are K3's, so K4 gives K3's bits on a dense cache that holds
//     the same logical rows; block_size is free of the tile size (the
//     gather is per key);
//   * K5 (packed) takes per-position segment ids seg_q (B, Sq) and seg_kv
//     (B, Sk).  The wrapper picks bq so that no block of query rows
//     straddles two segments; each block takes its segment from its rows
//     (query pads carry -2 and attend nothing), anchors its kv tiles at the
//     segment's first key and masks every key of another segment (loaded as
//     0).  A segment then walks the tiles its solo K3 prefill walks, and
//     masked keys are exact no-ops (p = 0, corr = exp(0) = 1): its rows are
//     the bits of a solo K3 prefill of that prompt.
// The layout is a template flag, so K3/K6's instantiation holds none of the
// paged or packed code (its schedule is ptxas-sensitive, PERF.md section 6).
//
// Instantiated in every layout for the plans posit::kModelPlan names: every
// posit8, posit16, posit32 and posit64 plan; posit32 srt_r4_scaled and
// posit64 run o / l on K1's two-word frame with a 48-byte divisor per row.
// K/V may be bf16 or f32 (the reference upcasts K/V to f32 before its
// kernel): the tiles are f32 in shared memory either way, so the element
// type is a flag of the call, not of the instantiation: each tile load
// branches on it (load_kv), the same way in every block.  The source is
// built once per format (posit64: per part, -DPOSIT_MODEL_N,
// -DPOSIT_MODEL_PART, posit::kLibraryPlan): a library returns -1 for
// another library's plan.
//
// Bound: decode reads the KV cache (or the pages each sequence attends)
// once and is memory-bound; prefill does 4*B*H*Sq*Sk*hd f32 FMA flops (K5:
// over the block-diagonal causal pairs).  Tensor cores are left for a
// later version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <type_traits>

#include "posit_srt.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBK = 64;        // keys per kv tile
constexpr int kHdMax = 128;    // largest head_dim the kernel takes
constexpr int kBQMax = 16;     // query rows per block (prefill)
constexpr float kNegInf = -1e30f;

enum Layout { kDense = 0, kPaged = 1, kPacked = 2 };

template <class P>
size_t smem_bytes(int bq, int hd, int layout) {
  // the divisors first (32 bytes each, 48 on the two-word frame: a multiple
  // of their 4- or 8-byte alignment, so the floats after them stay aligned
  // at any bq); the pointers in flash_kernel follow this order exactly
  const size_t bytes = sizeof(posit::DivisorOf<P>) * bq    // per-row divisor
                       + sizeof(float) * (bq * hd + kBK * (hd + 1) + kBK * hd + bq * kBK + 3 * bq)
                       + bq * kBK;                          // mask bytes
  if (layout == kDense) return bytes;
  // a tile's key index (paged: pool row; packed: segment id), the rows'
  // segment ids, and two scalars, after the mask bytes at int alignment
  return (bytes + 3) / 4 * 4 + sizeof(int) * (kBK + kBQMax + 2);
}

// Where the paged and packed layouts find their keys.  Sk is the virtual
// kv length (paged: max_blocks * bs).
struct KvIndex {
  const int* bt;      // paged: (B, max_blocks) block table
  int max_blocks, bs, NB;
  const int* seg_q;   // packed: (B, Sq) and (B, Sk) segment ids
  const int* seg_kv;
};

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }

// One kv tile of kBK keys from base into sK (rows padded to hd + 1) and sV,
// as f32 (bf16 upcast exactly); keys outside the sequence, the page table's
// masked rows (sKey -1) and, packed, other segments' keys load as 0.  The
// kernel calls it for one element type or the other, by a branch that
// every block takes the same way: the bf16 loop is the one the kernel had
// before f32 K/V, so K3 decode kept its time on an H100, where one select
// per element cost it 2% (PERF.md section 6).
template <int kLayout, class T>
__device__ __forceinline__ void load_kv(const T* __restrict__ k, const T* __restrict__ v,
                                        float* sK, float* sV, const int* sKey, int base,
                                        int seg, int b, int Sk, int KVH, int kvh, int hd) {
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
      if constexpr (kLayout == kPacked) in = in && sKey[j] == seg;
      off = ((static_cast<size_t>(b) * Sk + (in ? kp : 0)) * KVH + kvh) * hd + d;
    }
    sK[j * (hd + 1) + d] = in ? to_f32(k[off]) : 0.f;
    sV[i] = in ? to_f32(v[off]) : 0.f;
  }
}

// bq (1, kBQMax, or for K5 a divisor of the segment width) is the number of
// query rows of a block's tile; a row's result does not depend on it, so
// decode (Sq == 1) takes one-row tiles.  K/V come as bf16 (k, v) or, where
// kf is not null, as f32 (kf, vf).
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
  // paged / packed only (smem_bytes reserves them for those layouts)
  int* sKey = reinterpret_cast<int*>(
      (reinterpret_cast<uintptr_t>(sMask + bq * kBK) + 3) & ~uintptr_t(3));
  int* sRowSeg = sKey + kBK;
  int* sSeg = sRowSeg + kBQMax;  // [0]: the block's segment, [1]: its first key

  constexpr int kAcc = (kBQMax * kHdMax + kThreads - 1) / kThreads;
  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KVH);
  const int q0 = blockIdx.y * bq;
  const int rows = min(bq, Sq - q0);
  int ks = kv_start[b];
  const int kl = min(kv_len[b], Sk);
  const int qp0 = q_pos[b] + q_offset + q0;
  int seg = 0;
  if constexpr (kLayout == kPacked) {
    // the block's segment (its rows hold one id, or -2 for query pads) and
    // the segment's first key, where its kv tiles are anchored
    if (tid < bq) sRowSeg[tid] = tid < rows ? ix.seg_q[static_cast<size_t>(b) * Sq + q0 + tid] : -2;
    if (tid == 0) sSeg[1] = Sk;
    __syncthreads();
    if (tid == 0) {
      int s = -2;
      for (int r = 0; r < rows; ++r) s = max(s, sRowSeg[r]);
      sSeg[0] = s;
    }
    __syncthreads();
    seg = sSeg[0];
    if (seg >= 0) {
      for (int kp = tid; kp < Sk; kp += kThreads) {
        if (ix.seg_kv[static_cast<size_t>(b) * Sk + kp] == seg) {
          atomicMin(&sSeg[1], kp);
          break;
        }
      }
    }
    __syncthreads();
    ks = sSeg[1];  // Sk (no tiles) when the block holds only pads
  }

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
    } else if constexpr (kLayout == kPacked) {
      if (tid < kBK) {
        const int kp = base + tid;
        sKey[tid] = kp >= 0 && kp < Sk ? ix.seg_kv[static_cast<size_t>(b) * Sk + kp] : -1;
      }
    }
    __syncthreads();
    if (kf != nullptr) load_kv<kLayout>(kf, vf, sK, sV, sKey, base, seg, b, Sk, KVH, kvh, hd);
    else load_kv<kLayout>(k, v, sK, sV, sKey, base, seg, b, Sk, KVH, kvh, hd);
    __syncthreads();
    // scores s = (q . k) * scale, masked as the reference does
    for (int i = tid; i < bq * kBK; i += kThreads) {
      const int r = i / kBK, j = i % kBK;
      const int kp = base + j, qp = qp0 + r;
      bool valid = r < rows && kp >= ks && kp < kl;
      if (causal) valid = valid && qp >= kp;
      if (window) valid = valid && qp - kp < window;
      if constexpr (kLayout == kPacked) valid = valid && sRowSeg[r] == sKey[j];
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

template <class P, int kLayout>
int launch(const float* q, const void* k, const void* v, int kv_f32, float* out,
           float* m_out, float* l_out, const int* kv_start, const int* kv_len,
           const int* q_pos, int B, int Sq, int Sk, int H, int KVH, int hd, float scale,
           int causal, int window, int q_offset, float eps, int bq, const KvIndex& ix,
           cudaStream_t s) {
  auto kern = flash_kernel<P, kLayout>;
  const size_t bytes = smem_bytes<P>(bq, hd, kLayout);
  const long long heads = static_cast<long long>(B) * H;
  const int q_tiles = (Sq + bq - 1) / bq;
  if (heads > 0x7FFFFFFFLL || q_tiles > 65535) return -2;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(heads), q_tiles);
  const auto* kb = static_cast<const __nv_bfloat16*>(kv_f32 ? nullptr : k);
  const auto* vb = static_cast<const __nv_bfloat16*>(kv_f32 ? nullptr : v);
  const auto* kf = static_cast<const float*>(kv_f32 ? k : nullptr);
  const auto* vf = static_cast<const float*>(kv_f32 ? v : nullptr);
  kern<<<grid, kThreads, bytes, s>>>(q, kb, vb, kf, vf, out, m_out, l_out, kv_start, kv_len,
                                     q_pos, bq, Sq, Sk, H, KVH, hd, scale, causal, window,
                                     q_offset, eps, ix);
  return static_cast<int>(cudaGetLastError());
}

template <int kLayout>
int dispatch(int n, int radix, int red, int otf, int scaled, int nonrest, int it, int shift,
             int gbits, const float* q, const void* k, const void* v, int kv_f32, float* out,
             float* m_out, float* l_out, const int* kv_start, const int* kv_len,
             const int* q_pos, int B, int Sq, int Sk, int H, int KVH, int hd, float scale,
             int causal, int window, int q_offset, float eps, int bq, const KvIndex& ix,
             void* stream) {
  if (hd > kHdMax || hd <= 0 || KVH <= 0 || H % KVH || bq < 1 || bq > kBQMax) return -2;
  if (B <= 0 || Sq <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = -1;
  posit::dispatch_plan(n, radix, red, otf, scaled, nonrest, it, shift, gbits, [&](auto plan) {
    using P = decltype(plan);
    if constexpr (posit::kLibraryPlan<P>) {
      rc = launch<P, kLayout>(q, k, v, kv_f32, out, m_out, l_out, kv_start, kv_len, q_pos, B,
                              Sq, Sk, H, KVH, hd, scale, causal, window, q_offset, eps, bq, ix,
                              s);
    }
  });
  return rc;
}

}  // namespace

// One launch of the flash forward; layout 0 (dense: K3, or K6 with m_out /
// l_out), 1 (paged: K4) or 2 (packed: K5).
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
//     the place of kv_start.  Dense and paged ignore bq (one-row blocks for
//     decode, Sq == 1, else kBQMax).
// Returns 0, a cudaError_t, -1 when no instantiation matches the plan and
// layout, -2 for a head_dim above kHdMax, a bad head split, a bad layout,
// B*H past 2^31 - 1 or more than 65535 q tiles.
extern "C" int posit_flash_attn(int n, int radix, int red, int otf, int scaled, int nonrest,
                                int it, int shift, int gbits, int layout, int kv_f32,
                                const float* q, const void* k, const void* v, float* out,
                                float* m_out,
                                float* l_out, const int* kv_start, const int* kv_len,
                                const int* q_pos, const int* block_tables, const int* seg_q,
                                const int* seg_kv, int B, int Sq, int Sk, int H, int KVH,
                                int hd, int NB, int bs, int max_blocks, float scale,
                                int causal, int window, int q_offset, float eps, int bq,
                                void* stream) {
  const KvIndex ix{block_tables, max_blocks, bs, NB, seg_q, seg_kv};
  if (layout == kPaged) {
    if (NB <= 0 || bs <= 0 || max_blocks <= 0) return -2;
    Sk = max_blocks * bs;
  }
  if (layout != kPacked) bq = Sq == 1 ? 1 : kBQMax;
  auto run = [&](auto tag) {
    return dispatch<decltype(tag)::value>(n, radix, red, otf, scaled, nonrest, it, shift,
                                          gbits, q, k, v, kv_f32, out, m_out, l_out, kv_start,
                                          kv_len, q_pos, B, Sq, Sk, H, KVH, hd, scale, causal,
                                          window, q_offset, eps, bq, ix, stream);
  };
  switch (layout) {
    case kDense: return run(std::integral_constant<int, kDense>{});
    case kPaged: return run(std::integral_constant<int, kPaged>{});
    case kPacked: return run(std::integral_constant<int, kPacked>{});
    default: return -2;
  }
}
