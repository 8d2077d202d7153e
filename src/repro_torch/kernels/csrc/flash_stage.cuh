// The tensor-core, cp.async and K/V staging helpers of the flash kernels:
// the forward's tile loop (K3 prefill, K5, K6: posit_flash_attn.cu
// flash_tile_kernel) and the backward (K7, K8: posit_flash_bwd.cu) stage K/V
// with the same code, so all widen the same f32 tiles from bf16 or f32 rows,
// and run their products through the same 3xTF32 MMA (mma3).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kHdMax = 128;      // largest head_dim the decode loop and K5 take
constexpr int kTileHdMax = 256;  // largest head_dim the tile loop takes (dense layout)
constexpr int kBwdHdMax = 256;   // largest head_dim the backward (K7, K8) takes
constexpr int kQKeys = 32;   // keys a staging call copies (start_kv_copy, widen_kv): a K7 step

// One K/V element as f32: from the f32 tensor where the call gave f32 K/V
// (f not null, the same in every block), else from the bf16 one, upcast
// exactly.  One select per element: on an H100 a branch per tile between
// two copies of the loop (the one-row forward's form) cost K7 2-3%, this
// form left it 5% faster (PERF.md section 6).
__device__ __forceinline__ float kv_at(const __nv_bfloat16* b, const float* f, size_t off) {
  return f != nullptr ? f[off] : __bfloat162float(b[off]);
}

// Rows have stride hdp = hd8 + 4 (hd8: head_dim rounded up to 8, the MMA
// depth), so K7's and K8's fragment loads hit 32 distinct banks, as do the
// tile loop's 16-byte loads of eight rows.
__host__ __device__ inline int dkv_hdp(int hd) { return ((hd + 7) & ~7) + 4; }

constexpr int kWarps = kThreads / 32;
// n-tiles of a warp's part of the head's columns, for head_dim up to kHd
template <int kHd>
constexpr int kNtPartOf = kHd / 8 / kWarps;

// Tensor-core helpers (mma.sync m16n8k8, TF32 operands, f32 accumulate).
// Fragment layouts (PTX ISA, m16n8k8 .tf32), g = lane / 4, t = lane % 4:
//   A (16 x 8): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
//   B (8 x 8):  b0 (t, g), b1 (t + 4, g);
//   C (16 x 8): c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).
// 3xTF32: each f32 operand x is split into hi = tf32(x) and lo = tf32(x - hi)
// (x - hi is exact), and a b takes hi*hi + hi*lo + lo*hi, about f32's
// accuracy.  K and V staged from bf16 have lo = 0.

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

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
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

// The staging copies' size in bytes for K/V rows of hd elements of elt bytes
// at k and v: 16 or 4 where each row's bytes and both bases allow it, else
// 0 (the rows are read straight from the tensors).
inline int kv_chunk(const void* k, const void* v, int hd, int elt) {
  const int row = hd * elt;
  const uintptr_t base = reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v);
  return row % 16 == 0 && base % 16 == 0 ? 16 : row % 4 == 0 && base % 4 == 0 ? 4 : 0;
}

// Starts the copy of keys [k0, k0 + kQKeys) of kv head kvh, as they arrive
// (elt bytes an element), into the staging buffer (rows of hd elements,
// zeros past Sk), in chunks of `chunk` bytes, and commits it as one group.
__device__ void start_kv_copy(const unsigned char* k, const unsigned char* v, unsigned char* rK,
                             unsigned char* rV, int b, int kvh, int k0, int Sk, int KVH, int hd,
                             int elt, int chunk) {
  const int row = hd * elt, per_row = row / chunk;
  for (int i = threadIdx.x; i < kQKeys * per_row; i += kThreads) {
    const int j = i / per_row, c = (i % per_row) * chunk;
    const int kp = k0 + j;
    const bool in = kp < Sk;
    const size_t off = ((static_cast<size_t>(b) * Sk + (in ? kp : 0)) * KVH + kvh) * row + c;
    if (chunk == 16) {
      cp_async16(rK + j * row + c, k + off, in);
      cp_async16(rV + j * row + c, v + off, in);
    } else {
      cp_async4(rK + j * row + c, k + off, in);
      cp_async4(rV + j * row + c, v + off, in);
    }
  }
  cp_async_commit();
}

// Keys [k0, k0 + kQKeys) as f32 tiles sK / sV (zeros past Sk and in the
// columns [hd, hd8)): from the staging buffer, or (raw null) straight from
// the tensors.
__device__ void widen_kv(const unsigned char* raw, const __nv_bfloat16* k,
                         const __nv_bfloat16* v, const float* kf, const float* vf, float* sK,
                         float* sV, int b, int kvh, int k0, int Sk, int KVH, int hd, int hdp) {
  const int hd8 = hdp - 4;
  const float* rKf = reinterpret_cast<const float*>(raw);
  const __nv_bfloat16* rKb = reinterpret_cast<const __nv_bfloat16*>(raw);
  const int half = kQKeys * hd;   // elements of the K rows, then the V rows
  for (int i = threadIdx.x; i < kQKeys * hd8; i += kThreads) {
    const int j = i / hd8, d = i % hd8;
    float kx = 0.f, vx = 0.f;
    if (d < hd) {
      if (raw != nullptr) {
        const int e = j * hd + d;
        kx = kf != nullptr ? rKf[e] : __bfloat162float(rKb[e]);
        vx = kf != nullptr ? rKf[half + e] : __bfloat162float(rKb[half + e]);
      } else if (k0 + j < Sk) {
        const size_t off = ((static_cast<size_t>(b) * Sk + k0 + j) * KVH + kvh) * hd + d;
        kx = kv_at(k, kf, off);
        vx = kv_at(v, vf, off);
      }
    }
    sK[j * hdp + d] = kx;
    sV[j * hdp + d] = vx;
  }
}

}  // namespace
