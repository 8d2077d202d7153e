// K1: the posit SRT digit-recurrence datapath as device functions.
//
// Replaces the reference's datapath body in src/repro/kernels/posit_div.py
// (_divide_fields :433, _divide_block :549, _divide_floats_wide :574,
// divide_floats_block :609), which every Pallas kernel composes, and the
// wide casts of src/repro/core/wide.py (decode_wide :65, encode_wide :98,
// float_to_posit_wide :176, posit_wide_to_float :197).  Here it is a set of
// __host__ __device__ functions on registers that every kernel under csrc/
// inlines (K2, K10: posit_fused_div.cu; K3-K8: posit_flash_attn.cu,
// posit_flash_bwd.cu; K9: posit_softmax.cu; K11: posit_div.cu; K12's casts:
// posit_cast.cu); the same header compiles as host C++ so the arithmetic
// can be checked without a card.
//
// Scope: every planned (format, variant) of posit_plans.inc, in two frames:
//   * W = 1: the residual is one 32-bit word (3 integer bits, 29 fraction
//     bits): posit8/16 x all nine Table IV rows, posit32 x the eight
//     unscaled rows (posit10's nine rows for K11 alone);
//   * W = 2: the residual is 3 integer bits and 61 fraction bits, exactly
//     one 64-bit register, so each carry-save word is a uint64_t: the CSA's
//     << 1 needs no cross-word OR, and selection reads the register's top
//     bits (the reference's top word): posit32 srt_r4_scaled (one-word
//     patterns and quotient) and posit64 x the eight unscaled rows (64-bit
//     patterns, significands and quotient registers).
// The plan's static fields are template parameters (Plan<...>), so each row
// compiles to straight-line register code with its loop trip count known;
// W is derived from them (3 + FRAC + shift = 32 W), never guessed.
//
// Bit-exactness rules kept from the reference:
//   * logical shifts on unsigned types, arithmetic ones on signed types;
//     every variable shift is guarded (a shift by >= the word's width gives
//     0, as in posit.py:102-115), never C++ undefined behaviour;
//   * f32 inputs are classified by their bit fields, never by float compares;
//   * 2^e is built from two normal factors (ldexp_f32), never one exp2f;
//   * a posit64 quotient below the f32 normal range comes out as a signed
//     zero (the reference's backends flush ldexp_f32's subnormal results),
//     by an explicit compare: nothing here may be built with
//     --use_fast_math or -ftz=true.
//
// Cost: the recurrence is integer ALU work, ~10-20 ops per iteration on
// 32-bit words (8 iterations for posit16 radix-4), about twice that on
// 64-bit ones (32 iterations for posit64 radix-4); the kernels that use it
// are bound by these integer operations, not by memory (see PERF.md).
#pragma once

#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define PHD __host__ __device__ __forceinline__
#else
#define PHD inline
#endif

namespace posit {

PHD uint32_t f2u(float x) {
#ifdef __CUDA_ARCH__
  return __float_as_uint(x);
#else
  uint32_t u;
  memcpy(&u, &x, 4);
  return u;
#endif
}

PHD float u2f(uint32_t u) {
#ifdef __CUDA_ARCH__
  return __uint_as_float(u);
#else
  float x;
  memcpy(&x, &u, 4);
  return x;
#endif
}

PHD int clz(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __clz(static_cast<int>(x));  // 32 for x == 0
#else
  return x ? __builtin_clz(x) : 32;
#endif
}

PHD int clz(uint64_t x) {
#ifdef __CUDA_ARCH__
  return __clzll(static_cast<long long>(x));  // 64 for x == 0
#else
  return x ? __builtin_clzll(x) : 64;
#endif
}

PHD int clz32(uint32_t x) { return clz(x); }

// Guarded variable shifts: any amount outside [0, width) gives 0.
PHD uint32_t shl(uint32_t x, int s) { return (s < 0 || s >= 32) ? 0u : (x << s); }
PHD uint32_t shr(uint32_t x, int s) { return (s < 0 || s >= 32) ? 0u : (x >> s); }
PHD uint64_t shl(uint64_t x, int s) { return (s < 0 || s >= 64) ? 0ull : (x << s); }
PHD uint64_t shr(uint64_t x, int s) { return (s < 0 || s >= 64) ? 0ull : (x >> s); }

// floor(e / 2) without relying on the shift of a negative int.
PHD int floor_half(int e) { return e >= 0 ? e / 2 : -((1 - e) / 2); }

PHD int imax(int a, int b) { return a > b ? a : b; }
PHD int imin(int a, int b) { return a < b ? a : b; }

// An unsigned register of the given width in bits (32 or 64).
template <int Bits>
struct UInt {
  using type = uint32_t;
};
template <>
struct UInt<64> {
  using type = uint64_t;
};

// ---------------------------------------------------------------- format

// Patterns of n <= 32 live in a uint32_t, posit64's in a uint64_t (B bits).
template <int N>
struct Fmt {
  static constexpr int n = N;
  static constexpr int es = 2;
  static constexpr int F = N - 3 - es;
  static constexpr int B = N > 32 ? 64 : 32;
  using U = typename UInt<B>::type;
  static constexpr U one = 1;
  static constexpr U mask = N == B ? ~U(0) : ((one << N) - one);
  static constexpr U nar = one << (N - 1);
  static constexpr U maxpos_body = (one << (N - 1)) - one;
};

template <class U>
struct FieldsT {
  bool sign;
  int scale;
  U sig;
  bool zero;
  bool nar;
};
using Fields = FieldsT<uint32_t>;

// posit.py posit_decode (wide.py decode_wide for n > 32)
template <int N>
PHD FieldsT<typename Fmt<N>::U> decode(typename Fmt<N>::U p) {
  using Fm = Fmt<N>;
  using U = typename Fm::U;
  constexpr int B = Fm::B;
  FieldsT<U> d;
  p &= Fm::mask;
  d.zero = p == U(0);
  d.nar = p == Fm::nar;
  d.sign = ((p >> (N - 1)) & U(1)) != U(0);
  const U mag = d.sign ? ((~p + U(1)) & Fm::mask) : p;
  const U body = mag << (B - (N - 1));
  const bool r0 = (body >> (B - 1)) != U(0);
  const U inv = r0 ? ~body : body;
  const int run = imin(clz(inv), N - 1);
  const int k = r0 ? run - 1 : -run;
  const U tail = shl(body, run + 1);
  const int e = static_cast<int>(tail >> (B - Fm::es));
  const U frac_tail = tail << Fm::es;
  const U frac = Fm::F > 0 ? (frac_tail >> (B - Fm::F)) : U(0);
  d.scale = k * (1 << Fm::es) + e;
  d.sig = (U(1) << Fm::F) | frac;
  return d;
}

// posit.py posit_encode / wide.py encode_wide (RNE with the deep-regime
// rule, saturating)
template <int N>
PHD typename Fmt<N>::U encode(bool sign, int scale, typename Fmt<N>::U frac, uint32_t round_bit,
                              bool sticky, bool is_zero, bool is_nar) {
  using Fm = Fmt<N>;
  using U = typename Fm::U;
  constexpr int n = N, es = Fm::es, F = Fm::F;
  round_bit &= 1u;
  const int k = floor_half(floor_half(scale));  // scale >> 2 (es == 2)
  const U e = static_cast<U>(static_cast<uint32_t>(scale) & ((1u << es) - 1u));
  const bool over = k > n - 2;
  const bool under = k < -(n - 2);
  const int kc = imax(-(n - 2), imin(k, n - 2));
  const bool pos = kc >= 0;
  const int l = pos ? kc + 1 : -kc;
  const int rlen = l + 1;
  const U rpat = pos ? (shl(U(1), l + 1) - U(2)) : U(1);
  const U eg = (e << F) | frac;
  constexpr int egw = F + es;
  const int m = (n - 1) - rlen;
  const int m_pos = imax(m, 0);
  const int discard = egw - m_pos;
  const U kept = shr(eg, discard);
  const uint32_t g_from_eg = static_cast<uint32_t>(shr(eg, imax(discard - 1, 0)) & U(1));
  const uint32_t guard = discard > 0 ? g_from_eg : round_bit;
  const U below_mask = shl(U(1), imax(discard - 1, 0)) - U(1);
  const bool st_eg = (eg & below_mask) != U(0);
  const bool sticky_full = discard > 0 ? (st_eg || round_bit != 0u || sticky) : sticky;
  const bool trunc_regime = m < 0;
  const U body_base = trunc_regime ? (rpat >> 1) : (shl(rpat, m_pos) | kept);
  const uint32_t lsb = static_cast<uint32_t>(body_base & U(1));
  uint32_t inc = guard & ((sticky_full ? 1u : 0u) | lsb);
  if constexpr (es == 2 && F >= 2) {
    const int c = discard - F;
    const U f_ext = (frac << 2) | (U(round_bit) << 1) | U(sticky ? 1u : 0u);
    const U thr = c == 1 ? (U(1) << F) : (U(1) << (F - 2));
    const bool e_cond = c == 1 ? ((e & U(1)) == U(1)) : ((e & U(3)) == U(3));
    const bool deep_up = e_cond && (f_ext > thr || (f_ext == thr && lsb == 1u));
    if (c >= 1 && m >= 0) inc = deep_up ? 1u : 0u;
  }
  if (trunc_regime) inc = 0u;
  U body = body_base + U(inc);
  if (over) body = Fm::maxpos_body;
  if (under) body = U(1);
  if (body < U(1)) body = U(1);
  if (body > Fm::maxpos_body) body = Fm::maxpos_body;
  U p = sign ? ((~body + U(1)) & Fm::mask) : body;
  if (is_zero) p = U(0);
  if (is_nar) p = Fm::nar;
  return p;
}

// posit.py float_decompose: exact integer fields of an f32
struct FloatFields {
  bool sign;
  int scale;
  uint32_t ti;  // 25-bit significand, hidden bit at bit 24
  bool zero;
  bool nar;
};

PHD FloatFields float_decompose(float x) {
  FloatFields f;
  const uint32_t bits = f2u(x);
  const int exp_f = static_cast<int>((bits >> 23) & 0xFFu);
  const uint32_t mant = bits & 0x7FFFFFu;
  const bool is_sub = exp_f == 0;
  f.zero = is_sub && mant == 0u;
  f.nar = exp_f == 255;
  f.sign = (bits >> 31) == 1u && !f.zero;
  const int blen = 32 - clz(mant);
  f.scale = is_sub ? blen - 150 : exp_f - 127;
  f.ti = is_sub ? shl(mant, 25 - blen) : (((1u << 23) | mant) << 1);
  return f;
}

// posit.py float_to_posit / wide.py float_to_posit_wide (posit64 holds
// every f32 significand: only deep regime tails round)
template <int N>
PHD typename Fmt<N>::U float_to_posit(float x) {
  using U = typename Fmt<N>::U;
  constexpr int F = Fmt<N>::F;
  constexpr int keep = F + 1;
  constexpr int drop = 25 - keep;
  const FloatFields f = float_decompose(x);
  U frac;
  uint32_t round_bit;
  bool sticky;
  if constexpr (drop >= 1) {
    frac = (f.ti >> drop) & ((1u << F) - 1u);
    round_bit = (f.ti >> (drop - 1)) & 1u;
    sticky = (f.ti & ((1u << (drop - 1)) - 1u)) != 0u;
  } else {  // F >= 24 (posit32, posit64 from f32): nothing is cut
    frac = (U(f.ti) << (keep - 25)) & ((U(1) << F) - U(1));
    round_bit = 0u;
    sticky = false;
  }
  return encode<N>(f.sign, f.scale, frac, round_bit, sticky, f.zero, f.nar);
}

PHD float pow2_f32(int e) { return u2f(static_cast<uint32_t>(e + 127) << 23); }

// posit.py ldexp_f32: m * 2^e through two normal power-of-two factors
PHD float ldexp_f32(float m, int e) {
  e = imax(-252, imin(e, 254));
  const int e1 = floor_half(e);
  return (m * pow2_f32(e1)) * pow2_f32(e - e1);
}

// posit.py posit_to_float / wide.py posit_wide_to_float (the significand
// rounded to 24 bits by its G/R/S bits; below the f32 normal range a signed
// zero, as the reference's backends flush)
template <int N>
PHD float posit_to_float(typename Fmt<N>::U p) {
  using U = typename Fmt<N>::U;
  constexpr int F = Fmt<N>::F;
  const auto d = decode<N>(p);
  float mag;
  if constexpr (N > 32) {
    constexpr int sh = F + 1 - 24;
    uint32_t m24 = static_cast<uint32_t>(d.sig >> sh);
    const uint32_t guard = static_cast<uint32_t>((d.sig >> (sh - 1)) & U(1));
    const uint32_t sticky = (d.sig & ((U(1) << (sh - 1)) - U(1))) != U(0) ? 1u : 0u;
    m24 += guard & (sticky | (m24 & 1u));
    mag = ldexp_f32(static_cast<float>(m24), d.scale - 23);
    if (mag < 1.17549435e-38f) mag = 0.0f;  // 2^-126
  } else {
    mag = ldexp_f32(static_cast<float>(d.sig), d.scale - F);
  }
  float val = d.sign ? -mag : mag;
  if (d.zero) val = 0.0f;
  if (d.nar) val = u2f(0x7FC00000u);  // the canonical quiet NaN
  return val;
}

// ------------------------------------------------------- straight casts
//
// K2 and K10 cast between f32 and posit fields directly, where
// decode(float_to_posit(x)) and posit_to_float(encode(...)) build a pattern
// only to take it apart again.  round_fields is encode's rounding done on
// fields, giving what decode would: RNE to the fraction width the regime
// leaves with the carry into the scale, the deep-regime rule, saturation.

// The posit<N> nearest sig * 2^(scale - H) (sig's hidden bit at bit H > F;
// sticky: nonzero bits below sig), as decode<N>(encode<N>(...)) gives its
// scale and significand.
template <int N, int H, class S>
PHD FieldsT<typename Fmt<N>::U> round_fields(bool sign, int scale, S sig, bool sticky) {
  using U = typename Fmt<N>::U;
  constexpr int F = Fmt<N>::F;
  static_assert(F < H && H + 1 < 8 * int(sizeof(S)), "sig holds a hidden bit above F bits");
  const int k = scale >> 2;  // floor(scale / 4), es = 2
  const int fb = N - 3 - (k >= 0 ? k + 2 : 1 - k);  // fraction bits the regime leaves
  // fb >= 0: RNE to fb fraction bits, a tie to the pattern's even last bit
  // (at fb = 0 the last exponent bit); rounding up to 2 carries into the
  // scale.  drop lies in [H - F, H] for fb in [0, F], and is clamped to H
  // for the fb < 0 it does not serve, so both shifts stay inside S.
  const int drop = imin(H - fb, H);
  const S half = S(1) << (drop - 1);
  const uint32_t last = fb > 0 ? static_cast<uint32_t>(sig >> drop) & 1u
                               : static_cast<uint32_t>(scale) & 1u;
  const S kept = (sig + (half - S(1)) + S(last | (sticky ? 1u : 0u))) & ~(half + half - S(1));
  const bool carry = (kept >> (H + 1)) != S(0);
  const U rsig = carry ? U(1) << F : static_cast<U>(kept >> (H - F));
  // fb = -1, -2: one or no exponent bit left, so encode rounds by value to
  // 2^lo or 2^(lo + g), g = 2 or 4: up past the midpoint (1 + 2^-g) 2^(lo + g
  // - 1), a tie to the pattern's even last bit
  const int g = fb == -1 ? 2 : 4;
  const int e = static_cast<int>(static_cast<uint32_t>(scale) & static_cast<uint32_t>(g - 1));
  const S thr = fb == -1 ? S(1) << (H - 2) : S(1) << (H - 4);
  const uint32_t dlast = fb == -1 ? (static_cast<uint32_t>(scale) >> 1) & 1u : (k < 0 ? 1u : 0u);
  const bool up = e == g - 1 && (sig & ((S(1) << H) - S(1))) + S(dlast | (sticky ? 1u : 0u)) > thr;
  FieldsT<U> r;
  r.sign = sign;
  r.scale = fb >= 0 ? scale + (carry ? 1 : 0)
          : fb >= -2 ? scale - e + (up ? g : 0)
          : (k > 0 ? 4 * (N - 2) : -4 * (N - 2));  // fb <= -3: maxpos, minpos
  r.sig = fb >= 0 ? rsig : U(1) << F;
  r.zero = false;
  r.nar = false;
  return r;
}

// decode<N>(float_to_posit<N>(x)) with no pattern built; where zero or nar
// is set, the other fields are left unspecified.
template <int N>
PHD FieldsT<typename Fmt<N>::U> float_to_fields(float x) {
  using U = typename Fmt<N>::U;
  constexpr int F = Fmt<N>::F;
  const FloatFields f = float_decompose(x);
  FieldsT<U> r;
  if constexpr (F < 24) {
    r = round_fields<N, 24>(f.sign, f.scale, f.ti, false);
  } else {  // posit32, posit64: f32's 24 bits fit; the hidden bit goes above F
    r = round_fields<N, F + 1>(f.sign, f.scale, U(f.ti) << (F + 1 - 24), false);
  }
  r.zero = f.zero;
  r.nar = f.nar;
  return r;
}

// posit_to_float<N>(float_to_posit<N>(x)) with no pattern built (K12's
// round kernel): float_to_fields, then the f32 from the fields, as
// quotient_to_float's N <= 32 branch builds it.  Zero (-0.0 too) gives
// +0.0; inf and NaN (NaR) the canonical quiet NaN.
template <int N>
PHD float round_value(float x) {
  static_assert(N <= 32, "K12 rounds to posit8, posit16 and posit32");
  constexpr int F = Fmt<N>::F;
  const auto r = float_to_fields<N>(x);
  uint32_t u;
  if constexpr (F <= 23) {  // posit8, posit16: the fraction fits f32's, placed as it is
    u = (static_cast<uint32_t>(r.scale + 127) << 23) | ((r.sig & ((1u << F) - 1u)) << (23 - F));
  } else {  // posit32: the significand rounded to 24 bits (RNE), as posit_to_float
    u = f2u(static_cast<float>(r.sig)) + (static_cast<uint32_t>(r.scale - F) << 23);
  }
  u |= r.sign ? 0x80000000u : 0u;
  if (r.zero) u = 0u;
  if (r.nar) u = 0x7FC00000u;
  return u2f(u);
}

// The bfloat16 bits of x, as torch's .to(torch.bfloat16) gives them on the
// card: the card's own conversion (cvt.rn.bf16.f32: round to nearest even,
// any NaN to 0x7FFF); on the host the same rule written out.  torch's CPU
// conversion gives another NaN (0xFFFF), so a NaN's bits are the card's.
PHD uint16_t bf16_bits(float x) {
#ifdef __CUDA_ARCH__
  uint16_t h;
  asm("cvt.rn.bf16.f32 %0, %1;" : "=h"(h) : "f"(x));
  return h;
#else
  const uint32_t u = f2u(x);
  if ((u & 0x7FFFFFFFu) > 0x7F800000u) return 0x7FFFu;
  return static_cast<uint16_t>((u + 0x7FFFu + ((u >> 16) & 1u)) >> 16);
#endif
}

// ---------------------------------------------------------------- plan

// One row of kernel_datapath_plan (kernels/posit_div.py).  The frame holds
// 3 integer bits, the operand's FRAC bits and the left-align shift: its
// width 3 + FRAC + SHIFT is 32 W.
template <int N, int RADIX, bool RED, bool OTF, bool SCALED, bool NONREST, int IT,
          int SHIFT, int GBITS>
struct Plan {
  static constexpr int n = N;
  static constexpr int radix = RADIX;
  static constexpr bool redundant = RED;
  static constexpr bool otf = OTF;
  static constexpr bool scaled = SCALED;
  static constexpr bool nonrestoring = NONREST;
  static constexpr int iterations = IT;
  static constexpr int shift = SHIFT;
  static constexpr int gbits = GBITS;
  static constexpr int frac = Fmt<N>::F + 1;
  static constexpr int lr = RADIX == 2 ? 1 : 2;
  static constexpr int fp = IT * lr - lr;
  static constexpr int F = frac - 1;
  static constexpr int words = (3 + frac + SHIFT) / 32;
  static constexpr int qwords = (fp + 2 + 31) / 32;
  static_assert((3 + frac + SHIFT) % 32 == 0 && (words == 1 || words == 2),
                "the residual frame is one or two words");
  static_assert(qwords <= words, "the quotient register fits the frame's width");
  using Word = typename UInt<32 * words>::type;   // one carry-save residual word
  using QWord = typename UInt<32 * qwords>::type;  // one quotient register
  using Pat = typename Fmt<N>::U;                  // a pattern / significand
};

// An 8-entry table of small signed values packed one byte an entry into a
// 64-bit constant: looking entry i up is a shift and a sign extension, with
// no memory and no compare ladder.
constexpr uint64_t pack8(int t0, int t1, int t2, int t3, int t4, int t5, int t6, int t7) {
  return uint64_t(uint8_t(t0)) | uint64_t(uint8_t(t1)) << 8 | uint64_t(uint8_t(t2)) << 16 |
         uint64_t(uint8_t(t3)) << 24 | uint64_t(uint8_t(t4)) << 32 |
         uint64_t(uint8_t(t5)) << 40 | uint64_t(uint8_t(t6)) << 48 |
         uint64_t(uint8_t(t7)) << 56;
}

PHD int entry8(uint64_t table, int i) {
  return static_cast<int8_t>(static_cast<uint8_t>(table >> (8 * i)));
}

// seltables.py by divisor interval didx: RADIX4_M2 / M1 / M0 / MM1 (Eq 28)
// and SCALING_SHIFTS (s2 = 0: no second term).
constexpr uint64_t kRadix4M2 = pack8(12, 14, 15, 16, 18, 19, 20, 22);
constexpr uint64_t kRadix4M1 = pack8(3, 4, 4, 4, 5, 5, 5, 6);
constexpr uint64_t kRadix4M0 = pack8(-5, -6, -6, -7, -8, -8, -9, -10);
constexpr uint64_t kRadix4MM1 = pack8(-13, -15, -16, -18, -20, -21, -23, -25);
constexpr uint64_t kScaleS1 = pack8(1, 2, 1, 1, 2, 2, 3, 3);
constexpr uint64_t kScaleS2 = pack8(1, 1, 3, 0, 3, 0, 0, 0);
// Eq 29: the scaled plans' thresholds, divisor-independent
constexpr int kScaledM2 = 12, kScaledM1 = 4, kScaledM0 = -4, kScaledMM1 = -13;

// seltables.py SCALING_SHIFTS: M*v = v + (v >> s1) + (v >> s2), on a
// residual word of either width, with the divisor's shifts
template <class W>
PHD W scale_operand(W v, int s1, int s2) {
  return v + (v >> s1) + (s2 != 0 ? v >> s2 : W(0));
}

// The four radix-4 selection thresholds of one divisor, unpacked.
struct Thresholds {
  int m2, m1, m0, mm1;
};

// How a radix-4 plan picks its digit from the estimate: down a compare
// ladder (K2-K10; K11 at four elements a thread), or by counting the
// thresholds the estimate reaches (K11 at one element a thread): the
// thresholds fall strictly (m2 > m1 > m0 > mm1), so the count less 2 is the
// ladder's digit for every estimate, with no path to branch on.  Radix 2 and
// the non-redundant plans keep their forms.
enum class Selection { ladder, count };

// Quotient-digit selection (Section III-D) on the truncated estimate, read
// from the top bits of the residual register (the reference's top word),
// against the divisor's thresholds (decided once, in prep_divisor_bits).
template <class P, Selection S = Selection::ladder>
PHD int select_digit(typename P::Word rws, typename P::Word rwc, const Thresholds& m) {
  using W = typename P::Word;
  constexpr int top = 32 * P::words - 1;
  if (P::nonrestoring) return ((rws >> top) & W(1)) != W(0) ? -1 : 1;
  constexpr int tb = 3 + P::gbits;
  constexpr int sh = 32 * P::words - 3 - P::gbits;
  const uint32_t t = static_cast<uint32_t>((rws >> sh) + (rwc >> sh)) & ((1u << tb) - 1u);
  const int est = static_cast<int>(t) - (((t >> (tb - 1)) & 1u) ? (1 << tb) : 0);
  if (!P::redundant) return est >= 1 ? 1 : (est >= -1 ? 0 : -1);   // Eq 26
  if (P::radix == 2) return est >= 0 ? 1 : (est == -1 ? 0 : -1);   // Eq 27
  if constexpr (S == Selection::count) {
    if (P::scaled)  // Eq 29, immediates
      return (est >= kScaledM2) + (est >= kScaledM1) + (est >= kScaledM0) +
             (est >= kScaledMM1) - 2;
    return (est >= m.m2) + (est >= m.m1) + (est >= m.m0) + (est >= m.mm1) - 2;
  }
  if (P::scaled)  // Eq 29, immediates
    return est >= kScaledM2 ? 2 : est >= kScaledM1 ? 1 : est >= kScaledM0 ? 0
         : est >= kScaledMM1 ? -1 : -2;
  return est >= m.m2 ? 2 : est >= m.m1 ? 1 : est >= m.m0 ? 0 : est >= m.mm1 ? -1 : -2;
}

// Divisor-side work, done once per row by the rowwise kernels (once per
// element by the elementwise ones).  W is the plan's residual word.  Every
// quantity the recurrence reads of the divisor is here, so no iteration
// looks anything up by the divisor's interval: the radix-4 plans' four
// selection thresholds (Eq 28 by interval, Eq 29's constants for the scaled
// plan) as signed bytes, m2 lowest, and the scaled plans' shifts s1 | s2 <<
// 8.  32 bytes at W = 1, 48 at W = 2 (the bytes fill what was padding).
template <class W>
struct DivisorT {
  W d_al, nd_al, d2, nd2;
  int thr;
  int shifts;
  int scale;
  bool sign, zero, nar;
};
using Divisor = DivisorT<uint32_t>;
template <class P>
using DivisorOf = DivisorT<typename P::Word>;

template <class W>
PHD Thresholds thresholds(const DivisorT<W>& d) {
  return {static_cast<int8_t>(d.thr), static_cast<int8_t>(d.thr >> 8),
          static_cast<int8_t>(d.thr >> 16), static_cast<int8_t>(d.thr >> 24)};
}

// The plans the model-path kernels instantiate (flash attention K3-K8 in
// every layout, softmax K9): every planned row of posit8, posit16, posit32
// and posit64 (posit32 srt_r4_scaled and posit64 on the two-word frame).
// posit10's rows are K11's alone.  Mirrored by kernels/posit_flash_attn.py
// kernel_built.
template <class P>
constexpr bool kModelPlan = P::n == 8 || P::n == 16 || P::n == 32 || P::n == 64;

// The library of its format a model plan is built into: posit64's six
// datapaths are cut three ways, 0 radix 4 (srt_r4_cs, srt_r4_cs_of), 1 radix
// 2 non-redundant (nrd, srt_r2), 2 radix 2 carry-save (srt_r2_cs,
// srt_r2_cs_of): a radix-2 row unrolls 62 two-word iterations, so one
// translation unit of all six would set the whole build's length.  Every
// other format is one library (part 0).  Mirrored by kernels/_build.py
// part_of.
template <class P>
constexpr int kLibraryPart = P::n != 64 || P::radix == 4 ? 0 : P::redundant ? 2 : 1;

// The model plans one library instantiates.  kernels/_build.py builds the
// flash sources once per format and part, all at once, with
// -DPOSIT_MODEL_N=<n> -DPOSIT_MODEL_PART=<part>: such a library holds those
// plans only (one translation unit with every format's would build for
// minutes on one core).  Without the macros (K9), every model plan.
template <class P>
constexpr bool kLibraryPlan = kModelPlan<P>
#ifdef POSIT_MODEL_N
                              && P::n == POSIT_MODEL_N
#endif
#ifdef POSIT_MODEL_PART
                              && kLibraryPart<P> == POSIT_MODEL_PART
#endif
    ;

// The divisor from its posit pattern (K11); the float entry points quantize
// first.
template <class P>
PHD DivisorOf<P> prep_divisor_bits(typename P::Pat pd) {
  using W = typename P::Word;
  DivisorOf<P> d;
  const auto dd = decode<P::n>(pd);
  int didx;  // the divisor's interval: the 3 fraction bits below the hidden bit
  if constexpr (P::frac >= 4) didx = static_cast<int>((dd.sig >> (P::frac - 4)) & 7u);
  else didx = static_cast<int>((dd.sig << (4 - P::frac)) & 7u);
  d.thr = 0;
  if (P::radix == 4 && P::redundant) {
    const Thresholds m =
        P::scaled ? Thresholds{kScaledM2, kScaledM1, kScaledM0, kScaledMM1}
                  : Thresholds{entry8(kRadix4M2, didx), entry8(kRadix4M1, didx),
                               entry8(kRadix4M0, didx), entry8(kRadix4MM1, didx)};
    d.thr = static_cast<int>(uint32_t(uint8_t(m.m2)) | uint32_t(uint8_t(m.m1)) << 8 |
                             uint32_t(uint8_t(m.m0)) << 16 | uint32_t(uint8_t(m.mm1)) << 24);
  }
  const int s1 = entry8(kScaleS1, didx), s2 = entry8(kScaleS2, didx);
  d.shifts = P::scaled ? s1 | s2 << 8 : 0;
  W d_al = static_cast<W>(dd.sig) << P::shift;
  if (P::scaled) d_al = scale_operand(d_al, s1, s2);
  d.d_al = d_al;
  d.nd_al = ~d_al;
  d.d2 = d_al << 1;
  d.nd2 = ~(d_al << 1);
  d.scale = dd.scale;
  d.sign = dd.sign;
  d.zero = dd.zero;
  d.nar = dd.nar;
  return d;
}

// prep_divisor_bits on the divisor's fields (K2, K10: float_to_fields').
// The two stay separate texts: K3-K9 and K11 reach prep_divisor_bits, and
// routing it through this function changed K7's SASS.
template <class P>
PHD DivisorOf<P> prep_divisor_fields(const FieldsT<typename P::Pat>& dd) {
  using W = typename P::Word;
  DivisorOf<P> d;
  int didx;  // the divisor's interval: the 3 fraction bits below the hidden bit
  if constexpr (P::frac >= 4) didx = static_cast<int>((dd.sig >> (P::frac - 4)) & 7u);
  else didx = static_cast<int>((dd.sig << (4 - P::frac)) & 7u);
  d.thr = 0;
  if (P::radix == 4 && P::redundant) {
    const Thresholds m =
        P::scaled ? Thresholds{kScaledM2, kScaledM1, kScaledM0, kScaledMM1}
                  : Thresholds{entry8(kRadix4M2, didx), entry8(kRadix4M1, didx),
                               entry8(kRadix4M0, didx), entry8(kRadix4MM1, didx)};
    d.thr = static_cast<int>(uint32_t(uint8_t(m.m2)) | uint32_t(uint8_t(m.m1)) << 8 |
                             uint32_t(uint8_t(m.m0)) << 16 | uint32_t(uint8_t(m.mm1)) << 24);
  }
  const int s1 = entry8(kScaleS1, didx), s2 = entry8(kScaleS2, didx);
  d.shifts = P::scaled ? s1 | s2 << 8 : 0;
  W d_al = static_cast<W>(dd.sig) << P::shift;
  if (P::scaled) d_al = scale_operand(d_al, s1, s2);
  d.d_al = d_al;
  d.nd_al = ~d_al;
  d.d2 = d_al << 1;
  d.nd2 = ~(d_al << 1);
  d.scale = dd.scale;
  d.sign = dd.sign;
  d.zero = dd.zero;
  d.nar = dd.nar;
  return d;
}

template <class P>
PHD DivisorOf<P> prep_divisor(float b) {
  return prep_divisor_bits<P>(float_to_posit<P::n>(b));
}

template <class P>
PHD typename P::Word addend(int digit, const DivisorOf<P>& d) {
  using W = typename P::Word;
  W a = digit == 1 ? d.nd_al : (digit == -1 ? d.d_al : W(0));
  if (P::radix == 4) a = digit == 2 ? d.nd2 : (digit == -2 ? d.d2 : a);
  return a;
}

// On-the-fly conversion step (Eqs 18-19).
template <int R, class Q>
PHD void otf_step(Q& Qr, Q& QD, int digit) {
  constexpr int lr = R == 2 ? 1 : 2;
  const bool neg = digit < 0, pos = digit > 0;
  const int mag = digit < 0 ? -digit : digit;
  const Q Qs = Qr << lr, QDs = QD << lr;
  const Q q_app = static_cast<Q>(neg ? R - mag : mag);
  const Q qd_app = static_cast<Q>(pos ? mag - 1 : (R - 1) - mag);
  Qr = (neg ? QDs : Qs) | q_app;
  QD = (pos ? Qs : QDs) | qd_app;
}

// Non-OTF accumulation q <- r*q + digit.
template <int R, class Q>
PHD Q plain_q(Q Qr, int digit) {
  constexpr int lr = R == 2 ? 1 : 2;
  const Q mag = static_cast<Q>(digit < 0 ? -digit : digit);
  const bool neg = digit < 0;
  return (Qr << lr) + (neg ? ~mag : mag) + (neg ? Q(1) : Q(0));
}

template <class U>
struct QuotientFields {
  U frac;
  int t_adj;
  uint32_t round_bit;
  bool sticky;
};

// posit_div.py _divide_fields: the recurrence on significands, on one
// residual register per carry-save word (uint32_t at W = 1, uint64_t at
// W = 2) and a quotient register pair of the plan's width.
template <class P, Selection S = Selection::ladder>
PHD QuotientFields<typename P::Pat> divide_fields(typename P::Pat xsig, const DivisorOf<P>& d) {
  using W = typename P::Word;
  using Q = typename P::QWord;
  using U = typename P::Pat;
  constexpr int R = P::radix, LR = P::lr, FP = P::fp, F = P::F;
  constexpr int top = 32 * P::words - 1;
  const Thresholds m = thresholds(d);  // unpacked once a divide
  W x_al = static_cast<W>(xsig) << P::shift;
  if (P::scaled) x_al = scale_operand(x_al, d.shifts & 0xFF, d.shifts >> 8);

  // Iteration 1 folded: y_1 = r*w(0) = x exactly.
  int digit = select_digit<P, S>(x_al, W(0), m);
  W a = addend<P>(digit, d);
  W cin = digit > 0 ? W(1) : W(0);
  W ws, wc;
  if (P::redundant) {
    wc = ((x_al & a) << 1) | cin;
    ws = x_al ^ a;
  } else {
    ws = x_al + a + cin;
    wc = W(0);
  }
  Q Qr = 0, QD = 0;
  if (P::otf) otf_step<R>(Qr, QD, digit);
  else Qr = plain_q<R>(Q(0), digit);

#pragma unroll
  for (int i = 0; i < P::iterations - 1; ++i) {
    const W rws = ws << LR;
    if (P::redundant) {
      const W rwc = wc << LR;
      digit = select_digit<P, S>(rws, rwc, m);
      a = addend<P>(digit, d);
      cin = digit > 0 ? W(1) : W(0);
      ws = rws ^ rwc ^ a;
      wc = (((rws & rwc) | (rws & a) | (rwc & a)) << 1) | cin;
    } else {
      digit = select_digit<P, S>(rws, W(0), m);
      a = addend<P>(digit, d);
      cin = digit > 0 ? W(1) : W(0);
      ws = rws + a + cin;
    }
    if (P::otf) otf_step<R>(Qr, QD, digit);
    else Qr = plain_q<R>(Qr, digit);
  }

  // Termination: sign/zero of the final residual.
  const W wfull = P::redundant ? ws + wc : ws;
  const bool neg = ((wfull >> top) & W(1)) != W(0);
  if (!P::otf) QD = Qr - Q(1);
  const Q qf = neg ? QD : Qr;
  const W rem = neg ? wfull + d.d_al : wfull;

  QuotientFields<U> q;
  const bool intbit = ((qf >> FP) & Q(1)) != Q(0);
  const Q qn = intbit ? qf : (qf << 1);
  q.t_adj = intbit ? 0 : -1;
  q.frac = static_cast<U>((qn >> (FP - F)) & ((Q(1) << F) - Q(1)));
  q.round_bit = static_cast<uint32_t>((qn >> (FP - F - 1)) & Q(1));
  constexpr int low = FP - F - 1;
  bool low_nz = false;
  if constexpr (low > 0) low_nz = (qn & ((Q(1) << low) - Q(1))) != Q(0);
  q.sticky = low_nz || rem != W(0);
  return q;
}

// posit_div.py _divide_block for one element: the quotient's pattern from
// the dividend's pattern and a prepared divisor.
template <class P, Selection S = Selection::ladder>
PHD typename P::Pat divide_bits(typename P::Pat px, const DivisorOf<P>& d) {
  const auto dx = decode<P::n>(px);
  const auto q = divide_fields<P, S>(dx.sig, d);
  const bool out_nar = dx.nar || d.nar || d.zero;
  const bool out_zero = dx.zero && !out_nar;
  return encode<P::n>(dx.sign != d.sign, dx.scale - d.scale + q.t_adj, q.frac, q.round_bit,
                      q.sticky, out_zero, out_nar);
}

// K11's element: the quotient's pattern from the two patterns, the divisor
// prepared for this element alone, the digit selected as S says.
template <class P, Selection S = Selection::count>
PHD typename P::Pat divide_patterns(typename P::Pat px, typename P::Pat pd) {
  return divide_bits<P, S>(px, prep_divisor_bits<P>(pd));
}

// posit_div.py divide_floats_block for one element against a prepared
// divisor: quantize -> SRT divide -> encode -> dequantize.
template <class P>
PHD float divide_float(float a, const DivisorOf<P>& d) {
  return posit_to_float<P::n>(divide_bits<P>(float_to_posit<P::n>(a), d));
}

// posit_to_float<N>(encode<N>(sign, scale, q.frac, q.round_bit, q.sticky,
// zero, nar)) with no pattern built: the posit rounding on fields, then the
// f32.
template <int N>
PHD float quotient_to_float(bool sign, int scale, const QuotientFields<typename Fmt<N>::U>& q,
                            bool zero, bool nar) {
  using U = typename Fmt<N>::U;
  constexpr int F = Fmt<N>::F;
  const U sig = (U(1) << (F + 1)) | (q.frac << 1) | U(q.round_bit & 1u);
  const auto r = round_fields<N, F + 1>(sign, scale, sig, q.sticky);
  // the conversion is posit_to_float's rounding of the significand to 24
  // bits (RNE; posit64's G/R/S), exact for posit8 and posit16
  const float m = static_cast<float>(r.sig);
  float val;
  if constexpr (N > 32) {
    float mag = ldexp_f32(m, r.scale - F);
    if (mag < 1.17549435e-38f) mag = 0.0f;  // 2^-126
    val = sign ? -mag : mag;
  } else {  // 2^-120 <= |value| < 2^121: the scale goes straight into the exponent
    val = u2f((f2u(m) + (static_cast<uint32_t>(r.scale - F) << 23)) |
              (sign ? 0x80000000u : 0u));
  }
  if (zero) val = 0.0f;
  if (nar) val = u2f(0x7FC00000u);  // the canonical quiet NaN
  return val;
}

// divide_float's f32 quotient from the dividend's fields (float_to_fields)
// and a prepared divisor: K2's and K10's element.
template <class P>
PHD float divide_to_float(const FieldsT<typename P::Pat>& dx, const DivisorOf<P>& d) {
  const auto q = divide_fields<P>(dx.sig, d);
  const bool out_nar = dx.nar || d.nar || d.zero;
  const bool out_zero = dx.zero && !out_nar;
  return quotient_to_float<P::n>(dx.sign != d.sign, dx.scale - d.scale + q.t_adj, q, out_zero,
                                 out_nar);
}

// Calls f(P{}) with the Plan type matching the runtime plan fields; false
// when the table in posit_plans.inc has no such row.  kPosit10 adds the
// posit10 rows of posit10_plans.inc, which only K11 (posit_div.cu) builds:
// the other kernels keep their instantiations.
template <bool kPosit10 = false, class Fn>
bool dispatch_plan(int n, int radix, int red, int otf, int scaled, int nonrest, int it,
                   int shift, int gbits, Fn&& f) {
#define POSIT_PLAN(N_, R_, RED_, OTF_, SC_, NR_, IT_, SH_, G_)                          \
  if (n == N_ && radix == R_ && red == RED_ && otf == OTF_ && scaled == SC_ &&         \
      nonrest == NR_ && it == IT_ && shift == SH_ && gbits == G_) {                     \
    f(Plan<N_, R_, RED_ != 0, OTF_ != 0, SC_ != 0, NR_ != 0, IT_, SH_, G_>{});          \
    return true;                                                                        \
  }
#include "posit_plans.inc"
  if constexpr (kPosit10) {
#include "posit10_plans.inc"
  }
#undef POSIT_PLAN
  return false;
}

}  // namespace posit
