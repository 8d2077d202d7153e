// K1: the posit SRT digit-recurrence datapath as device functions.
//
// Replaces the reference's datapath body in src/repro/kernels/posit_div.py
// (_divide_fields :433, _divide_block :549, divide_floats_block :609), which
// every Pallas kernel composes.  Here it is a set of __host__ __device__
// functions on 32-bit registers that K2 (posit_fused_div.cu) and K3
// (posit_flash_attn.cu) inline; the same header compiles as host C++ so the
// arithmetic can be checked without a card.
//
// Scope: every ONE-WORD plan (W = 1; posit8/16 x all nine Table IV rows,
// posit32 x the eight unscaled rows).  The plan's static fields are template
// parameters (Plan<...>), so each row compiles to straight-line register
// code with its loop trip count known.
//
// Bit-exactness rules kept from the reference:
//   * logical shifts on uint32_t, arithmetic ones on int32_t; every variable
//     shift is guarded (a shift by >= 32 gives 0, as in posit.py:102-115);
//   * f32 inputs are classified by their bit fields, never by float compares;
//   * 2^e is built from two normal factors (ldexp_f32), never one exp2f;
//   * nothing here may be built with --use_fast_math or -ftz=true.
//
// Cost: the recurrence is integer ALU work, ~10-20 ops per iteration and
// 8 iterations for posit16 radix-4; the kernels that use it are bound by
// these integer operations, not by memory (see PERF.md).
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

PHD int clz32(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __clz(static_cast<int>(x));  // 32 for x == 0
#else
  return x ? __builtin_clz(x) : 32;
#endif
}

// Guarded variable shifts: any amount outside [0, 32) gives 0.
PHD uint32_t shl(uint32_t x, int s) { return (s < 0 || s >= 32) ? 0u : (x << s); }
PHD uint32_t shr(uint32_t x, int s) { return (s < 0 || s >= 32) ? 0u : (x >> s); }

// floor(e / 2) without relying on the shift of a negative int.
PHD int floor_half(int e) { return e >= 0 ? e / 2 : -((1 - e) / 2); }

PHD int imax(int a, int b) { return a > b ? a : b; }
PHD int imin(int a, int b) { return a < b ? a : b; }

// ---------------------------------------------------------------- format

template <int N>
struct Fmt {
  static constexpr int n = N;
  static constexpr int es = 2;
  static constexpr int F = N - 3 - es;
  static constexpr uint32_t mask = N == 32 ? 0xFFFFFFFFu : ((1u << N) - 1u);
  static constexpr uint32_t nar = 1u << (N - 1);
  static constexpr uint32_t maxpos_body = (1u << (N - 1)) - 1u;
};

struct Fields {
  bool sign;
  int scale;
  uint32_t sig;
  bool zero;
  bool nar;
};

// posit.py posit_decode
template <int N>
PHD Fields decode(uint32_t p) {
  using Fm = Fmt<N>;
  Fields d;
  p &= Fm::mask;
  d.zero = p == 0u;
  d.nar = p == Fm::nar;
  d.sign = ((p >> (N - 1)) & 1u) != 0u;
  const uint32_t mag = d.sign ? ((~p + 1u) & Fm::mask) : p;
  const uint32_t body = mag << (32 - (N - 1));
  const bool r0 = (body >> 31) != 0u;
  const uint32_t inv = r0 ? ~body : body;
  const int run = imin(clz32(inv), N - 1);
  const int k = r0 ? run - 1 : -run;
  const uint32_t tail = shl(body, run + 1);
  const int e = static_cast<int>(tail >> (32 - Fm::es));
  const uint32_t frac_tail = tail << Fm::es;
  const uint32_t frac = Fm::F > 0 ? (frac_tail >> (32 - Fm::F)) : 0u;
  d.scale = k * (1 << Fm::es) + e;
  d.sig = (1u << Fm::F) | frac;
  return d;
}

// posit.py posit_encode (RNE with the deep-regime rule, saturating)
template <int N>
PHD uint32_t encode(bool sign, int scale, uint32_t frac, uint32_t round_bit,
                    bool sticky, bool is_zero, bool is_nar) {
  using Fm = Fmt<N>;
  constexpr int n = N, es = Fm::es, F = Fm::F;
  round_bit &= 1u;
  const int k = floor_half(floor_half(scale));  // scale >> 2 (es == 2)
  const uint32_t e = static_cast<uint32_t>(scale) & ((1u << es) - 1u);
  const bool over = k > n - 2;
  const bool under = k < -(n - 2);
  const int kc = imax(-(n - 2), imin(k, n - 2));
  const bool pos = kc >= 0;
  const int l = pos ? kc + 1 : -kc;
  const int rlen = l + 1;
  const uint32_t rpat = pos ? (shl(1u, l + 1) - 2u) : 1u;
  const uint32_t eg = (e << F) | frac;
  constexpr int egw = F + es;
  const int m = (n - 1) - rlen;
  const int m_pos = imax(m, 0);
  const int discard = egw - m_pos;
  const uint32_t kept = shr(eg, discard);
  const uint32_t g_from_eg = shr(eg, imax(discard - 1, 0)) & 1u;
  const uint32_t guard = discard > 0 ? g_from_eg : round_bit;
  const uint32_t below_mask = shl(1u, imax(discard - 1, 0)) - 1u;
  const bool st_eg = (eg & below_mask) != 0u;
  const bool sticky_full = discard > 0 ? (st_eg || round_bit != 0u || sticky) : sticky;
  const bool trunc_regime = m < 0;
  const uint32_t body_base = trunc_regime ? (rpat >> 1) : (shl(rpat, m_pos) | kept);
  const uint32_t lsb = body_base & 1u;
  uint32_t inc = guard & ((sticky_full ? 1u : 0u) | lsb);
  if constexpr (es == 2 && F >= 2) {
    const int c = discard - F;
    const uint32_t f_ext = (frac << 2) | (round_bit << 1) | (sticky ? 1u : 0u);
    const uint32_t thr = c == 1 ? (1u << F) : (1u << (F - 2));
    const bool e_cond = c == 1 ? ((e & 1u) == 1u) : ((e & 3u) == 3u);
    const bool deep_up = e_cond && (f_ext > thr || (f_ext == thr && lsb == 1u));
    if (c >= 1 && m >= 0) inc = deep_up ? 1u : 0u;
  }
  if (trunc_regime) inc = 0u;
  uint32_t body = body_base + inc;
  if (over) body = Fm::maxpos_body;
  if (under) body = 1u;
  if (body < 1u) body = 1u;
  if (body > Fm::maxpos_body) body = Fm::maxpos_body;
  uint32_t p = sign ? ((~body + 1u) & Fm::mask) : body;
  if (is_zero) p = 0u;
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
  const int blen = 32 - clz32(mant);
  f.scale = is_sub ? blen - 150 : exp_f - 127;
  f.ti = is_sub ? shl(mant, 25 - blen) : (((1u << 23) | mant) << 1);
  return f;
}

// posit.py float_to_posit
template <int N>
PHD uint32_t float_to_posit(float x) {
  constexpr int F = Fmt<N>::F;
  constexpr int keep = F + 1;
  constexpr int drop = 25 - keep;
  const FloatFields f = float_decompose(x);
  uint32_t frac, round_bit;
  bool sticky;
  if constexpr (drop >= 1) {
    frac = (f.ti >> drop) & ((1u << F) - 1u);
    round_bit = (f.ti >> (drop - 1)) & 1u;
    sticky = (f.ti & ((1u << (drop - 1)) - 1u)) != 0u;
  } else {  // F >= 24 (posit32 from f32): nothing is cut
    frac = (f.ti << (keep - 25)) & ((1u << F) - 1u);
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

// posit.py posit_to_float
template <int N>
PHD float posit_to_float(uint32_t p) {
  const Fields d = decode<N>(p);
  const float sigf = ldexp_f32(static_cast<float>(d.sig), d.scale - Fmt<N>::F);
  float val = d.sign ? -sigf : sigf;
  if (d.zero) val = 0.0f;
  if (d.nar) val = u2f(0x7FC00000u);  // the canonical quiet NaN
  return val;
}

// ---------------------------------------------------------------- plan

// One row of kernel_datapath_plan with W = 1 (kernels/posit_div.py).
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
  static_assert(SHIFT >= 1 && SHIFT < 32, "one-word plan");
  static_assert(fp + 2 <= 32, "one-word quotient register");
};

// 8-entry lookup as a compare ladder (no memory).
PHD int lut8(int i, int t0, int t1, int t2, int t3, int t4, int t5, int t6, int t7) {
  return i == 0 ? t0 : i == 1 ? t1 : i == 2 ? t2 : i == 3 ? t3
       : i == 4 ? t4 : i == 5 ? t5 : i == 6 ? t6 : t7;
}

// seltables.py SCALING_SHIFTS: M*v = v + (v >> s1) + (v >> s2)
PHD uint32_t scale_operand(uint32_t v, int didx) {
  const uint32_t c1 = v >> 1, c2 = v >> 2, c3 = v >> 3;
  const int s1 = lut8(didx, 1, 2, 1, 1, 2, 2, 3, 3);
  const int s2 = lut8(didx, 1, 1, 3, 0, 3, 0, 0, 0);
  const uint32_t t1 = s1 == 1 ? c1 : (s1 == 2 ? c2 : c3);
  const uint32_t t2 = s2 == 1 ? c1 : (s2 == 3 ? c3 : 0u);
  return v + t1 + t2;
}

// Quotient-digit selection (Section III-D) on the truncated estimate.
template <class P>
PHD int select_digit(uint32_t rws, uint32_t rwc, int didx) {
  if (P::nonrestoring) return static_cast<int32_t>(rws) < 0 ? -1 : 1;
  constexpr int tb = 3 + P::gbits;
  constexpr int sh = 29 - P::gbits;
  const uint32_t t = ((rws >> sh) + (rwc >> sh)) & ((1u << tb) - 1u);
  const int est = static_cast<int>(t) - (((t >> (tb - 1)) & 1u) ? (1 << tb) : 0);
  if (!P::redundant) return est >= 1 ? 1 : (est >= -1 ? 0 : -1);   // Eq 26
  if (P::radix == 2) return est >= 0 ? 1 : (est == -1 ? 0 : -1);   // Eq 27
  int m2, m1, m0, mm1;
  if (P::scaled) {  // Eq 29, divisor-independent
    m2 = 12; m1 = 4; m0 = -4; mm1 = -13;
  } else {          // Eq 28, seltables.RADIX4_* by divisor interval
    m2 = lut8(didx, 12, 14, 15, 16, 18, 19, 20, 22);
    m1 = lut8(didx, 3, 4, 4, 4, 5, 5, 5, 6);
    m0 = lut8(didx, -5, -6, -6, -7, -8, -8, -9, -10);
    mm1 = lut8(didx, -13, -15, -16, -18, -20, -21, -23, -25);
  }
  return est >= m2 ? 2 : est >= m1 ? 1 : est >= m0 ? 0 : est >= mm1 ? -1 : -2;
}

// Divisor-side work, done once per row by the rowwise kernels.
struct Divisor {
  uint32_t d_al, nd_al, d2, nd2;
  int didx;
  int scale;
  bool sign, zero, nar;
};

template <class P>
PHD Divisor prep_divisor(float b) {
  Divisor d;
  const Fields dd = decode<P::n>(float_to_posit<P::n>(b));
  if constexpr (P::frac >= 4) d.didx = static_cast<int>((dd.sig >> (P::frac - 4)) & 7u);
  else d.didx = static_cast<int>((dd.sig << (4 - P::frac)) & 7u);
  uint32_t d_al = dd.sig << P::shift;
  if (P::scaled) d_al = scale_operand(d_al, d.didx);
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
PHD uint32_t addend(int digit, const Divisor& d) {
  uint32_t a = digit == 1 ? d.nd_al : (digit == -1 ? d.d_al : 0u);
  if (P::radix == 4) a = digit == 2 ? d.nd2 : (digit == -2 ? d.d2 : a);
  return a;
}

// On-the-fly conversion step (Eqs 18-19).
template <int R>
PHD void otf_step(uint32_t& Q, uint32_t& QD, int digit) {
  constexpr int lr = R == 2 ? 1 : 2;
  const bool neg = digit < 0, pos = digit > 0;
  const int mag = digit < 0 ? -digit : digit;
  const uint32_t Qs = Q << lr, QDs = QD << lr;
  const uint32_t q_app = static_cast<uint32_t>(neg ? R - mag : mag);
  const uint32_t qd_app = static_cast<uint32_t>(pos ? mag - 1 : (R - 1) - mag);
  Q = (neg ? QDs : Qs) | q_app;
  QD = (pos ? Qs : QDs) | qd_app;
}

// Non-OTF accumulation q <- r*q + digit.
template <int R>
PHD uint32_t plain_q(uint32_t Q, int digit) {
  constexpr int lr = R == 2 ? 1 : 2;
  const uint32_t mag = static_cast<uint32_t>(digit < 0 ? -digit : digit);
  const bool neg = digit < 0;
  return (Q << lr) + (neg ? ~mag : mag) + (neg ? 1u : 0u);
}

struct QuotientFields {
  uint32_t frac;
  int t_adj;
  uint32_t round_bit;
  bool sticky;
};

// posit_div.py _divide_fields, W = 1: the recurrence on significands.
template <class P>
PHD QuotientFields divide_fields(uint32_t xsig, const Divisor& d) {
  constexpr int R = P::radix, LR = P::lr, FP = P::fp, F = P::F;
  uint32_t x_al = xsig << P::shift;
  if (P::scaled) x_al = scale_operand(x_al, d.didx);

  // Iteration 1 folded: y_1 = r*w(0) = x exactly.
  int digit = select_digit<P>(x_al, 0u, d.didx);
  uint32_t a = addend<P>(digit, d);
  uint32_t cin = digit > 0 ? 1u : 0u;
  uint32_t ws, wc;
  if (P::redundant) {
    wc = ((x_al & a) << 1) | cin;
    ws = x_al ^ a;
  } else {
    ws = x_al + a + cin;
    wc = 0u;
  }
  uint32_t Q = 0u, QD = 0u;
  if (P::otf) otf_step<R>(Q, QD, digit);
  else Q = plain_q<R>(0u, digit);

#pragma unroll
  for (int i = 0; i < P::iterations - 1; ++i) {
    const uint32_t rws = ws << LR;
    if (P::redundant) {
      const uint32_t rwc = wc << LR;
      digit = select_digit<P>(rws, rwc, d.didx);
      a = addend<P>(digit, d);
      cin = digit > 0 ? 1u : 0u;
      ws = rws ^ rwc ^ a;
      wc = (((rws & rwc) | (rws & a) | (rwc & a)) << 1) | cin;
    } else {
      digit = select_digit<P>(rws, 0u, d.didx);
      a = addend<P>(digit, d);
      cin = digit > 0 ? 1u : 0u;
      ws = rws + a + cin;
    }
    if (P::otf) otf_step<R>(Q, QD, digit);
    else Q = plain_q<R>(Q, digit);
  }

  // Termination: sign/zero of the final residual.
  const uint32_t wfull = P::redundant ? ws + wc : ws;
  const bool neg = static_cast<int32_t>(wfull) < 0;
  if (!P::otf) QD = Q - 1u;
  const uint32_t qf = neg ? QD : Q;
  const uint32_t rem = neg ? wfull + d.d_al : wfull;

  QuotientFields q;
  const bool intbit = ((qf >> FP) & 1u) != 0u;
  const uint32_t qn = intbit ? qf : (qf << 1);
  q.t_adj = intbit ? 0 : -1;
  q.frac = (qn >> (FP - F)) & ((1u << F) - 1u);
  q.round_bit = (qn >> (FP - F - 1)) & 1u;
  constexpr int low = FP - F - 1;
  bool low_nz = false;
  if constexpr (low > 0) low_nz = (qn & ((1u << low) - 1u)) != 0u;
  q.sticky = low_nz || rem != 0u;
  return q;
}

// posit_div.py divide_floats_block for one element against a prepared
// per-row divisor: quantize -> SRT divide -> encode -> dequantize.
template <class P>
PHD float divide_float(float a, const Divisor& d) {
  const Fields dx = decode<P::n>(float_to_posit<P::n>(a));
  const QuotientFields q = divide_fields<P>(dx.sig, d);
  const bool out_nar = dx.nar || d.nar || d.zero;
  const bool out_zero = dx.zero && !out_nar;
  const uint32_t p = encode<P::n>(dx.sign != d.sign, dx.scale - d.scale + q.t_adj, q.frac,
                                  q.round_bit, q.sticky, out_zero, out_nar);
  return posit_to_float<P::n>(p);
}

// Calls f(P{}) with the Plan type matching the runtime plan fields; false
// when the table in posit_plans.inc has no such row.
template <class Fn>
bool dispatch_plan(int n, int radix, int red, int otf, int scaled, int nonrest, int it,
                   int shift, int gbits, Fn&& f) {
#define POSIT_PLAN(N_, R_, RED_, OTF_, SC_, NR_, IT_, SH_, G_)                          \
  if (n == N_ && radix == R_ && red == RED_ && otf == OTF_ && scaled == SC_ &&         \
      nonrest == NR_ && it == IT_ && shift == SH_ && gbits == G_) {                     \
    f(Plan<N_, R_, RED_ != 0, OTF_ != 0, SC_ != 0, NR_ != 0, IT_, SH_, G_>{});          \
    return true;                                                                        \
  }
#include "posit_plans.inc"
#undef POSIT_PLAN
  return false;
}

}  // namespace posit
