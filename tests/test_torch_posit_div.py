"""The port's SRT datapath plan and plain twin against the reference.

* plans: every field and every error string equal, 9 variants x posit8/16/
  32/64, and the CUDA plan table (csrc/posit_plans.inc) equal to the plan;
* the twin is bit-exact against the reference's ``_divide_block`` (posit8
  exhaustive for all 9 variants, posit16/32 sampled for every one-word plan
  with the NaR/zero/minpos/maxpos edges, posit32 ``srt_r4_scaled``'s
  two-word residual against ``_divide_block`` and ``core.divider``) and
  ``divide_floats_block`` (a (rows, 1) divisor, the special float values;
  every two-word plan, posit64's eight included);
* the CUDA datapath header (K1), compiled as host C++, is bit-exact against
  the twin: as K2 (a per-row divisor), K10 (a divisor per element), K11 (on
  patterns, posit10's rows included) and K12 (the casts, posit64's too) use
  it, at W = 1 and W = 2.
"""

import ctypes
import importlib
import re
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import bits, one_torch_thread  # noqa: F401  (fixture)
from repro.core.posit import PositFormat as JFmt
from repro_torch.core.posit import PositFormat
from repro_torch.kernels import posit_div as TD
from repro_torch.kernels.ops import plan_args

pytestmark = pytest.mark.usefixtures("one_torch_thread")

JD = importlib.import_module("repro.kernels.posit_div")
RNG = np.random.default_rng(7)
VARIANTS = TD.KERNEL_VARIANTS
ONE_WORD = [(f.n, v) for f, v, _ in TD.one_word_pairs()]
INC = TD.__file__.replace("posit_div.py", "csrc/posit_plans.inc")
INC10 = INC.replace("posit_plans.inc", "posit10_plans.inc")
SPECIALS = np.array([1.5, -2.25, 0.0, -0.0, np.inf, -np.inf, np.nan, 1e30,
                     -1e-30, 3.0, 1e-45, -3e-39], np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("n", [8, 16, 32, 64])
@pytest.mark.parametrize("variant", VARIANTS)
def test_plan_and_error_match_reference(n, variant):
    jp = JD.kernel_datapath_plan(JFmt(n), variant)
    tp = TD.kernel_datapath_plan(PositFormat(n), variant)
    assert (jp is None) == (tp is None)
    if jp is not None:
        assert dataclass_fields(jp) == dataclass_fields(tp)
    assert JD.kernel_plan_error(JFmt(n), variant) == TD.kernel_plan_error(
        PositFormat(n), variant)


def dataclass_fields(plan):
    return {k: getattr(plan, k) for k in plan.__dataclass_fields__}


def test_unknown_variant_error_matches_reference():
    assert JD.kernel_plan_error(JFmt(16), "bogus") == TD.kernel_plan_error(
        PositFormat(16), "bogus")
    with pytest.raises(ValueError, match="unknown divider variant"):
        TD.datapath_plan(PositFormat(16), "bogus")


def test_cuda_plan_table_matches_plan():
    rows = re.findall(r"^POSIT_PLAN\(([^)]*)\)", open(INC).read(), re.M)
    table = [tuple(int(x) for x in r.split(",")) for r in rows]
    assert table == [plan_args(p) for _, _, p in TD.planned_pairs()]
    assert len(table) == 35


def test_cuda_posit10_plan_table_matches_plan():
    """K11's extra rows: the nine posit10 plans, in Table IV order."""
    rows = re.findall(r"^POSIT_PLAN\(([^)]*)\)", open(INC10).read(), re.M)
    table = [tuple(int(x) for x in r.split(",")) for r in rows]
    assert table == [plan_args(p) for _, _, p in TD.one_word_pairs((PositFormat(10),))]
    assert len(table) == 9


@pytest.mark.parametrize("fmt", [PositFormat(64), PositFormat(32)])
def test_two_word_plans_raise_not_implemented(fmt):
    """The two-word plans run on the twin.  The flash kernels are built for
    posit32 srt_r4_scaled and every posit64 plan in every layout; what
    stays refused is posit10 (only K11 divides it), which raises, naming
    ROADMAP.md, before any device is looked at."""
    from repro_torch.kernels import posit_flash_attn as F

    variant = "srt_r4_cs_of_fr" if fmt.n == 64 else "srt_r4_scaled"
    plan = TD.kernel_datapath_plan(fmt, variant)
    assert plan.words == 2
    q = torch.ones(1, 1, 1, 4)
    layouts = ("dense", "paged", "packed", "backward")
    plans = [p for _, _, p in TD.planned_pairs((fmt,)) if p.words == 2]
    assert plan in plans and all(F.kernel_built(p) for p in plans)
    for p in plans:
        for layout in layouts:     # past the plan check, on to the device check
            with pytest.raises(ValueError, match="device"):
                F._check_kernel_inputs(p, q, q, q, 4, layout)
    plan = TD.kernel_datapath_plan(PositFormat(10), variant)
    assert not F.kernel_built(plan)
    for layout in layouts:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            F._check_kernel_inputs(plan, q, q, q, 4, layout)
    out = TD.divide_floats_block(fmt, torch.tensor([3.0, 1.0]), torch.tensor([2.0, 0.0]),
                                 variant)
    assert out[0] == 1.5 and torch.isnan(out[1])


def _ref_block(n, variant, px, pd):
    fn = jax.jit(lambda x, d: JD._divide_block(JFmt(n), x, d, variant))
    return np.asarray(fn(jnp.asarray(px), jnp.asarray(pd))).astype(np.int64)


@pytest.mark.parametrize("variant", VARIANTS)
def test_posit8_exhaustive(variant):
    a, b = np.meshgrid(np.arange(256, dtype=np.uint32), np.arange(256, dtype=np.uint32))
    a, b = a.ravel(), b.ravel()
    got = TD._divide_block(PositFormat(8), _t(a), _t(b), variant).numpy()
    np.testing.assert_array_equal(got, _ref_block(8, variant, a, b))


def _edges(n):
    mask = (1 << n) - 1
    nar, maxpos = 1 << (n - 1), (1 << (n - 1)) - 1
    one = 1 << (n - 2)
    e = [0, nar, 1, maxpos, one, mask, mask - maxpos + 1 & mask, 2, one + 1, one - 1]
    return np.array(e, np.uint64).astype(np.uint32)


@pytest.mark.parametrize("n,variant", [p for p in ONE_WORD if p[0] > 8])
def test_sampled_one_word_plans(n, variant):
    e = _edges(n)
    ea, eb = np.meshgrid(e, e)
    a = np.concatenate([RNG.integers(0, 1 << n, 4000, dtype=np.uint64).astype(np.uint32),
                        ea.ravel()])
    b = np.concatenate([RNG.integers(0, 1 << n, 4000, dtype=np.uint64).astype(np.uint32),
                        eb.ravel()])
    got = TD._divide_block(PositFormat(n), _t(a), _t(b), variant).numpy()
    np.testing.assert_array_equal(got, _ref_block(n, variant, a, b))


@pytest.mark.parametrize("n,variant", [(16, "srt_r4_cs_of_fr"), (16, "srt_r4_scaled"),
                                       (16, "nrd"), (8, "srt_r2_cs"),
                                       (32, "srt_r4_cs_of_fr")])
def test_float_block_with_row_divisor(n, variant):
    a = (RNG.standard_normal((24, 37)) * np.exp(RNG.uniform(-20, 20, (24, 37)))).astype(np.float32)
    b = (RNG.standard_normal((24, 1)) * np.exp(RNG.uniform(-20, 20, (24, 1)))).astype(np.float32)
    a[0, :len(SPECIALS)] = SPECIALS
    b[:len(SPECIALS), 0] = SPECIALS
    ref = jax.jit(lambda x, d: JD.divide_floats_block(JFmt(n), x, d, variant))(
        jnp.asarray(a), jnp.asarray(b))
    got = TD.divide_floats_block(PositFormat(n), torch.from_numpy(a), torch.from_numpy(b),
                                 variant)
    np.testing.assert_array_equal(bits(ref), bits(got))


TWO_WORD = [(f.n, v) for f, v, _ in TD.two_word_pairs()]
WIDE_EDGES = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 3.4028235e38, -3.4028235e38,
                       1.1754944e-38, 1e-45, -1e-44, 1e30, -1e-30, 1.0, 2.0], np.float32)


def _wide_floats(shape):
    """Mixed magnitudes over the whole f32 range, the edge operands first
    (tests/test_multiword_div.py's)."""
    a = (RNG.normal(0, 1, shape) * 10.0 ** RNG.uniform(-40, 38, shape)).astype(np.float32)
    flat = a.reshape(-1)
    flat[:len(WIDE_EDGES)] = WIDE_EDGES
    return a


@pytest.mark.parametrize("n,variant", TWO_WORD)
def test_two_word_float_block_matches_reference(n, variant):
    """The W = 2 twin against the reference's divide_floats_block (plain
    jnp, no Pallas), bit for bit: a (rows, 1) divisor and an elementwise one,
    every edge operand against every other."""
    a, b = _wide_floats((40, 61)), _wide_floats((40, 1))
    e = np.tile(WIDE_EDGES, (len(WIDE_EDGES), 1))
    ref_fn = jax.jit(lambda x, d: JD.divide_floats_block(JFmt(n), x, d, variant))
    for x, d in ((a, b), (e, e.T.copy())):
        got = TD.divide_floats_block(PositFormat(n), torch.from_numpy(x), torch.from_numpy(d),
                                     variant)
        np.testing.assert_array_equal(bits(got), bits(ref_fn(jnp.asarray(x), jnp.asarray(d))))


def test_scaled_two_word_patterns_match_reference():
    """posit32 srt_r4_scaled (two-word residual, one-word patterns): the
    twin's _divide_block against the reference's and core.divider's."""
    from repro.core import divider

    e = _edges(32)
    ea, eb = np.meshgrid(e, e)
    r = RNG.integers(0, 1 << 32, (2, 4096), dtype=np.uint64).astype(np.uint32)
    px, pd = np.concatenate([r[0], ea.ravel()]), np.concatenate([r[1], eb.ravel()])
    got = TD._divide_block(PositFormat(32), _t(px), _t(pd), "srt_r4_scaled").numpy()
    np.testing.assert_array_equal(got, _ref_block(32, "srt_r4_scaled", px, pd))
    golden = divider.posit_divide(JFmt(32), jnp.asarray(px), jnp.asarray(pd), "srt_r4_scaled")
    np.testing.assert_array_equal(got, np.asarray(golden).astype(np.int64))


_HOST_HARNESS = r"""
#include "posit_srt.cuh"
extern "C" int host_model_plan(int n, int radix, int red, int otf, int scaled, int nonrest,
                               int it, int shift, int gbits) {
  int built = -1;
  posit::dispatch_plan<true>(n, radix, red, otf, scaled, nonrest, it, shift, gbits,
                             [&](auto plan) {
    built = posit::kModelPlan<decltype(plan)> ? 1 : 0;
  });
  return built;
}
extern "C" int host_library_part(int n, int radix, int red, int otf, int scaled, int nonrest,
                                 int it, int shift, int gbits) {
  int part = -1;
  posit::dispatch_plan(n, radix, red, otf, scaled, nonrest, it, shift, gbits,
                       [&](auto plan) { part = posit::kLibraryPart<decltype(plan)>; });
  return part;
}
extern "C" int host_rowwise(int n, int radix, int red, int otf, int scaled, int nonrest,
                            int it, int shift, int gbits, const float* a, const float* b,
                            float* out, int R, int C) {
  bool ok = posit::dispatch_plan(n, radix, red, otf, scaled, nonrest, it, shift, gbits,
    [&](auto plan) {
      using P = decltype(plan);
      for (int r = 0; r < R; ++r) {
        const auto d = posit::prep_divisor_fields<P>(posit::float_to_fields<P::n>(b[r]));
        for (int c = 0; c < C; ++c)
          out[r * C + c] = posit::divide_to_float<P>(posit::float_to_fields<P::n>(a[r * C + c]),
                                                     d);
      }
    });
  return ok ? 0 : -1;
}
extern "C" int host_elementwise(int n, int radix, int red, int otf, int scaled, int nonrest,
                                int it, int shift, int gbits, const float* a, const float* b,
                                float* out, int count) {
  bool ok = posit::dispatch_plan(n, radix, red, otf, scaled, nonrest, it, shift, gbits,
    [&](auto plan) {
      using P = decltype(plan);
      for (int i = 0; i < count; ++i)
        out[i] = posit::divide_to_float<P>(
            posit::float_to_fields<P::n>(a[i]),
            posit::prep_divisor_fields<P>(posit::float_to_fields<P::n>(b[i])));
    });
  return ok ? 0 : -1;
}
extern "C" int host_div_bits(int n, int radix, int red, int otf, int scaled, int nonrest,
                             int it, int shift, int gbits, const uint32_t* px,
                             const uint32_t* pd, uint32_t* out, int count) {
  bool ok = false;
  posit::dispatch_plan<true>(n, radix, red, otf, scaled, nonrest, it, shift, gbits,
    [&](auto plan) {
      using P = decltype(plan);
      if constexpr (P::n <= 32) {
        for (int i = 0; i < count; ++i)
          out[i] = posit::divide_bits<P>(px[i], posit::prep_divisor_bits<P>(pd[i]));
        ok = true;
      }
    });
  return ok ? 0 : -1;
}
extern "C" int host_divisor_fields(int n, int radix, int red, int otf, int scaled, int nonrest,
                                   int it, int shift, int gbits, float b, int* out) {
  bool same = false;
  bool ok = posit::dispatch_plan<true>(n, radix, red, otf, scaled, nonrest, it, shift, gbits,
    [&](auto plan) {
      using P = decltype(plan);
      const auto d = posit::prep_divisor<P>(b);
      const posit::Thresholds m = posit::thresholds(d);
      const int got[6] = {m.m2, m.m1, m.m0, m.mm1, d.shifts & 0xFF, d.shifts >> 8};
      for (int i = 0; i < 6; ++i) out[i] = got[i];
      // K2's and K10's divisor, from float_to_fields: the same in every field
      const auto f = posit::prep_divisor_fields<P>(posit::float_to_fields<P::n>(b));
      same = f.d_al == d.d_al && f.nd_al == d.nd_al && f.d2 == d.d2 && f.nd2 == d.nd2 &&
             f.thr == d.thr && f.shifts == d.shifts && f.scale == d.scale &&
             f.sign == d.sign && f.zero == d.zero && f.nar == d.nar;
    });
  return ok ? (same ? 0 : -2) : -1;
}
extern "C" int host_select(int n, int radix, int red, int otf, int scaled, int nonrest, int it,
                           int shift, int gbits, float b, const uint32_t* ws,
                           const uint32_t* wc, int* out, int count, int by_count) {
  bool ok = posit::dispatch_plan<true>(n, radix, red, otf, scaled, nonrest, it, shift, gbits,
    [&](auto plan) {
      using P = decltype(plan);
      using W = typename P::Word;
      const posit::Thresholds m = posit::thresholds(posit::prep_divisor<P>(b));
      constexpr int low = 32 * (P::words - 1);   // the top word's place in the register
      for (int i = 0; i < count; ++i)
        out[i] = by_count
            ? posit::select_digit<P, posit::Selection::count>(W(ws[i]) << low, W(wc[i]) << low, m)
            : posit::select_digit<P>(W(ws[i]) << low, W(wc[i]) << low, m);
    });
  return ok ? 0 : -1;
}
extern "C" int host_div_patterns(int n, int radix, int red, int otf, int scaled, int nonrest,
                                 int it, int shift, int gbits, const uint32_t* px,
                                 const uint32_t* pd, uint32_t* out, int count) {
  bool ok = false;
  posit::dispatch_plan<true>(n, radix, red, otf, scaled, nonrest, it, shift, gbits,
    [&](auto plan) {
      using P = decltype(plan);
      if constexpr (P::n <= 32) {
        for (int i = 0; i < count; ++i) out[i] = posit::divide_patterns<P>(px[i], pd[i]);
        ok = true;
      }
    });
  return ok ? 0 : -1;
}
template <int N>
int round_differs(const float* x, uint8_t* bad, int count) {
  int n_bad = 0;
  for (int i = 0; i < count; ++i) {
    const float got = posit::round_value<N>(x[i]);
    const float want = posit::posit_to_float<N>(posit::float_to_posit<N>(x[i]));
    bad[i] = posit::f2u(got) != posit::f2u(want);
    n_bad += bad[i];
  }
  return n_bad;
}
extern "C" int host_round_differs(int n, const float* x, uint8_t* bad, int count) {
  switch (n) {
    case 8: return round_differs<8>(x, bad, count);
    case 16: return round_differs<16>(x, bad, count);
    case 32: return round_differs<32>(x, bad, count);
    default: return -1;
  }
}
extern "C" void host_bf16_bits(const float* x, uint16_t* out, int count) {
  for (int i = 0; i < count; ++i) out[i] = posit::bf16_bits(x[i]);
}
template <int N>
void cast(const float* x, uint32_t* p, const uint32_t* q, float* y, int count) {
  for (int i = 0; i < count; ++i) {
    p[i] = posit::float_to_posit<N>(x[i]);
    y[i] = posit::posit_to_float<N>(q[i]);
  }
}
extern "C" int host_cast(int n, const float* x, uint32_t* p, const uint32_t* q, float* y,
                         int count) {
  switch (n) {
    case 8: cast<8>(x, p, q, y, count); return 0;
    case 16: cast<16>(x, p, q, y, count); return 0;
    case 32: cast<32>(x, p, q, y, count); return 0;
    default: return -1;
  }
}
extern "C" void host_cast64(const float* x, uint64_t* p, const uint64_t* q, float* y,
                            int count) {
  for (int i = 0; i < count; ++i) {
    p[i] = posit::float_to_posit<64>(x[i]);
    y[i] = posit::posit_to_float<64>(q[i]);
  }
}
template <int N>
int fields_differ(const float* x, uint8_t* bad, int count) {
  int n_bad = 0;
  for (int i = 0; i < count; ++i) {
    const auto got = posit::float_to_fields<N>(x[i]);
    const auto want = posit::decode<N>(posit::float_to_posit<N>(x[i]));
    bad[i] = got.zero != want.zero || got.nar != want.nar ||
             (!want.zero && !want.nar &&
              (got.sign != want.sign || got.scale != want.scale || got.sig != want.sig));
    n_bad += bad[i];
  }
  return n_bad;
}
extern "C" int host_fields_differ(int n, const float* x, uint8_t* bad, int count) {
  switch (n) {
    case 8: return fields_differ<8>(x, bad, count);
    case 16: return fields_differ<16>(x, bad, count);
    case 32: return fields_differ<32>(x, bad, count);
    case 64: return fields_differ<64>(x, bad, count);
    default: return -1;
  }
}
template <int N>
bool quotient_differs(int sign, int scale, uint64_t frac, int rs, int flag) {
  using U = typename posit::Fmt<N>::U;
  const posit::QuotientFields<U> q{static_cast<U>(frac), 0, static_cast<uint32_t>(rs >> 1),
                                   (rs & 1) != 0};
  const bool zero = flag == 1, nar = flag == 2;
  const float got = posit::quotient_to_float<N>(sign != 0, scale, q, zero, nar);
  const float want = posit::posit_to_float<N>(
      posit::encode<N>(sign != 0, scale, q.frac, q.round_bit, q.sticky, zero, nar));
  return posit::f2u(got) != posit::f2u(want);
}
// Every (sign, scale in [lo, hi], fraction, round, sticky) of posit<n>:
// the count where quotient_to_float leaves posit_to_float(encode(...)).
template <int N>
long long quotient_sweep(int lo, int hi) {
  long long n_bad = 0;
  for (int scale = lo; scale <= hi; ++scale)
    for (uint64_t f = 0; f < (1ull << posit::Fmt<N>::F); ++f)
      for (int rs = 0; rs < 4; ++rs)
        for (int sign = 0; sign < 2; ++sign) n_bad += quotient_differs<N>(sign, scale, f, rs, 0);
  return n_bad;
}
extern "C" long long host_quotient_sweep(int n, int lo, int hi) {
  switch (n) {
    case 8: return quotient_sweep<8>(lo, hi);
    case 16: return quotient_sweep<16>(lo, hi);
    default: return -1;
  }
}
extern "C" int host_quotient_differ(int n, const int* sign, const int* scale,
                                    const uint64_t* frac, const int* rs, const int* flag,
                                    uint8_t* bad, int count) {
  int n_bad = 0;
  for (int i = 0; i < count; ++i) {
    switch (n) {
      case 8: bad[i] = quotient_differs<8>(sign[i], scale[i], frac[i], rs[i], flag[i]); break;
      case 16: bad[i] = quotient_differs<16>(sign[i], scale[i], frac[i], rs[i], flag[i]); break;
      case 32: bad[i] = quotient_differs<32>(sign[i], scale[i], frac[i], rs[i], flag[i]); break;
      case 64: bad[i] = quotient_differs<64>(sign[i], scale[i], frac[i], rs[i], flag[i]); break;
      default: return -1;
    }
    n_bad += bad[i];
  }
  return n_bad;
}
"""


@pytest.fixture(scope="module")
def host_k1(tmp_path_factory):
    """csrc/posit_srt.cuh compiled as host C++ (the header is
    __host__ __device__), so K1's arithmetic is checked without a card."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("k1")
    (d / "k1.cpp").write_text(_HOST_HARNESS)
    lib = d / "libk1.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-I", str(INC.rsplit("/", 1)[0]), str(d / "k1.cpp"), "-o", str(lib)],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(lib))
    for name in ("host_rowwise", "host_elementwise", "host_div_bits", "host_cast",
                 "host_model_plan", "host_library_part", "host_divisor_fields", "host_select",
                 "host_fields_differ", "host_quotient_differ", "host_div_patterns",
                 "host_round_differs"):
        getattr(lib, name).restype = ctypes.c_int
    lib.host_cast64.restype = None
    lib.host_bf16_bits.restype = None
    lib.host_quotient_sweep.restype = ctypes.c_longlong
    return lib


def test_cuda_model_plans_mirrored_by_kernel_built(host_k1):
    """``posit::kModelPlan`` (the plans K3-K9 are instantiated for) names
    what ``kernel_built`` names, row by row of both plan tables: every
    posit8, posit16, posit32 and posit64 plan, no posit10 plan; and
    ``posit::kLibraryPart`` puts each plan in the library
    ``_build.part_of`` names (posit64 in three: radix 4, radix 2
    non-redundant, radix 2 carry-save)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.posit_flash_attn import kernel_built

    pairs = list(TD.planned_pairs()) + TD.one_word_pairs((PositFormat(10),))
    for fmt, variant, plan in pairs:
        want = kernel_built(plan)
        assert host_k1.host_model_plan(*plan_args(plan)) == int(want), (fmt.n, variant)
        assert want == (fmt.n in (8, 16, 32, 64))
    for fmt, variant, plan in TD.planned_pairs():
        parts = _build.FORMAT_PARTS.get(fmt.n, ("",))
        assert parts[host_k1.host_library_part(*plan_args(plan))] == _build.part_of(plan), \
            (fmt.n, variant)
    assert [_build.part_of(p) for _, _, p in TD.planned_pairs((PositFormat(64),))] == [
        "r2", "r2", "r2cs", "r2cs", "r2cs", "r4", "r4", "r4"]


@pytest.mark.parametrize("n", [8, 16, 32, 64])
def test_cuda_datapath_header_matches_twin(host_k1, n):
    fmt = PositFormat(n)
    if n == 8:   # every posit8 value against every other
        from repro_torch.core.posit import posit_to_float

        vals = np.concatenate([posit_to_float(fmt, torch.arange(256)).numpy(), SPECIALS])
        a = np.tile(vals[None, :], (len(vals), 1)).astype(np.float32)
        b = vals.astype(np.float32).copy()
    else:
        a = (RNG.standard_normal((64, 200)) * np.exp(RNG.uniform(-30, 30, (64, 200))))
        b = RNG.standard_normal(64) * np.exp(RNG.uniform(-30, 30, 64))
        a, b = a.astype(np.float32), b.astype(np.float32)
        a[0, :len(SPECIALS)] = SPECIALS
        b[:len(SPECIALS)] = SPECIALS
    ptr = ctypes.POINTER(ctypes.c_float)
    for _, variant, plan in TD.planned_pairs((fmt,)):
        out = np.zeros_like(a)
        rc = host_k1.host_rowwise(*plan_args(plan), a.ctypes.data_as(ptr),
                                  b.ctypes.data_as(ptr), out.ctypes.data_as(ptr), a.shape[0],
                                  a.shape[1])
        assert rc == 0, variant
        want = TD.divide_floats_block(fmt, torch.from_numpy(a), torch.from_numpy(b)[:, None],
                                      variant)
        np.testing.assert_array_equal(bits(out), bits(want), err_msg=variant)


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


@pytest.mark.parametrize("n", [8, 16, 32, 64])
def test_cuda_elementwise_divide_matches_twin(host_k1, n):
    """K10's body: each element prepares its own divisor."""
    fmt = PositFormat(n)
    a = (RNG.standard_normal(6000) * np.exp(RNG.uniform(-30, 30, 6000))).astype(np.float32)
    b = (RNG.standard_normal(6000) * np.exp(RNG.uniform(-30, 30, 6000))).astype(np.float32)
    a[:len(SPECIALS)], b[:len(SPECIALS)] = SPECIALS, SPECIALS[::-1]
    for _, variant, plan in TD.planned_pairs((fmt,)):
        out = np.zeros_like(a)
        assert host_k1.host_elementwise(*plan_args(plan), _ptr(a), _ptr(b), _ptr(out),
                                        len(a)) == 0
        want = TD.divide_floats_block(fmt, torch.from_numpy(a), torch.from_numpy(b), variant)
        np.testing.assert_array_equal(bits(out), bits(want), err_msg=variant)


@pytest.mark.parametrize("n", [8, 10, 16, 32])
def test_cuda_pattern_divide_matches_twin(host_k1, n):
    """K11's body on patterns: posit8 exhaustive, posit10/16/32 sampled with
    the edges, every variant the pattern kernel is built for."""
    fmt = PositFormat(n)
    if n == 8:
        px, pd = (m.ravel() for m in np.meshgrid(np.arange(256), np.arange(256)))
        px, pd = px.astype(np.uint32), pd.astype(np.uint32)
    else:
        e = _edges(n)
        ea, eb = (m.ravel() for m in np.meshgrid(e, e))
        r = RNG.integers(0, 1 << n, (2, 8000), dtype=np.uint64).astype(np.uint32)
        px, pd = np.concatenate([r[0], ea]), np.concatenate([r[1], eb])
    for _, variant, plan in TD.planned_pairs((fmt,)):
        out = np.zeros_like(px)
        assert host_k1.host_div_bits(*plan_args(plan), _ptr(px), _ptr(pd), _ptr(out),
                                     len(px)) == 0
        want = TD._divide_block(fmt, _t(px), _t(pd), variant).numpy()
        np.testing.assert_array_equal(out.astype(np.int64), want, err_msg=variant)
    if n == 10:   # no other kernel's table has the posit10 rows
        plan = TD.kernel_datapath_plan(fmt, "srt_r4_cs_of_fr")
        out = np.zeros(2, np.float32)
        assert host_k1.host_elementwise(*plan_args(plan), _ptr(out), _ptr(out), _ptr(out),
                                        2) == -1


@pytest.mark.parametrize("n", [8, 16, 32])
def test_cuda_casts_match_twin(host_k1, n):
    """K12's bodies: every posit8/16 pattern (sampled posit32) dequantized,
    random f32 bit patterns and the specials quantized."""
    from repro_torch.core.posit import float_to_posit, posit_to_float

    fmt = PositFormat(n)
    x = RNG.integers(0, 1 << 32, 1 << 16, dtype=np.uint64).astype(np.uint32).view(np.float32)
    x = np.concatenate([x, SPECIALS])
    q = (np.arange(1 << n, dtype=np.uint32) if n < 32 else
         RNG.integers(0, 1 << 32, 1 << 16, dtype=np.uint64).astype(np.uint32))
    q, x = q[:min(len(q), len(x))], x[:min(len(q), len(x))]
    p, y = np.zeros(len(x), np.uint32), np.zeros(len(x), np.float32)
    assert host_k1.host_cast(n, _ptr(x), _ptr(p), _ptr(q), _ptr(y), len(x)) == 0
    np.testing.assert_array_equal(p.astype(np.int64), float_to_posit(fmt, torch.from_numpy(x)))
    np.testing.assert_array_equal(bits(y), bits(posit_to_float(fmt, _t(q))))


def test_cuda_pattern_kernel_refuses_posit64(host_k1):
    """K11's table holds no posit64 row: its patterns do not fit a word."""
    plan = TD.kernel_datapath_plan(PositFormat(64), "srt_r4_cs_of_fr")
    out = np.zeros(2, np.uint32)
    assert host_k1.host_div_bits(*plan_args(plan), _ptr(out), _ptr(out), _ptr(out), 2) == -1


def test_cuda_wide_casts_match_twin(host_k1):
    """The posit64 casts K10, K2 and K3 run: random f32 bit patterns and the
    edges quantized, random posit64 patterns (all regimes) dequantized."""
    from repro_torch.core import wide

    fmt = PositFormat(64)
    x = RNG.integers(0, 1 << 32, 1 << 14, dtype=np.uint64).astype(np.uint32).view(np.float32)
    x = np.concatenate([x, SPECIALS, WIDE_EDGES])
    q = RNG.integers(0, 1 << 64, len(x), dtype=np.uint64)
    q[:8] = [0, 1 << 63, 1, (1 << 63) - 1, (1 << 64) - 1, 1 << 62, (1 << 63) + 1, 2]
    p, y = np.zeros(len(x), np.uint64), np.zeros(len(x), np.float32)
    host_k1.host_cast64(_ptr(x), _ptr(p), _ptr(q), _ptr(y), len(x))
    np.testing.assert_array_equal(p, wide.from_words(wide.float_to_posit_wide(
        fmt, torch.from_numpy(x))))
    np.testing.assert_array_equal(bits(y), bits(wide.posit_wide_to_float(fmt, wide.to_words(q))))


def _cut_patterns(width, rng):
    """``width``-bit values at and beside every rounding cut: for each guard
    position c, the bits above it (0, 1, all ones, random), the guard bit and
    the bits below it (0, 1, all ones)."""
    out = []
    for c in range(width):
        hi = (1 << (width - 1 - c)) - 1
        for j in {0, 1 & hi, hi, int(rng.integers(0, hi + 1))}:
            for g in (0, 1):
                for low in {0, 1 & ((1 << c) - 1), (1 << c) - 1}:
                    out.append((j << (c + 1)) | (g << c) | low)
    return np.array(sorted(set(out)), np.uint64)


def _boundary_floats():
    """Every f32 exponent (subnormals included) with mantissas at and beside
    every rounding cut and at the deep regime's thresholds 1/4 and 1/16, both
    signs; then 2^20 random bit patterns and the specials."""
    rng = np.random.default_rng(23)
    mant = np.concatenate([_cut_patterns(23, rng),
                           np.array([1 << 21, (1 << 21) - 1, (1 << 21) + 1, 1 << 19,
                                     (1 << 19) - 1, (1 << 19) + 1], np.uint64)])
    exps = np.arange(256, dtype=np.uint64)
    u = ((exps[:, None] << 23) | mant[None, :]).ravel()
    u = np.concatenate([u, u | (1 << 31),
                        rng.integers(0, 1 << 32, 1 << 20, dtype=np.uint64)])
    return np.concatenate([u.astype(np.uint32).view(np.float32), SPECIALS])


@pytest.mark.parametrize("n", [8, 16, 32, 64])
def test_cuda_float_to_fields_matches_cast_then_decode(host_k1, n):
    """K2's and K10's straight cast, float_to_fields, against the pattern
    round trip it replaces, decode(float_to_posit(x)): flags everywhere,
    sign, scale and significand wherever the value is a number."""
    x = _boundary_floats()
    bad = np.zeros(len(x), np.uint8)
    n_bad = host_k1.host_fields_differ(n, _ptr(x), _ptr(bad), len(x))
    assert n_bad == 0, x[bad.astype(bool)][:8].view(np.uint32)


def _quotient_fields(n):
    """posit``n`` quotient fields at every scale a quotient can take (and
    one past each end): fractions at and beside the posit rounding's cut for
    that scale and the f32 conversion's, the deep regime's thresholds and
    random ones; every round and sticky bit, both signs; zero and NaR flags
    on some."""
    rng = np.random.default_rng(n)
    F = n - 5
    sign, scale, frac = [], [], []
    for sc in range(-8 * (n - 2) - 2, 8 * (n - 2) + 3):
        k = sc >> 2
        fb = n - 3 - (k + 2 if k >= 0 else 1 - k)
        fr = [0, (1 << F) - 1] + [t + d for t in (1 << (F - 2), 1 << max(F - 4, 0))
                                  for d in (-1, 0, 1)]
        fr += [int(v) for v in rng.integers(0, 1 << F, 8, dtype=np.uint64)]
        for c in ({F - fb - 1} if 0 <= fb < F else set()) | ({F - 24} if F > 23 else set()):
            hi = (1 << (F - c - 1)) - 1
            for j in {0, 1 & hi, hi, int(rng.integers(0, hi + 1))}:
                for low in {0, 1 & ((1 << c) - 1), (1 << c) - 1}:
                    fr += [(j << (c + 1)) | (g << c) | low for g in (0, 1)]
        fr = sorted(set(fr))
        sign += [0, 1] * len(fr)
        scale += [sc] * 2 * len(fr)
        frac += [f for f in fr for _ in (0, 1)]
    m = len(frac)
    sign, scale, frac = (np.repeat(np.array(v, t), 4) for v, t in
                         ((sign, np.int32), (scale, np.int32), (frac, np.uint64)))
    rs = np.tile(np.arange(4, dtype=np.int32), m)
    flag = np.zeros(4 * m, np.int32)
    flag[::97], flag[1::89] = 1, 2
    return sign, scale, frac, rs, flag


@pytest.mark.parametrize("n", [8, 16, 32, 64])
def test_cuda_quotient_to_float_matches_encode_then_cast(host_k1, n):
    """K2's and K10's straight quotient cast, quotient_to_float, against the
    pattern it replaces, posit_to_float(encode(...)), bit for bit: posit8 and
    posit16 on every (sign, scale, fraction, round, sticky) a quotient can
    take, posit32 and posit64 at every scale on the fractions beside each
    rounding cut; zero and NaR flagged on a sample."""
    if n <= 16:
        assert host_k1.host_quotient_sweep(n, -8 * (n - 2) - 2, 8 * (n - 2) + 2) == 0
    sign, scale, frac, rs, flag = _quotient_fields(n)
    bad = np.zeros(len(sign), np.uint8)
    n_bad = host_k1.host_quotient_differ(n, _ptr(sign), _ptr(scale), _ptr(frac), _ptr(rs),
                                         _ptr(flag), _ptr(bad), len(sign))
    first = np.flatnonzero(bad)[:4]
    assert n_bad == 0, [(sign[i], scale[i], hex(frac[i]), rs[i], flag[i]) for i in first]


SELECT_FORMATS = [PositFormat(n) for n in (8, 10, 16, 32, 64)]


def _didx_divisors():
    """Divisors in each of the 8 intervals: 1 + i/8 (every format holds it),
    of either sign and at three scales (posit8 holds three fraction bits at
    each)."""
    return [(i, sign * (1 + i / 8) * 2.0 ** e) for i in range(8) for sign in (1, -1)
            for e in (-3, 0, 2)]


@pytest.mark.parametrize("fmt", SELECT_FORMATS, ids=lambda f: f"posit{f.n}")
def test_cuda_divisor_carries_thresholds_and_shifts(host_k1, fmt):
    """K1 decides a divisor's selection thresholds and scaling shifts once,
    in prep_divisor_bits: a radix-4 plan's prepared divisor holds
    seltables.RADIX4_M2/M1/M0/MM1 of its interval (Eq 28; the scaled plan
    Eq 29's constants), and a scaled plan's the interval's SCALING_SHIFTS;
    K2's and K10's divisor (prep_divisor_fields on float_to_fields) the
    same in every field."""
    from repro_torch.core import seltables as S

    out = np.zeros(6, np.int32)
    radix4 = [(v, p) for _, v, p in TD.planned_pairs((fmt,)) if p.radix == 4 and p.redundant]
    assert radix4
    for variant, plan in radix4:
        for didx, b in _didx_divisors():
            assert host_k1.host_divisor_fields(*plan_args(plan), ctypes.c_float(b),
                                               _ptr(out)) == 0
            if plan.scaled:
                thr = (S.SCALED_M2, S.SCALED_M1, S.SCALED_M0, S.SCALED_MM1)
                s1, s2 = S.SCALING_SHIFTS[didx]
                shifts = (s1, s2 or 0)
            else:
                thr = (S.RADIX4_M2[didx], S.RADIX4_M1[didx], S.RADIX4_M0[didx],
                       S.RADIX4_MM1[didx])
                shifts = (0, 0)
            assert tuple(out) == thr + shifts, (variant, didx, b)


@pytest.mark.parametrize("fmt", SELECT_FORMATS, ids=lambda f: f"posit{f.n}")
def test_cuda_select_digit_exhaustive(host_k1, fmt):
    """select_digit against the twin's _select on every estimate of the
    plan's 3 + gbits bits, for a divisor of each of the 8 intervals and every
    plan: the estimate in the sum word's top bits, and split between the sum
    and carry words, with random bits below it."""
    rng = np.random.default_rng(11)
    for variant, plan in ((v, p) for _, v, p in TD.planned_pairs((fmt,))):
        tb = 3 + plan.gbits
        sh = 32 - tb
        t = np.arange(1 << tb, dtype=np.uint64)
        u = rng.integers(0, 1 << tb, t.size, dtype=np.uint64)
        lo = rng.integers(0, 1 << sh, (4, t.size), dtype=np.uint64)
        ws = np.concatenate([t << sh | lo[0], ((t - u) % (1 << tb)) << sh | lo[1]])
        wc = np.concatenate([lo[2], u << sh | lo[3]])
        ws, wc = ws.astype(np.uint32), wc.astype(np.uint32)
        got = np.zeros(ws.size, np.int32)
        for didx, b in _didx_divisors()[::6]:
            assert host_k1.host_select(*plan_args(plan), ctypes.c_float(b), _ptr(ws), _ptr(wc),
                                       _ptr(got), ws.size, 0) == 0
            want = TD._select(plan, _t(ws), _t(wc), torch.full((ws.size,), didx))
            np.testing.assert_array_equal(got, want.numpy(), err_msg=f"{variant} {didx}")


@pytest.mark.parametrize("fmt", SELECT_FORMATS, ids=lambda f: f"posit{f.n}")
def test_cuda_counted_selection_is_the_ladder(host_k1, fmt):
    """K11's selection, the count of the thresholds the estimate reaches,
    against the ladder (select_digit's default) and the twin's _select: every
    estimate of the plan's 3 + gbits bits, a divisor of each of the 8
    intervals (of either sign, at three scales), every plan (the scaled and
    posit10 rows among them; radix 2 and the non-redundant plans keep their
    forms under either policy)."""
    rng = np.random.default_rng(12)
    for variant, plan in ((v, p) for _, v, p in TD.planned_pairs((fmt,))):
        sh = 32 - (3 + plan.gbits)
        t = np.arange(1 << (3 + plan.gbits), dtype=np.uint64)
        ws = (t << sh | rng.integers(0, 1 << sh, t.size, dtype=np.uint64)).astype(np.uint32)
        wc = rng.integers(0, 1 << sh, t.size, dtype=np.uint64).astype(np.uint32)
        count, ladder = np.zeros(ws.size, np.int32), np.zeros(ws.size, np.int32)
        for didx, b in _didx_divisors():
            for by_count, got in ((1, count), (0, ladder)):
                assert host_k1.host_select(*plan_args(plan), ctypes.c_float(b), _ptr(ws),
                                           _ptr(wc), _ptr(got), ws.size, by_count) == 0
            np.testing.assert_array_equal(count, ladder, err_msg=f"{variant} {didx} {b}")
            want = TD._select(plan, _t(ws), _t(wc), torch.full((ws.size,), didx))
            np.testing.assert_array_equal(count, want.numpy(), err_msg=f"{variant} {didx}")


@pytest.mark.parametrize("n", [8, 10, 16, 32])
def test_cuda_pattern_element_is_divide_bits(host_k1, n):
    """K11's element (divide_patterns: the divisor prepared per element, the
    counted selection) against divide_bits with the ladder and the twin:
    posit8 and posit10 every pair, posit16 and posit32 sampled with the
    edges, every plan K11 is built for."""
    fmt = PositFormat(n)
    if n <= 10:
        px, pd = (m.ravel().astype(np.uint32)
                  for m in np.meshgrid(np.arange(1 << n), np.arange(1 << n)))
    else:
        e = _edges(n)
        ea, eb = (m.ravel() for m in np.meshgrid(e, e))
        r = RNG.integers(0, 1 << n, (2, 20000), dtype=np.uint64).astype(np.uint32)
        px, pd = np.concatenate([r[0], ea]), np.concatenate([r[1], eb])
    for _, variant, plan in TD.planned_pairs((fmt,)):
        got, ladder = np.zeros_like(px), np.zeros_like(px)
        assert host_k1.host_div_patterns(*plan_args(plan), _ptr(px), _ptr(pd), _ptr(got),
                                         len(px)) == 0
        assert host_k1.host_div_bits(*plan_args(plan), _ptr(px), _ptr(pd), _ptr(ladder),
                                     len(px)) == 0
        np.testing.assert_array_equal(got, ladder, err_msg=variant)
        want = TD._divide_block(fmt, _t(px), _t(pd), variant).numpy()
        np.testing.assert_array_equal(got.astype(np.int64), want, err_msg=variant)


def _round_inputs():
    """Every bf16 bit pattern widened to f32, 2^20 random f32 patterns, the
    f32 boundary values and the specials; then posit8/16/32's minpos and
    maxpos with their f32 neighbours (each format's, of either sign)."""
    rng = np.random.default_rng(29)
    u = np.concatenate([np.arange(1 << 16, dtype=np.uint32) << 16,
                        rng.integers(0, 1 << 32, 1 << 20, dtype=np.uint64).astype(np.uint32)])
    edges = []
    for n in (8, 16, 32):
        for e in (-4 * (n - 2), 4 * (n - 2)):
            m = np.float32(2.0 ** e).view(np.uint32)
            edges += [m - 1, m, m + 1, m | (1 << 31), (m - 1) | (1 << 31), (m + 1) | (1 << 31)]
    u = np.concatenate([u, np.array(edges, np.uint32)])
    return np.concatenate([u.view(np.float32), _boundary_floats(), SPECIALS])


@pytest.mark.parametrize("n", [8, 16, 32])
def test_cuda_round_value_is_cast_round_trip(host_k1, n):
    """K12's round kernel's element, round_value (float_to_fields, the f32
    built from the fields), against posit_to_float(float_to_posit(x)), bit
    for bit: zeros to +0, inf and NaN to the canonical NaN."""
    x = _round_inputs()
    bad = np.zeros(len(x), np.uint8)
    n_bad = host_k1.host_round_differs(n, _ptr(x), _ptr(bad), len(x))
    assert n_bad == 0, x[bad.astype(bool)][:8].view(np.uint32)


def test_cuda_bf16_rounding_is_torch_conversion(host_k1):
    """The round kernel's bf16 store, bf16_bits, against torch's
    ``.to(torch.bfloat16)`` on the same f32 values: round to nearest even,
    the carry into the exponent and to inf included; a NaN is the card's
    0x7FFF (torch's CPU conversion gives 0xFFFF; the card tests hold the
    kernel against torch's CUDA one, NaNs included)."""
    from repro_torch.core.posit import float_to_posit, posit_to_float

    x = _round_inputs()
    # every value the rounding can give: the posit grid's values
    grid = [posit_to_float(PositFormat(n), float_to_posit(PositFormat(n), torch.from_numpy(x)))
            for n in (8, 16, 32)]
    x = np.concatenate([x] + [t.numpy() for t in grid])
    got = np.zeros(len(x), np.uint16)
    host_k1.host_bf16_bits(_ptr(x), _ptr(got), len(x))
    want = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    nan = np.isnan(x)
    np.testing.assert_array_equal(got[~nan], want[~nan])
    assert nan.any() and (got[nan] == 0x7FFF).all()
