"""The port's SRT datapath plan and plain twin against the reference.

* plans: every field and every error string equal, 9 variants x posit8/16/
  32/64, and the CUDA plan table (csrc/posit_plans.inc) equal to the plan;
* the twin is bit-exact against the reference's ``_divide_block`` (posit8
  exhaustive for all 9 variants, posit16/32 sampled for every one-word plan
  with the NaR/zero/minpos/maxpos edges) and ``divide_floats_block``
  (a (rows, 1) divisor, the special float values);
* the CUDA datapath header (K1), compiled as host C++, is bit-exact against
  the twin.
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

from _torch_port import bits
from repro.core.posit import PositFormat as JFmt
from repro_torch.core.posit import PositFormat
from repro_torch.kernels import posit_div as TD
from repro_torch.kernels.ops import plan_args

JD = importlib.import_module("repro.kernels.posit_div")
RNG = np.random.default_rng(7)
VARIANTS = TD.KERNEL_VARIANTS
ONE_WORD = [(f.n, v) for f, v, _ in TD.one_word_pairs()]
INC = TD.__file__.replace("posit_div.py", "csrc/posit_plans.inc")
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
        TD.one_word_plan(PositFormat(16), "bogus")


def test_cuda_plan_table_matches_plan():
    rows = re.findall(r"^POSIT_PLAN\(([^)]*)\)", open(INC).read(), re.M)
    table = [tuple(int(x) for x in r.split(",")) for r in rows]
    assert table == [plan_args(p) for _, _, p in TD.one_word_pairs()]
    assert len(table) == 26


@pytest.mark.parametrize("fmt", [PositFormat(64), PositFormat(32)])
def test_two_word_plans_raise_not_implemented(fmt):
    variant = "srt_r4_cs_of_fr" if fmt.n == 64 else "srt_r4_scaled"
    assert TD.kernel_datapath_plan(fmt, variant).words == 2
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TD.divide_floats_block(fmt, torch.ones(2), torch.ones(2), variant)


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


_HOST_HARNESS = r"""
#include "posit_srt.cuh"
extern "C" int host_rowwise(int n, int radix, int red, int otf, int scaled, int nonrest,
                            int it, int shift, int gbits, const float* a, const float* b,
                            float* out, int R, int C) {
  bool ok = posit::dispatch_plan(n, radix, red, otf, scaled, nonrest, it, shift, gbits,
    [&](auto plan) {
      using P = decltype(plan);
      for (int r = 0; r < R; ++r) {
        const posit::Divisor d = posit::prep_divisor<P>(b[r]);
        for (int c = 0; c < C; ++c) out[r * C + c] = posit::divide_float<P>(a[r * C + c], d);
      }
    });
  return ok ? 0 : -1;
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
    fn = ctypes.CDLL(str(lib)).host_rowwise
    fn.restype = ctypes.c_int
    return fn


@pytest.mark.parametrize("n", [8, 16, 32])
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
    for _, variant, plan in TD.one_word_pairs((fmt,)):
        out = np.zeros_like(a)
        rc = host_k1(*plan_args(plan), a.ctypes.data_as(ptr), b.ctypes.data_as(ptr),
                     out.ctypes.data_as(ptr), a.shape[0], a.shape[1])
        assert rc == 0, variant
        want = TD.divide_floats_block(fmt, torch.from_numpy(a), torch.from_numpy(b)[:, None],
                                      variant)
        np.testing.assert_array_equal(bits(out), bits(want), err_msg=variant)
