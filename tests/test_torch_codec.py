"""The port's posit codec is bit-exact against the reference's.

Every posit8 and posit16 pattern, sampled posit32 patterns, f32 values over
the whole exponent range (subnormals, +-0, NaN, +-Inf included) and the
posit32 minpos patterns that a flush-to-zero shortcut would break.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import bits, one_torch_thread  # noqa: F401  (fixture)
from repro.core import posit as JP
from repro_torch.core import posit as TP

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RNG = np.random.default_rng(21)
SPECIALS = np.array([0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf, 1e-45, -1e-45,
                     1.1754942e-38, -3e-39, 1.17549435e-38, 3.4028235e38, 1.0,
                     -1.0, 0.5], np.float32)


def _patterns(n):
    if n < 32:
        return np.arange(1 << n, dtype=np.uint32)
    rnd = RNG.integers(0, 1 << 32, 100_000, dtype=np.uint64).astype(np.uint32)
    edges = np.array([0, 1, 2, 7, 100, (1 << 31) - 1, 1 << 31, (1 << 31) + 1,
                      (1 << 32) - 1, (1 << 32) - 7], np.uint32)
    return np.concatenate([rnd, edges])


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("n", [8, 16, 32])
def test_decode_matches_reference(n):
    pats = _patterns(n)
    jd = JP.posit_decode(JP.PositFormat(n), jnp.asarray(pats))
    td = TP.posit_decode(TP.PositFormat(n), _t(pats))
    for field in ("sign", "scale", "sig", "is_zero", "is_nar"):
        np.testing.assert_array_equal(
            np.asarray(getattr(jd, field)).astype(np.int64),
            getattr(td, field).numpy().astype(np.int64), err_msg=field)


@pytest.mark.parametrize("n", [8, 16, 32])
def test_posit_to_float_matches_reference(n):
    pats = _patterns(n)
    j = JP.posit_to_float(JP.PositFormat(n), jnp.asarray(pats))
    t = TP.posit_to_float(TP.PositFormat(n), _t(pats))
    np.testing.assert_array_equal(bits(j), bits(t))


@pytest.mark.parametrize("n", [8, 16, 32])
def test_float_to_posit_matches_reference(n):
    mant = RNG.standard_normal(60_000).astype(np.float32)
    scale = np.exp2(RNG.integers(-149, 128, 60_000)).astype(np.float32)
    with np.errstate(over="ignore"):
        wide = (mant * scale).astype(np.float32)
    raw = RNG.integers(0, 1 << 32, 60_000, dtype=np.uint64).astype(np.uint32)
    sub = RNG.integers(1, 1 << 23, 20_000, dtype=np.uint64).astype(np.uint32)
    x = np.concatenate([wide, raw.view(np.float32), sub.view(np.float32),
                        SPECIALS]).astype(np.float32)
    # posit values themselves round-trip: feed the format's own grid too
    grid = np.asarray(JP.posit_to_float(JP.PositFormat(n),
                                        jnp.asarray(_patterns(n)[:70_000])))
    x = np.concatenate([x, grid.astype(np.float32)])
    j = np.asarray(JP.float_to_posit(JP.PositFormat(n), jnp.asarray(x)))
    t = TP.float_to_posit(TP.PositFormat(n), torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(j.astype(np.int64), t)


def test_special_values_and_subnormals():
    fmt = TP.PositFormat(16)
    x = torch.tensor([0.0, -0.0, float("nan"), float("inf"), -float("inf"),
                      1e-45, -1e-45, 3e-39])
    p = TP.float_to_posit(fmt, x).tolist()
    assert p[:2] == [0, 0]
    assert p[2:5] == [fmt.nar_pattern] * 3
    # subnormal f32 inputs quantize to +-minpos, never to 0
    assert p[5] == 1 and p[6] == fmt.mask and p[7] == 1


def test_posit32_minpos_patterns_not_flushed():
    """posit32 minpos-region values (~1e-36) are normal f32 numbers; the
    two-factor ldexp keeps them, a single 2^e factor would flush them."""
    fmt = TP.PositFormat(32)
    pats = np.array([1, 2, 7, 100], np.uint32)
    t = TP.posit_to_float(fmt, _t(pats))
    j = JP.posit_to_float(JP.PositFormat(32), jnp.asarray(pats))
    np.testing.assert_array_equal(bits(j), bits(t))
    assert (t >= 2.0 ** -126).all() and (t < 1e-27).all()   # normal, nonzero
    np.testing.assert_array_equal(TP.float_to_posit(fmt, t).numpy(), pats)


def test_clz32():
    x = np.concatenate([np.array([0, 1, 2, 3, 0x80000000, 0xFFFFFFFF], np.uint64),
                        RNG.integers(0, 1 << 32, 1000, dtype=np.uint64)])
    want = [32 - int(v).bit_length() for v in x]
    assert TP.clz32(torch.from_numpy(x.astype(np.int64))).tolist() == want
