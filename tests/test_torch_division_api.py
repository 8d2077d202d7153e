"""The port's division API (``kernels/ops.py``: ``posit_div`` on K11's twin,
``posit_div_fused`` on K10's, ``posit_quantize`` / ``posit_dequantize`` on
K12's) against the reference's, with its Pallas kernels in interpret mode.
Every comparison is bit-exact.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import bits, one_torch_thread, ref_kernels  # noqa: F401
from repro.core.posit import PositFormat as JFmt
from repro_torch.core.posit import POSIT8, POSIT16, POSIT32, POSIT64, PositFormat
from repro_torch.kernels import ops
from repro_torch.kernels.posit_div import KERNEL_VARIANTS, planned_pairs

pytestmark = pytest.mark.usefixtures("one_torch_thread")

JO = importlib.import_module("repro.kernels.ops")
RNG = np.random.default_rng(15)
# every plan on patterns that fit a word: the one-word plans and posit32
# srt_r4_scaled (two-word residual)
WORD_PATTERNS = [(f.n, v) for f, v, _ in planned_pairs() if f.n <= 32]
SPECIALS = np.array([1.5, -2.25, 0.0, -0.0, np.inf, -np.inf, np.nan, 1e30, -1e-30, 3.0,
                     1e-45, -3e-39, 1e-38, 2.0 ** -126, -(2.0 ** 127)], np.float32)


def _edges(n):
    """zero, NaR, +-minpos, +-maxpos, +-1 and their neighbours (uint32)."""
    mask, nar, maxpos, one = (1 << n) - 1, 1 << (n - 1), (1 << (n - 1)) - 1, 1 << (n - 2)
    e = [0, nar, 1, mask, maxpos, nar + 1, one, (-one) & mask, one + 1, one - 1, 2]
    return np.array(e, np.uint64).astype(np.uint32)


def _patterns(n, count):
    """``count`` random n-bit patterns (uint32) and every edge pair."""
    e = _edges(n)
    ea, eb = (m.ravel() for m in np.meshgrid(e, e))
    r = RNG.integers(0, 1 << n, (2, count), dtype=np.uint64).astype(np.uint32)
    return np.concatenate([r[0], ea]), np.concatenate([r[1], eb])


def _floats(shape):
    """Values over the whole f32 range, the special values first."""
    x = (RNG.standard_normal(shape) * np.exp(RNG.uniform(-60, 60, shape))).astype(np.float32)
    flat = x.reshape(-1)
    flat[:min(len(SPECIALS), flat.size)] = SPECIALS[:flat.size]
    return x


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _u32(t):
    return t.numpy().astype(np.uint32)


# ------------------------------------------------------------ posit_div (K11)


def test_posit_div_posit8_exhaustive(ref_kernels):
    a, b = (m.ravel() for m in np.meshgrid(np.arange(256, dtype=np.uint32),
                                          np.arange(256, dtype=np.uint32)))
    ref = np.asarray(JO.posit_div(JFmt(8), jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(_u32(ops.posit_div(POSIT8, _t(a), _t(b))), ref)


@pytest.mark.parametrize("n,variant", WORD_PATTERNS)
def test_posit_div_and_fused_match_reference(ref_kernels, n, variant):
    """posit_div on random patterns and every edge pair; posit_div_fused on
    floats over the whole f32 range with the special values."""
    a, b = _patterns(n, 3000)
    ref = np.asarray(JO.posit_div(JFmt(n), jnp.asarray(a), jnp.asarray(b), variant=variant))
    np.testing.assert_array_equal(_u32(ops.posit_div(PositFormat(n), _t(a), _t(b), variant)),
                                  ref)
    x, y = _floats(3000), _floats(3000)
    y[:len(SPECIALS)] = SPECIALS[::-1]
    ref = JO.posit_div_fused(JFmt(n), jnp.asarray(x), jnp.asarray(y), variant=variant)
    got = ops.posit_div_fused(PositFormat(n), torch.from_numpy(x), torch.from_numpy(y),
                              variant)
    np.testing.assert_array_equal(bits(got), bits(ref))


@pytest.mark.parametrize("variant", ["srt_r2", "srt_r4_cs_of_fr"])
def test_posit64_fused_matches_reference(ref_kernels, variant):
    """posit_div_fused and posit_div_fused_rowwise at posit64 (the two-word
    datapath on the wide casts) against the reference's kernels, bit for
    bit, over the whole f32 range with the special values."""
    x, y = _floats(1500), _floats(1500)
    y[:len(SPECIALS)] = SPECIALS[::-1]
    ref = JO.posit_div_fused(JFmt(64), jnp.asarray(x), jnp.asarray(y), variant=variant)
    got = ops.posit_div_fused(POSIT64, torch.from_numpy(x), torch.from_numpy(y), variant)
    np.testing.assert_array_equal(bits(got), bits(ref))
    a, b = _floats((24, 61)), _floats((24, 1))
    ref = JO.posit_div_fused_rowwise(JFmt(64), jnp.asarray(a), jnp.asarray(b), variant=variant)
    got = ops.posit_div_fused_rowwise(POSIT64, torch.from_numpy(a), torch.from_numpy(b),
                                      variant)
    np.testing.assert_array_equal(bits(got), bits(ref))


# ---------------------------------------------------------------- casts (K12)


def _f32_inputs():
    """Random f32 bit patterns, the specials, every subnormal class (one
    value per leading-bit position) and +-2^e with both neighbours."""
    rnd = RNG.integers(0, 1 << 32, 20000, dtype=np.uint64).astype(np.uint32)
    sub = np.array([1 << k for k in range(23)] + [(1 << k) | 1 for k in range(1, 23)]
                   + [(1 << (k + 1)) - 1 for k in range(23)], np.uint32)
    pow2 = np.array([e << 23 for e in range(1, 255)], np.uint32)
    near = np.concatenate([pow2, pow2 - 1, pow2 + 1])
    u = np.concatenate([rnd, sub, near, SPECIALS.view(np.uint32)])
    u = np.concatenate([u, u | np.uint32(1 << 31)])
    return u.view(np.float32)


@pytest.mark.parametrize("n", [8, 16, 32])
def test_casts_match_reference(ref_kernels, n):
    x = _f32_inputs()
    ref = np.asarray(JO.posit_quantize(JFmt(n), jnp.asarray(x)))
    got = ops.posit_quantize(PositFormat(n), torch.from_numpy(x))
    assert got.dtype == torch.int64 and int(got.min()) >= 0
    np.testing.assert_array_equal(_u32(got), ref)
    p = (np.arange(1 << n, dtype=np.uint32) if n < 32 else
         np.concatenate([_patterns(32, 20000)[0], _edges(32)]))
    ref = JO.posit_dequantize(JFmt(n), jnp.asarray(p))
    np.testing.assert_array_equal(bits(ops.posit_dequantize(PositFormat(n), _t(p))), bits(ref))


# --------------------------------------------------------- shapes and edges


@pytest.mark.parametrize("shape", [(257,), (5, 7, 11), (130, 260), (1, 1)],
                         ids=lambda s: "x".join(map(str, s)))
def test_shape_sweep_matches_reference(ref_kernels, shape):
    x, y = _floats(shape), _floats(shape)
    fmt, jfmt = POSIT16, JFmt(16)
    got = ops.posit_div_fused(fmt, torch.from_numpy(x), torch.from_numpy(y))
    assert got.shape == shape
    np.testing.assert_array_equal(bits(got), bits(JO.posit_div_fused(jfmt, jnp.asarray(x),
                                                                      jnp.asarray(y))))
    pa = ops.posit_quantize(fmt, torch.from_numpy(x))
    pb = ops.posit_quantize(fmt, torch.from_numpy(y))
    jpa, jpb = JO.posit_quantize(jfmt, jnp.asarray(x)), JO.posit_quantize(jfmt, jnp.asarray(y))
    assert pa.shape == shape
    np.testing.assert_array_equal(_u32(pa), np.asarray(jpa))
    q = ops.posit_div(fmt, pa, pb)
    assert q.shape == shape
    np.testing.assert_array_equal(_u32(q), np.asarray(JO.posit_div(jfmt, jpa, jpb)))
    np.testing.assert_array_equal(bits(ops.posit_dequantize(fmt, q)),
                                  bits(JO.posit_dequantize(jfmt, JO.posit_div(jfmt, jpa, jpb))))


@pytest.mark.parametrize("shape", [(0,), (3, 0, 5)])
def test_zero_size(shape):
    a = torch.zeros(shape)
    p = ops.posit_quantize(POSIT16, a)
    assert p.shape == shape and p.dtype == torch.int64
    assert ops.posit_dequantize(POSIT16, p).shape == shape
    assert ops.posit_div(POSIT16, p, p).shape == shape
    assert ops.posit_div_fused(POSIT16, a, a).shape == shape


@pytest.mark.parametrize("n,variant", WORD_PATTERNS)
def test_fused_equals_chained(n, variant):
    """K10's twin against K12 -> K11 -> K12's twins: the same bits."""
    fmt = PositFormat(n)
    x, y = (torch.from_numpy(_floats((64, 40))) for _ in range(2))
    chained = ops.posit_dequantize(fmt, ops.posit_div(fmt, ops.posit_quantize(fmt, x),
                                                      ops.posit_quantize(fmt, y), variant))
    np.testing.assert_array_equal(bits(ops.posit_div_fused(fmt, x, y, variant)), bits(chained))


@pytest.mark.parametrize("variant", KERNEL_VARIANTS)
def test_table3_posit10(variant):
    """The paper's Table III worked examples (Posit10), bit for bit."""
    X = int("0011010111", 2)
    d = _t([int("0001001100", 2), int("0000100110", 2)])
    got = ops.posit_div(PositFormat(10), _t([X, X]), d, variant)
    assert got.tolist() == [int("0110011111", 2), int("0111010000", 2)]


def test_posit32_negative_patterns_round_trip(ref_kernels):
    """Patterns with the top bit set stay unsigned through every entry
    point, and int32 words or packed inputs are taken as their bits."""
    neg = np.array([0x80000001, 0xC0000000, 0xFFFFFFFF, 0xBF800000, 0x80000000],
                   np.uint32)
    vals = ops.posit_dequantize(POSIT32, _t(neg))
    back = ops.posit_quantize(POSIT32, vals)
    np.testing.assert_array_equal(_u32(back), neg)
    assert int(back.min()) >= 0 and int(back.max()) <= 0xFFFFFFFF
    words = torch.from_numpy(neg.view(np.int32))
    np.testing.assert_array_equal(bits(ops.posit_dequantize(POSIT32, words)), bits(vals))
    q = ops.posit_div(POSIT32, _t(neg), words)
    assert int(q.min()) >= 0
    ref = JO.posit_div(JFmt(32), jnp.asarray(neg), jnp.asarray(neg))
    np.testing.assert_array_equal(_u32(q), np.asarray(ref))


def test_error_messages_match_reference():
    x = torch.ones(4)
    msgs = []
    for port, ref in ((lambda: ops.posit_div(POSIT64, x.long(), x.long()),
                       lambda: JO.posit_div(JFmt(64), jnp.ones(4, jnp.uint32),
                                            jnp.ones(4, jnp.uint32))),
                      (lambda: ops.posit_div_fused(POSIT64, x, x, "srt_r4_scaled"),
                       lambda: JO.posit_div_fused(JFmt(64), jnp.ones(4), jnp.ones(4),
                                                  variant="srt_r4_scaled")),
                      (lambda: ops.posit_div_fused(POSIT16, x, x, "bogus"),
                       lambda: JO.posit_div_fused(JFmt(16), jnp.ones(4), jnp.ones(4),
                                                  variant="bogus"))):
        with pytest.raises(ValueError) as got:
            port()
        with pytest.raises(ValueError) as want:
            ref()
        assert str(got.value) == str(want.value)
        msgs.append(str(got.value))
    assert "uint32 bit patterns" in msgs[0] and "no fused datapath" in msgs[1]


def test_unported_and_misused_inputs_raise():
    x = torch.ones(4)
    with pytest.raises(ValueError, match="n <= 32"):
        ops.posit_quantize(POSIT64, x)
    with pytest.raises(ValueError, match="one shape"):
        ops.posit_div_fused(POSIT16, x, torch.ones(2, 2))
    meta = torch.ones(4, device="meta")       # neither the CPU nor a card
    for call in (lambda: ops.posit_div_fused(POSIT16, meta, meta),
                 lambda: ops.posit_div(POSIT16, meta.long(), meta.long()),
                 lambda: ops.posit_quantize(POSIT16, meta),
                 lambda: ops.posit_dequantize(POSIT16, meta.long())):
        with pytest.raises(ValueError, match="device"):
            call()


def test_fused_variant_supported():
    for n in (8, 16, 32, 64):
        for v in KERNEL_VARIANTS:
            want = JO.fused_variant_supported(JFmt(n), v)   # two-word plans too
            assert ops.fused_variant_supported(PositFormat(n), v) == want, (n, v)
    assert not ops.fused_variant_supported(POSIT16, "bogus")
    assert ops.FUSED_DIV_VARIANTS == tuple(JO.FUSED_DIV_VARIANTS)
