"""The port's posit64 codec (``core/wide.py``) and the two-word numerics
against the reference.

* the wide casts: f32 -> posit64 on the edge operands and 2^12 random
  values, posit64 -> f32 on 2^12 random patterns (every regime) and the
  edge patterns, decode's fields and encode's rounding on random fields,
  all against ``repro.core.wide``, bit for bit;
* a ``core/goldens`` spot check of the posit64 float division at n = 64
  (exact rationals, independent of both datapaths), the goldens'
  quantization of each operand equal to the twin's;
* ``posit_div_values`` / ``posit_rmsnorm_div`` at posit64: values bit-exact
  and straight-through gradients within 1e-6 relative of the reference's
  fused backend (kernels in interpret mode);
* the cost model at posit64: Table II's iteration counts (62 for radix 2,
  32 for radix 4) and every estimate field equal to the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import bits, one_torch_thread, ref_kernels  # noqa: F401
from repro.core import wide as JW
from repro.core.bitvec import BitVec, bv_from_ints, bv_to_ints
from repro.core.posit import PositFormat as JFmt
from repro_torch.core import goldens, wide
from repro_torch.core.posit import POSIT64
from repro_torch.kernels.posit_div import divide_floats_block

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RNG = np.random.default_rng(64)
J64 = JFmt(64)
GRAD_RTOL = 1e-6
EDGES = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 3.4028235e38, -3.4028235e38,
                  1.1754944e-38, 1e-45, -1e-44, 1e30, -1e-30, 1.0, 2.0], np.float32)
EDGE_PATTERNS = [0, 1 << 63, 1, (1 << 63) - 1, (1 << 64) - 1, 1 << 62, (1 << 63) + 1, 2,
                 3 << 62, (1 << 62) + 1, (1 << 62) - 1]


def _floats():
    """The edge operands, 2^11 values over the whole f32 range and 2^11
    random f32 bit patterns (subnormals, NaNs and infinities among them)."""
    mixed = (RNG.normal(0, 1, 1 << 11) * 10.0 ** RNG.uniform(-45, 38, 1 << 11))
    raw = RNG.integers(0, 1 << 32, 1 << 11, dtype=np.uint64).astype(np.uint32)
    return np.concatenate([EDGES, mixed.astype(np.float32), raw.view(np.float32)])


def _patterns():
    return [int(p) for p in RNG.integers(0, 1 << 64, 1 << 12, dtype=np.uint64)] + EDGE_PATTERNS


def test_quantize_matches_reference():
    x = _floats()
    want = bv_to_ints(JW.float_to_posit_wide(J64, jnp.asarray(x))).reshape(-1)
    got = wide.from_words(wide.float_to_posit_wide(POSIT64, torch.from_numpy(x)))
    assert [int(p) for p in got] == [int(p) for p in want]


def test_dequantize_and_decode_match_reference():
    pats = _patterns()
    jp = bv_from_ints(np.array(pats, dtype=object), 64)
    tp = wide.to_words(pats)
    np.testing.assert_array_equal(bits(wide.posit_wide_to_float(POSIT64, tp)),
                                  bits(JW.posit_wide_to_float(J64, jp)))
    js, jT, jsig, jz, jn = JW.decode_wide(J64, jp)
    ts, tT, tsig, tz, tn = wide.decode_wide(POSIT64, tp)
    for got, want in ((ts, js), (tT, jT), (tz, jz), (tn, jn)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        wide.from_words(tsig), np.asarray([int(v) for v in bv_to_ints(jsig).reshape(-1)],
                                          np.uint64))


def test_encode_matches_reference():
    """Rounding of random fields: every scale (deep regime tails, over- and
    underflow included), random fractions, round and sticky bits."""
    m = 4096
    sign = RNG.integers(0, 2, m).astype(bool)
    scale = RNG.integers(-260, 260, m).astype(np.int32)
    frac = [int(f) for f in RNG.integers(0, 1 << 59, m, dtype=np.uint64)]
    rb = RNG.integers(0, 2, m).astype(np.uint32)
    st = RNG.integers(0, 2, m).astype(bool)
    zero, nar = np.zeros(m, bool), np.zeros(m, bool)
    zero[:3], nar[3:6] = True, True
    jf = bv_from_ints(np.array(frac, dtype=object), 59)
    want = JW.encode_wide(J64, jnp.asarray(sign), jnp.asarray(scale), jf, jnp.asarray(rb),
                          jnp.asarray(st), jnp.asarray(zero), jnp.asarray(nar))
    got = wide.encode_wide(POSIT64, torch.from_numpy(sign), torch.from_numpy(scale),
                           wide.to_words(frac), torch.from_numpy(rb.astype(np.int64)),
                           torch.from_numpy(st), torch.from_numpy(zero),
                           torch.from_numpy(nar))
    assert isinstance(want, BitVec)
    assert [int(p) for p in wide.from_words(got)] == [int(p) for p in
                                                      bv_to_ints(want).reshape(-1)]


def test_goldens_posit64_spot_check():
    """The twin's posit64 float division against exact rationals: quantize,
    divide and round in Python ints, then RNE to 24 bits (normal range)."""
    vals = np.concatenate([np.asarray([1.0, -2.0, 3.0, 0.5, 1e30, 1e-30, 3.4e38, 1.18e-38],
                                      np.float32),
                           (RNG.normal(0, 1, 56) * 10.0 ** RNG.uniform(-30, 30, 56)
                            ).astype(np.float32)])
    a, b = vals[:32], vals[32:]
    got = divide_floats_block(POSIT64, torch.from_numpy(a), torch.from_numpy(b)).numpy()
    for i in range(a.size):
        pa, pb = goldens.from_float(float(a[i]), 64), goldens.from_float(float(b[i]), 64)
        assert pa == int(wide.from_words(wide.float_to_posit_wide(
            POSIT64, torch.from_numpy(a[i:i + 1])))[0])
        d = goldens.decode(goldens.div(pa, pb, 64), 64)
        assert d[0] == "num", (a[i], b[i])
        _, s, T, sig = d
        m24 = sig >> 36
        g, st = (sig >> 35) & 1, (sig & ((1 << 35) - 1)) != 0
        m24 += g & (int(st) | (m24 & 1))
        with np.errstate(over="ignore"):
            want = np.float32((-1.0 if s else 1.0) * float(m24) * 2.0 ** (T - 23))
        if np.isfinite(want) and abs(want) >= 1.1754944e-38:
            assert got[i] == want, (i, a[i], b[i], got[i], want)


@pytest.mark.parametrize("case", ["rmsnorm", "elementwise"])
def test_posit64_div_values_match_reference(ref_kernels, case):
    """Values bit-exact, straight-through gradients (reference ``_div_bwd``)
    within GRAD_RTOL: the row-broadcast divide (K2's twin) through
    ``posit_rmsnorm_div`` and the elementwise one (K10's)."""
    from repro.numerics import NumericsConfig as JNumerics
    from repro.numerics.posit_ops import posit_div_values as j_div_values
    from repro.numerics.posit_ops import posit_rmsnorm_div as j_rmsnorm_div
    from repro_torch.numerics import NumericsConfig, posit_div_values, posit_rmsnorm_div

    jcfg = JNumerics(posit_division=True, div_backend="fused", div_format="posit64")
    tcfg = NumericsConfig(div_format="posit64")
    a = (RNG.standard_normal((6, 33)) * 3).astype(np.float32)
    if case == "rmsnorm":
        b = np.sqrt(np.mean(a * a, -1, keepdims=True) + 1e-6).astype(np.float32)
        jfn, tfn = j_rmsnorm_div, posit_rmsnorm_div
    else:
        b = (RNG.uniform(0.2, 4.0, a.shape) * RNG.choice([-1, 1], a.shape)).astype(np.float32)
        jfn, tfn = j_div_values, posit_div_values
    w = RNG.standard_normal(a.shape).astype(np.float32)
    ref, (jga, jgb) = jax.value_and_grad(
        lambda x, y: jnp.sum(jfn(x, y, jcfg) * w), (0, 1))(jnp.asarray(a), jnp.asarray(b))
    ref_out = jfn(jnp.asarray(a), jnp.asarray(b), jcfg)
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    out = tfn(ta, tb, tcfg)
    np.testing.assert_array_equal(bits(out.detach()), bits(ref_out))
    (out * torch.from_numpy(w)).sum().backward()
    for got, want in ((ta.grad, jga), (tb.grad, jgb)):
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * float(np.abs(want).max()))
    np.testing.assert_allclose(ta.grad.numpy(), w / b, rtol=1e-6)


@pytest.mark.parametrize("variant", ["srt_r2_cs", "srt_r4_cs", "srt_r4_cs_of_fr", "nrd",
                                     "srt_r4_scaled"])
def test_costmodel_posit64_matches_reference(variant):
    import dataclasses

    from repro.core import costmodel as JC
    from repro_torch.core import costmodel as TC

    want = JC.estimate(J64, variant, pipelined=False)
    got = TC.estimate(POSIT64, variant, pipelined=False)
    assert got.iterations == {"srt_r2_cs": 62, "nrd": 62}.get(variant, 32)
    for f in dataclasses.fields(got):
        if f.name != "fmt":
            assert getattr(got, f.name) == pytest.approx(getattr(want, f.name), rel=1e-12), f.name
