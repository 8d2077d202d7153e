"""The port's ``numerics/quant.py``, ``core/goldens.py`` and
``core/costmodel.py`` against the reference's, bit for bit (the casts on
K12's twin, the goldens and the cost model pure Python on both sides)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import bits
from repro.core import costmodel as JC
from repro.core import goldens as JG
from repro.core.posit import PositFormat as JFmt
from repro.numerics import quant as JQ
from repro_torch.core import costmodel as TC
from repro_torch.core import goldens as TG
from repro_torch.core.posit import PositFormat
from repro_torch.kernels.posit_div import KERNEL_VARIANTS
from repro_torch.numerics import quant as TQ

RNG = np.random.default_rng(17)
SPECIALS = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -3e-39, 1e38, -1.0, 0.75],
                    np.float32)


def _floats(count):
    x = (RNG.standard_normal(count) * np.exp(RNG.uniform(-80, 80, count))).astype(np.float32)
    return np.concatenate([SPECIALS, x])


@pytest.mark.parametrize("n", [8, 16, 32])
def test_quant_matches_reference(n):
    x = _floats(20000)
    jp = JQ.quantize_tensor(JFmt(n), jnp.asarray(x))
    tp = TQ.quantize_tensor(PositFormat(n), torch.from_numpy(x))
    np.testing.assert_array_equal(tp.numpy().astype(np.uint32), np.asarray(jp))
    np.testing.assert_array_equal(bits(TQ.dequantize_tensor(PositFormat(n), tp)),
                                  bits(JQ.dequantize_tensor(JFmt(n), jp)))
    np.testing.assert_array_equal(bits(TQ.posit_round_value(PositFormat(n), torch.from_numpy(x))),
                                  bits(JQ.posit_round_value(JFmt(n), jnp.asarray(x))))


@pytest.mark.parametrize("n", [8, 16])
def test_round_value_is_idempotent_on_every_pattern(n):
    """Every posit value is a fixed point of the rounding (the KV cache's
    written rows must be)."""
    vals = TQ.dequantize_tensor(PositFormat(n), torch.arange(1 << n))
    np.testing.assert_array_equal(bits(TQ.posit_round_value(PositFormat(n), vals)), bits(vals))


@pytest.mark.parametrize("n", [8, 16, 32])
def test_quantize_ste_gradient_is_identity(n):
    x = _floats(300)
    x = x[np.isfinite(x)][:256]
    w = RNG.standard_normal(x.shape).astype(np.float32)
    t = torch.from_numpy(x).requires_grad_()
    y = TQ.posit_quantize_ste(PositFormat(n), t)
    np.testing.assert_array_equal(bits(y.detach()), bits(JQ.posit_quantize_ste(JFmt(n), x)))
    (y * torch.from_numpy(w)).sum().backward()
    jg = jax.grad(lambda v: jnp.sum(JQ.posit_quantize_ste(JFmt(n), v) * w))(jnp.asarray(x))
    np.testing.assert_array_equal(t.grad.numpy(), w)
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(jg))


@pytest.mark.parametrize("n,pack,unpack,jpack", [
    (16, TQ.pack_posit16, TQ.unpack_posit16, JQ.pack_posit16),
    (8, TQ.pack_posit8, TQ.unpack_posit8, JQ.pack_posit8)])
def test_pack_unpack(n, pack, unpack, jpack):
    p = TQ.quantize_tensor(PositFormat(n), torch.from_numpy(_floats(5000)))
    w = pack(p)
    assert w.element_size() * 8 == n
    ref = np.asarray(jpack(jnp.asarray(p.numpy().astype(np.uint32))))
    np.testing.assert_array_equal(w.numpy(), ref)
    assert torch.equal(unpack(w), p)
    np.testing.assert_array_equal(bits(TQ.dequantize_tensor(PositFormat(n), w)),
                                  bits(TQ.dequantize_tensor(PositFormat(n), p)))


def test_goldens_every_posit8_pair():
    for a in range(256):
        assert TG.decode(a, 8) == JG.decode(a, 8)
        assert TG.to_float(a, 8) == JG.to_float(a, 8) or np.isnan(TG.to_float(a, 8))
        for b in range(256):
            assert TG.div(a, b, 8) == JG.div(a, b, 8), (a, b)


@pytest.mark.parametrize("n", [10, 16, 32])
def test_goldens_sampled(n):
    a, b = RNG.integers(0, 1 << n, (2, 3000), dtype=np.uint64)
    for x, y in zip(a.tolist(), b.tolist()):
        assert TG.div(x, y, n) == JG.div(x, y, n)
    for v in _floats(500).tolist():
        assert TG.from_float(v, n) == JG.from_float(v, n)
    assert list(TG.iter_all(8)) == list(JG.iter_all(8))


def test_table2_matches_reference():
    assert TC.table2() == JC.table2() == TC.PAPER_TABLE2 == JC.PAPER_TABLE2


@pytest.mark.parametrize("n", [8, 16, 32, 64])
@pytest.mark.parametrize("variant", KERNEL_VARIANTS)
def test_estimate_matches_reference(n, variant):
    for pipelined in (True, False):
        t = TC.estimate(PositFormat(n), variant, pipelined)
        j = JC.estimate(JFmt(n), variant, pipelined)
        assert vars(t) == vars(j)
        assert t.delay_ns == j.delay_ns


def test_divider_config_matches_reference():
    jd = importlib.import_module("repro.core.divider")
    from repro_torch.core.divider import VARIANTS

    for name, cfg in VARIANTS.items():
        ref = jd.VARIANTS[name]
        assert (cfg.p_shift, cfg.log2r, cfg.rho_is_one) == (ref.p_shift, ref.log2r,
                                                            ref.rho_is_one)
        for n in (8, 10, 16, 32, 64):
            assert cfg.iterations(PositFormat(n)) == ref.iterations(JFmt(n))
