"""The port's ``numerics/quant.py``, ``core/goldens.py`` and
``core/costmodel.py`` against the reference's, bit for bit (the casts on
K12's twin, the goldens and the cost model pure Python on both sides)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import bits, one_torch_thread  # noqa: F401  (fixture)
from repro.core import costmodel as JC
from repro.core import goldens as JG
from repro.core.posit import PositFormat as JFmt
from repro.numerics import quant as JQ
from repro_torch.core import costmodel as TC
from repro_torch.core import goldens as TG
from repro_torch.core.posit import PositFormat
from repro_torch.kernels.posit_div import KERNEL_VARIANTS
from repro_torch.numerics import quant as TQ

pytestmark = pytest.mark.usefixtures("one_torch_thread")

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


@pytest.mark.parametrize("n", [8, 16, 32])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_round_kv_on_cpu_is_the_reference_rounding(n, dtype):
    """``ops.posit_round_kv`` (the posit-KV path's one call a layer) on CPU
    tensors: K and V each the reference's ``posit_round_value`` cast back
    to their dtype, bit for bit (bf16: every bf16 bit pattern; f32: values
    over the whole range and the specials), in their shapes."""
    from repro_torch.kernels import ops

    if dtype == torch.bfloat16:
        k = (torch.arange(1 << 16, dtype=torch.int32) << 16).view(torch.float32)
        k = k.to(dtype).reshape(64, 4, 4, 64)
    else:
        k = torch.from_numpy(_floats(4085)).reshape(-1, 5, 3, 91)
    v = k.flatten()[: 7 * (k.numel() // 21)].flip(0).reshape(-1, 1, 1, 7)
    got = ops.posit_round_kv(PositFormat(n), k, v)
    for t, r in zip((k, v), got):
        want = JQ.posit_round_value(JFmt(n), jnp.asarray(t.float().numpy()))
        want = torch.from_numpy(np.array(want)).to(dtype)
        assert r.dtype == dtype and r.shape == t.shape
        assert torch.equal(r.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                           want.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))


def test_round_kv_refuses_what_its_kernel_does_not_take():
    """posit64 (no 32-bit pattern), posit10 (no kernel built) and K/V that
    are not bf16 or f32 (or not of one dtype) raise on any device."""
    from repro_torch.core.posit import POSIT16, POSIT64
    from repro_torch.kernels import ops

    x = torch.ones(2, 3)
    with pytest.raises(ValueError, match="n <= 32"):
        ops.posit_round_kv(POSIT64, x, x)
    with pytest.raises(NotImplementedError, match="no kernel is built for Posit10"):
        ops.posit_round_kv(PositFormat(10), x, x)
    for k, v in ((x.long(), x.long()), (x.half(), x.half()), (x, x.to(torch.bfloat16))):
        with pytest.raises(ValueError, match="one dtype"):
            ops.posit_round_kv(POSIT16, k, v)
