"""K2's plain twin (the port's rowwise fused divide on the CPU) is
bit-exact against the reference's rowwise Pallas kernel in interpret mode;
the port's RMSNorm and dispatch rules match the reference's."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import bits, bf16_ulp, ref_kernels  # noqa: F401  (fixture)
from repro.configs import get_config as jget
from repro.core.posit import PositFormat as JFmt
from repro.models import layers as JL
from repro_torch.configs import get_config as tget
from repro_torch.core.posit import PositFormat
from repro_torch.kernels import ops as TO
from repro_torch.models import layers as TL
from repro_torch.numerics import NumericsConfig, posit_div_values

JO = importlib.import_module("repro.kernels.ops")
RNG = np.random.default_rng(13)
SPECIALS = np.array([1.5, -2.25, 0.0, -0.0, np.inf, -np.inf, np.nan, 1e30], np.float32)


def _wide(shape):
    return np.array(RNG.standard_normal(shape) * np.exp(RNG.uniform(-15, 15, shape)),
                    dtype=np.float32)


@pytest.mark.parametrize("ashape,bshape", [((8, 96), (8, 1)), ((2, 3, 40), (2, 3, 1)),
                                           ((5, 130), (5, 1)), ((3, 4, 9), (4, 1)),
                                           ((6, 33), ())])
def test_rowwise_matches_reference_kernel(ref_kernels, ashape, bshape):
    a, b = _wide(ashape), _wide(bshape)
    a.reshape(-1)[:len(SPECIALS)] = SPECIALS
    ref = JO.posit_div_fused_rowwise(JFmt(16), jnp.asarray(a), jnp.asarray(b))
    got = TO.posit_div_fused_rowwise(PositFormat(16), torch.from_numpy(a),
                                     torch.from_numpy(b))
    assert got.shape == ashape and got.dtype == torch.float32
    np.testing.assert_array_equal(bits(ref), bits(got))


@pytest.mark.parametrize("n,variant", [(16, "nrd"), (16, "srt_r2_cs_of"), (16, "srt_r4_cs"),
                                       (16, "srt_r4_scaled"), (8, "srt_r4_cs_of_fr"),
                                       (32, "srt_r4_cs_of_fr")])
def test_rowwise_variants_match_reference_kernel(ref_kernels, n, variant):
    a, b = _wide((4, 50)), _wide((4, 1))
    b[0, 0] = 0.0   # a zero divisor row: NaR everywhere
    ref = JO.posit_div_fused_rowwise(JFmt(n), jnp.asarray(a), jnp.asarray(b), variant=variant)
    got = TO.posit_div_fused_rowwise(PositFormat(n), torch.from_numpy(a),
                                     torch.from_numpy(b), variant)
    np.testing.assert_array_equal(bits(ref), bits(got))
    assert torch.isnan(got[0]).all()


@pytest.mark.parametrize("ashape,bshape", [((4, 8), (4, 1)), ((4, 8), (1,)), ((4, 8), ()),
                                           ((4, 8), (4, 8)), ((4, 1), (4, 1)), ((8,), (1,)),
                                           ((2, 4, 8), (4, 1)), ((4, 8), (3, 1)),
                                           ((4, 8), (2, 4, 1)), ((), ())])
def test_rowwise_applicable_matches_reference(ashape, bshape):
    assert TO.rowwise_applicable(ashape, bshape) == JO.rowwise_applicable(ashape, bshape)


def test_rowwise_rejects_bad_shapes_and_devices():
    fmt = PositFormat(16)
    with pytest.raises(ValueError, match="per-row divisor"):
        TO.posit_div_fused_rowwise(fmt, torch.ones(4, 8), torch.ones(4, 8))
    with pytest.raises(ValueError, match="no fused datapath"):
        TO.posit_div_fused_rowwise(fmt, torch.ones(4, 8), torch.ones(4, 1), "bogus")
    # not a CPU tensor and not a CUDA one: no silent fallback to the twin
    with pytest.raises(ValueError, match="device"):
        TO.posit_div_fused_rowwise(fmt, torch.ones(4, 8, device="meta"),
                                   torch.ones(4, 1, device="meta"))


def test_div_values_routes_rowwise_and_refuses_elementwise():
    cfg = NumericsConfig()
    a, b = torch.from_numpy(_wide((3, 16))), torch.from_numpy(_wide((3, 1)))
    np.testing.assert_array_equal(
        bits(posit_div_values(a, b, cfg)),
        bits(TO.posit_div_rowwise_plain(PositFormat(16), a, b)))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        posit_div_values(a, torch.ones(3, 16), cfg)


def test_numerics_config_port_rules():
    assert (NumericsConfig().div_format, NumericsConfig().div_algo) == (
        "posit16", "srt_r4_cs_of_fr")
    NumericsConfig(div_algo="nrd").validate()
    NumericsConfig(div_format="posit32", div_algo="srt_r2").validate()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        NumericsConfig(div_format="posit64").validate()
    with pytest.raises(ValueError, match="div_algo"):
        NumericsConfig(div_algo="bogus").validate()
    with pytest.raises(KeyError, match="posit12"):
        NumericsConfig(div_format="posit12").validate()


def test_rmsnorm_matches_reference(ref_kernels):
    """Same rms divisor -> same bits; the mean's summation order may move
    the divisor by an f32 ulp, so outputs are held within one bf16 ulp."""
    jcfg = jget("smollm_360m", smoke=True, fused=True)
    tcfg = tget("smollm_360m", smoke=True, fused=True)
    x = (RNG.standard_normal((2, 7, 96)) * 3).astype(np.float32)
    w = (RNG.standard_normal(96) * 0.1).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    ref = np.asarray(JL.rmsnorm(xb, jnp.asarray(w), jcfg).astype(jnp.float32))
    got = TL.rmsnorm(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w),
                     tcfg).float().numpy()
    assert np.abs(ref - got).max() <= bf16_ulp(np.abs(ref).max())
    assert (ref == got).mean() > 0.99
