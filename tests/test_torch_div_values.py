"""The elementwise straight-through posit division (``posit_div_values`` on
any broadcast that is not a per-row divisor: K10's twin) and the rowwise
one it leaves to K2, against the reference's fused backend.

Values are bit-exact; gradients are within 1e-6 relative of ``jax.grad``
through the reference (f32 on both sides: the straight-through backward is
float arithmetic, summed over broadcast axes in another order).  A
broadcast operand's gradient comes back in its own shape.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import bits, one_torch_thread, ref_kernels  # noqa: F401
from repro.numerics import NumericsConfig as JNumerics
from repro.numerics.posit_ops import posit_div_values as j_div_values
from repro_torch.numerics import NumericsConfig, posit_div_values

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RNG = np.random.default_rng(16)
GRAD_RTOL = 1e-6

CASES = {
    "same-shape": ((6, 9), (6, 9)),
    "scalar": ((6, 9), ()),
    "column": ((6, 9), (6, 1)),
    "row-vector": ((6, 9), (9,)),
    "outer": ((6, 1), (6, 9)),
    "both-broadcast": ((4, 1, 9), (1, 5, 9)),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("fmt_name,variant", [("posit16", "srt_r4_cs_of_fr"),
                                              ("posit8", "srt_r2_cs"),
                                              ("posit32", "nrd")])
def test_posit_div_values_matches_reference(ref_kernels, case, fmt_name, variant):
    sa, sb = CASES[case]
    a = np.array(RNG.standard_normal(sa) * 3, np.float32)
    b = np.array(RNG.uniform(0.2, 4.0, sb) * RNG.choice([-1, 1], sb), np.float32)
    w = np.array(RNG.standard_normal(np.broadcast_shapes(sa, sb)), np.float32)
    jcfg = JNumerics(posit_division=True, div_backend="fused", div_format=fmt_name,
                     div_algo=variant)
    ref = j_div_values(jnp.asarray(a), jnp.asarray(b), jcfg)
    jga, jgb = jax.grad(lambda x, y: jnp.sum(j_div_values(x, y, jcfg) * w), (0, 1))(
        jnp.asarray(a), jnp.asarray(b))
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    out = posit_div_values(ta, tb, NumericsConfig(div_format=fmt_name, div_algo=variant))
    np.testing.assert_array_equal(bits(out.detach()), bits(ref))
    (out * torch.from_numpy(w)).sum().backward()
    for got, want in ((ta.grad, jga), (tb.grad, jgb)):
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * float(np.abs(want).max()))
