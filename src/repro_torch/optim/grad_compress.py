"""Posit gradient compression: every gradient leaf rounded to a posit grid.

Port of the reference package's ``optim/grad_compress.py``
``compress_gradients``, the fake-quant its trainer applies after the
microbatch accumulation and before AdamW when
``NumericsConfig.grad_compress_format`` is set: each leaf becomes
``posit_to_float(float_to_posit(fmt, g))``, stored in float32.  On the card
each leaf is one launch of K12's round kernel (``ops.posit_round_value``:
f32 in, f32 out, no pattern tensor); on the CPU the twin chain (quantize,
then dequantize) runs.  Both give the reference's bits: RNE to the nearest
posit, saturating at maxpos and minpos, zero kept, NaN to NaR and back to
NaN.

The reference's ring all-reduce with posit payloads (``posit_ring_all_reduce``,
``make_compressed_psum``) moves these patterns between pods; it needs a
sharded mesh, which the port does not have yet (``ROADMAP.md`` section 1
item 8).
"""

from __future__ import annotations

from repro_torch.kernels import ops
from repro_torch.numerics.formats import resolve_format
from repro_torch.optim.tree import tree_map


def compress_gradients(grads, fmt_name: str):
    """A tree shaped like ``grads`` whose every leaf is the leaf as float32
    rounded to the posit format ``fmt_name`` (posit8, posit16 or posit32)."""
    fmt = resolve_format(fmt_name)
    return tree_map(lambda g: ops.posit_round_value(fmt, g), grads)
