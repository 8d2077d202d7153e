"""Fixed-order row sums: the posit divisors' deterministic-order seam.

A copy of ``fixed_order_rowsum`` from the reference package's
``core/quire.py``.  The exact quire accumulator that file also holds is not
ported (``ROADMAP.md``).
"""

from __future__ import annotations

import torch


def fixed_order_rowsum(x, axis: int = -1, keepdims: bool = True):
    """Strictly sequential (left-to-right) float sum along ``axis``.

    ``torch.sum``'s reduction order is the library's choice and varies with
    shape and device; this sum starts from 0 and adds element 0, 1, ... in
    turn, so any two call sites that see the same values in the same order
    give the same bits, and appended exact zeros change nothing.  It is the
    reference's order, so the bits are the reference's on any f32 input.
    The softmax and router-norm divisors are summed so.
    """
    x = torch.as_tensor(x)
    ax = axis % x.ndim
    xt = torch.movedim(x, ax, 0)
    acc = torch.zeros(xt.shape[1:], dtype=x.dtype, device=x.device)
    for j in range(xt.shape[0]):
        acc = acc + xt[j]
    return acc.unsqueeze(ax) if keepdims else acc
