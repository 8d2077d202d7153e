"""Recording the moe router's expert choices, and following them in another
run.

Top-k routing is a step function: where two experts' probabilities nearly
tie, an ulp of a router logit (another device, another library's bf16
product) flips a choice, the capacity ranks behind it change, and the
function with them.  To compare two runs' arithmetic, one run records its
experts and the other follows them: it takes the recorded experts with its
own gates at those experts (:func:`layers.router_gates` given ``eid``) and
computes everything else, the capacity ranks included, itself.  Both hook
``layers.router_gates``, which every :func:`layers.moe_route` calls.
"""

from __future__ import annotations

import contextlib

import torch

from . import layers as L

# a token whose own top k differs from the followed experts must be a
# near-tie: the followed experts' probabilities within this share of its
# largest (a bf16 ulp of a router logit moves a probability about 2^-9 of
# itself)
NEAR_TIE = 2.0 ** -6


@contextlib.contextmanager
def recorded_routes(log: list):
    """Within the block, each router call appends its experts (..., k), on
    the CPU, to ``log``."""
    gates = L.router_gates

    def record(logits, cfg, eid=None):
        out = gates(logits, cfg, eid)
        log.append(out[1].detach().cpu())
        return out

    L.router_gates = record
    try:
        yield
    finally:
        L.router_gates = gates


@contextlib.contextmanager
def followed_routes(log, flips: list):
    """Within the block, the i-th router call takes the experts ``log[i]``
    (a tensor or array of its (..., k) shape).  Each token whose own top k
    differs is appended to ``flips`` as ``(call, token, gap)``: its flat
    index and the largest gap between its own and the followed experts'
    probabilities, relative to its largest."""
    gates = L.router_gates
    calls = iter(enumerate(log))

    def follow(logits, cfg, eid=None):
        i, want = next(calls)
        want = torch.as_tensor(want).to(device=logits.device, dtype=torch.long)
        probs = L._softmax(logits.detach(), cfg)
        top, own = L.top_k(probs, cfg.experts_per_token)
        gap = ((top - torch.gather(probs, -1, want)).abs().amax(-1) / top[..., 0]).reshape(-1)
        for t in torch.nonzero((own != want).any(-1).reshape(-1)).reshape(-1).tolist():
            flips.append((i, t, float(gap[t])))
        return gates(logits, cfg, want)

    L.router_gates = follow
    try:
        yield
    finally:
        L.router_gates = gates
