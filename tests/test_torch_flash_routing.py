"""Which loop of ``csrc/posit_flash_attn.cu`` each kind of forward call
takes (``kernels/posit_flash_attn.flash_loop``): the decode loop (one
query row a block, its kv tiles spread over the block's warps) for the
decode calls (``q_pos``, K4's block table), the tile loop for every other
call (a whole or suffix prefill of any length, a pack, the training
forward).  Each kind of call runs through its layer on the CPU at the smoke
config's size, with a spy on the wrapper it calls; the rule is applied to
the arguments the spy saw, as ``_launch`` applies it on the card."""

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import posit_flash_attn as F
from repro_torch.models import layers
from repro_torch.models import transformer as T

CFG = get_config("smollm_360m", smoke=True)
S = 40   # cache rows


def _setup():
    g = torch.Generator().manual_seed(0)
    p = T.init_params(CFG, g, device="cpu")["layers"][0]
    x = lambda B, n: torch.randn(B, n, CFG.d_model, generator=g).to(layers.COMPUTE_DTYPE)
    cache = lambda B: [torch.zeros(B, S, CFG.n_kv_heads, CFG.head_dim,
                                   dtype=layers.COMPUTE_DTYPE) for _ in range(2)]
    return p, x, cache


def _dense_decode(p, x, cache):
    pos = torch.tensor([5, 17], dtype=torch.int32)
    layers.decode_attention(p, x(2, 1), *cache(2), pos, CFG,
                            torch.tensor([0, 3], dtype=torch.int32))


def _paged_decode(p, x, cache):
    bs, mb = 8, S // 8
    pools = [torch.zeros(2 * mb + 1, bs, CFG.n_kv_heads, CFG.head_dim,
                         dtype=layers.COMPUTE_DTYPE) for _ in range(2)]
    bt = torch.arange(1, 2 * mb + 1, dtype=torch.int32).reshape(2, mb)
    layers.decode_attention_paged(p, x(2, 1), *pools, bt, torch.tensor([5, 17], dtype=torch.int32),
                                  CFG)


def _prefill(p, x, cache, n=30):
    layers.prefill_attention(p, x(2, n), *cache(2), CFG, torch.arange(n)[None].expand(2, n),
                             torch.tensor([0, 4], dtype=torch.int32))


def _suffix(n, t0=10):
    """An ``n``-token suffix after a ``t0``-token shared prefix."""
    def run(p, x, cache):
        rows = [torch.zeros(1, t0 + n, CFG.n_kv_heads, CFG.head_dim,
                            dtype=layers.COMPUTE_DTYPE) for _ in range(2)]
        layers.prefill_suffix_attention(p, x(1, n), *rows, CFG, torch.arange(t0, t0 + n)[None],
                                        None, t0)
    return run


def _packed(p, x, cache):
    seg = torch.tensor([[0] * 12 + [-1] * 4 + [1] * 16], dtype=torch.int32)
    layers.prefill_attention(p, x(1, 32), *cache(1), CFG, torch.arange(32)[None],
                             seg_q=torch.where(seg < 0, -2, seg), seg_kv=seg, seg_len=16)


def _training_forward(p, x, cache):
    layers.attention_block(p, x(2, 24), CFG, torch.arange(24)[None].expand(2, 24))


CALLS = {
    "dense_decode": (_dense_decode, F.ROW_LOOP),
    "paged_decode": (_paged_decode, F.ROW_LOOP),
    "whole_prefill": (_prefill, F.TILE_LOOP),
    "suffix_prefill_1": (_suffix(1), F.TILE_LOOP),
    "suffix_prefill_37": (_suffix(37), F.TILE_LOOP),
    "packed_pack": (_packed, F.TILE_LOOP),
    "k6_forward": (_training_forward, F.TILE_LOOP),
}


@pytest.mark.parametrize("kind", list(CALLS))
def test_each_call_kind_takes_its_loop(monkeypatch, kind):
    seen = []

    def spy(real):
        def call(*args, **kw):
            seen.append(kw)
            return real(*args, **kw)
        return call

    monkeypatch.setattr(layers, "posit_flash_attention", spy(layers.posit_flash_attention))
    monkeypatch.setattr(F, "posit_flash_attention_fwd", spy(F.posit_flash_attention_fwd))
    run, loop = CALLS[kind]
    with torch.no_grad():
        run(*_setup())
    assert len(seen) == 1
    assert F.flash_loop(seen[0].get("q_pos"), seen[0].get("block_tables")) == loop


def test_rule_keys_on_the_call_not_on_its_length():
    q_pos = torch.zeros(1, dtype=torch.int32)
    assert F.flash_loop() == F.TILE_LOOP                      # any prefill, K5, K6
    assert F.flash_loop(q_pos=q_pos) == F.ROW_LOOP            # dense decode
    assert F.flash_loop(block_tables=q_pos[None]) == F.ROW_LOOP   # K4
