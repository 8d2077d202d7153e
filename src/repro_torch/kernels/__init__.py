"""Hand-written Hopper kernels and their plain PyTorch twins.

* ``posit_div``        — the SRT datapath plan and its plain twin (K1's
  arithmetic, one-word plans).
* ``ops``              — the rowwise fused divide wrapper (K2).
* ``posit_flash_attn`` — the dense-layout flash-attention forward (K3).
* ``_build``           — ``nvcc`` build of ``csrc/`` at first use, bound with
  ``ctypes``.
"""
