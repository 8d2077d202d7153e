"""Hand-written Hopper kernels and their plain PyTorch twins.

* ``posit_div``        — the SRT datapath plan and its plain twin (K1's
  arithmetic, one-word plans).
* ``ops``              — the rowwise fused divide (K2) and the fused posit
  softmax (K9) wrappers.
* ``posit_flash_attn`` — the dense-layout flash attention: the forward (K3,
  and K6 which saves the row residuals) and the recompute backward (K7, K8),
  with the straight-through autograd wrapper the training path calls.
* ``_build``           — ``nvcc`` build of ``csrc/`` at first use, bound with
  ``ctypes``.
"""
