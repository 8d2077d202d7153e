"""PyTorch + CUDA port of the digit-recurrence posit division system.

The JAX package ``repro`` is the reference; this package mirrors its
module layout (``core``, ``kernels``, ``numerics``, ``models``,
``configs``, ``serve``, ``optim``, ``data``, ``train``, ``launch``) and
imports nothing from it.  Every kernel the
reference wrote in Pallas for the TPU is a hand-written CUDA C++ kernel
for Hopper (``sm_90a``) here, built with ``nvcc`` at first use; each has
a plain PyTorch twin that the wrapper runs only for CPU tensors.
"""
