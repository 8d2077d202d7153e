"""PyTorch + CUDA port of the digit-recurrence posit division system.

The JAX package ``repro`` is the reference; this package mirrors its
module layout (``core``, ``kernels``, ``numerics``, ``models``,
``configs``, ``serve``, ``optim``, ``data``, ``train``, ``launch``) and
imports nothing from it.  Every kernel the
reference wrote in Pallas for the TPU is a hand-written CUDA C++ kernel
for Hopper (``sm_90a``) here, built with ``nvcc`` at first use; each has
a plain PyTorch twin that the wrapper runs only for CPU tensors.
"""

import torch as _torch

# torch's CPU exp has, on its first call in a process that spreads over the
# intra-op threads, now and then returned one 2048-element chunk about 3e-5
# relative off (in 1-5% of fresh processes on an 8-thread host; never with
# one thread, never on a later call).  The CPU twins call exp, and such a
# first call moved a posit32 gradient 3.7e-5 and a twin's output 9.8e-4 in
# one run each.  So that first call is made here, on a throwaway tensor that
# spreads over every thread, before any twin runs.
_torch.exp(_torch.zeros(max(1 << 16, 2048 * _torch.get_num_threads())))
