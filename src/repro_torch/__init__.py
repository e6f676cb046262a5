"""PyTorch port of the dense Block-Shotgun solver, with hand-written CUDA
kernels for Hopper (sm_90a) in place of the Pallas TPU kernels.

The module layout mirrors ``repro`` (the JAX package, which stays the
reference): ``repro_torch.core.objectives`` is the counterpart of
``repro.core.objectives`` and so on.  Entry points run on the card
(``device="cuda"``) unless the caller asks for the CPU; without a card the
default raises.  The CUDA sources live in ``csrc/`` and are built at first
use by ``kernels/_build.py``; nothing is compiled at import time.
"""
