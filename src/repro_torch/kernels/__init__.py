"""Hand-written Hopper kernels of the port, one package per TPU kernel of
the reference: ``kernel.py`` (the wrapper that launches the CUDA kernel
from ``csrc/``), ``ref.py`` (its plain PyTorch version) and ``ops.py``
(the numpy-level shim with the reference shim's signature)."""
