"""repro_torch: the embedded analytical engine (MonetDBLite repro) ported
to PyTorch, with hand-written CUDA kernels for an NVIDIA H100.

The package stands beside the JAX reference (``repro``) and imports
nothing of it.  Entry point: ``repro_torch.core.startup()``."""

__version__ = "0.1.0"
