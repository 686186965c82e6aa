"""Plain PyTorch version of the bitonic sort kernel.

The same function as ``csrc/sort.cu``: a stable ascending sort of float64
keys, with NaN read as +inf.  The wrapper in ``kernel.py`` runs it for
tensors on the CPU, and the tests and ``chip_smoke.py`` hold the kernel
against it; both give the same permutation exactly.
"""

from __future__ import annotations

import math

import torch


def sort_pairs_ref(keys: torch.Tensor):
    """keys: (n,) float64.  Returns ``(sorted_keys, perm)``: the keys
    ascending with NaN read as +inf, and the (n,) int64 stable sort
    permutation (ties keep their input order)."""
    k = torch.where(torch.isnan(keys), math.inf, keys)
    return torch.sort(k, stable=True)
