"""Shims over the sort kernel: ``lexsort``, the multi-key permutation the
engine's device assembly runs (the port's counterpart of the reference
shim's ``lexsort_indices``), and ``sort_block``, the numpy-level
single-key sort with the reference shim's signature
(``repro.kernels.sort.ops.sort_block``) minus its TPU knobs."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .kernel import sort_pairs


def lexsort(keys, limit: Optional[int] = None) -> torch.Tensor:
    """keys: primary-first list of (n,) float64 sort keys on one device.
    Returns the (limit or n,) int64 row permutation of
    ``np.lexsort(tuple(reversed(keys)))``: sorted by ``keys[0]``, ties by
    ``keys[1]``, ..., then by row — a chain of stable sorts from the least
    significant key up, each one a sort kernel launch."""
    n = keys[0].shape[0]
    perm = torch.arange(n, device=keys[0].device)
    if n:
        for k in reversed(keys):
            _, p = sort_pairs(k[perm].contiguous())
            perm = perm[p]
    return perm if limit is None else perm[:limit]


def sort_block(keys: np.ndarray, device="cuda"):
    """keys: (n,) float.  Returns ``(sorted, perm)`` as numpy: ascending
    with NaNs last (read as +inf), ``perm`` the stable permutation."""
    k = torch.as_tensor(np.ascontiguousarray(keys, dtype=np.float64),
                        device=torch.device(device))
    s, p = sort_pairs(k)
    return s.cpu().numpy(), p.cpu().numpy()
