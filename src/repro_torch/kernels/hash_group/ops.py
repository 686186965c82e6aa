"""Numpy-level shim for hash_group, with the reference shim's signature
(``repro.kernels.hash_group.ops.grouped_aggregate``) minus its TPU tiling
knobs: masked rows go to the trash group, a ones column gives the counts,
and the kernel wrapper runs on ``device``."""

from __future__ import annotations

import numpy as np
import torch

from .kernel import hash_group


def grouped_aggregate(gid: np.ndarray, vals: np.ndarray, n_groups: int,
                      mask: np.ndarray | None = None,
                      device="cuda") -> np.ndarray:
    """gid: (n,) int; vals: (V, n) float; returns (n_groups, V+1) float64 —
    per-group sums for each value column plus the group count in the last
    column."""
    V, n = vals.shape
    g = np.asarray(gid).astype(np.int32)
    if mask is not None:
        g = np.where(mask, g, n_groups).astype(np.int32)   # trash group
    v = np.ones((V + 1, n), dtype=np.float64)               # ones: counts
    v[:V] = vals
    dev = torch.device(device)
    out = hash_group(torch.as_tensor(g, device=dev),
                     torch.as_tensor(v, device=dev), n_groups)
    return out.cpu().numpy()
