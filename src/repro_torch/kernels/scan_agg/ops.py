"""Numpy-level shim for scan_agg, with the reference shim's signature
(``repro.kernels.scan_agg.ops.fused_filter_agg``) minus its TPU tiling
knobs: pack the inputs as float64 tensors on ``device``, run the kernel
wrapper, return numpy."""

from __future__ import annotations

import numpy as np
import torch

from .kernel import scan_agg


def fused_filter_agg(cols: np.ndarray, ranges: np.ndarray,
                     pairs: tuple[tuple[int, int], ...],
                     device="cuda") -> np.ndarray:
    """cols: (C, n) float; ranges: (C, 2) inclusive [lo, hi]; returns
    (P+1,) float64 — one sum per pair over the selected rows plus the
    selected count."""
    C, n = cols.shape
    dev = torch.device(device)
    t = torch.as_tensor(np.ascontiguousarray(cols, dtype=np.float64),
                        device=dev)
    rr = np.asarray(ranges, dtype=np.float64)
    lo = torch.as_tensor(np.ascontiguousarray(rr[:, 0]), device=dev)
    hi = torch.as_tensor(np.ascontiguousarray(rr[:, 1]), device=dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    pr = torch.as_tensor(np.asarray(pairs, dtype=np.int32).reshape(-1, 2),
                         device=dev)
    return scan_agg(t, lo, hi, valid, pr).cpu().numpy()
