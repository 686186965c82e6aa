"""Numpy-level shim for radix_join, with the reference shim's signature
(``repro.kernels.radix_join.ops.radix_join``) minus its TPU partitioning
knobs: the keys are rebased to a dense domain starting at the smallest
build key, the build table gets a presence lane of ones, and the two
kernel wrappers run on ``device``."""

from __future__ import annotations

import numpy as np
import torch

from .kernel import radix_build, radix_probe


def radix_join(build_keys: np.ndarray, build_vals: np.ndarray,
               probe_keys: np.ndarray,
               device="cuda") -> tuple[np.ndarray, np.ndarray]:
    """build_keys: (nb,) int, unique; build_vals: (V, nb) float;
    probe_keys: (np,) int.  Returns ``(matched, gathered)``: the (np,) bool
    inner-join bit and the (np, V) float64 build payload (zeros on misses),
    in probe order."""
    bk = np.asarray(build_keys, dtype=np.int64)
    pk = np.asarray(probe_keys, dtype=np.int64)
    V, nb = build_vals.shape
    lo = int(bk.min()) if bk.size else 0
    domain = int((bk - lo).max(initial=0)) + 1
    vals = np.ones((V + 1, nb), dtype=np.float64)          # presence lane
    vals[1:] = build_vals
    dev = torch.device(device)
    btab = radix_build(torch.as_tensor((bk - lo).astype(np.int32),
                                       device=dev),
                       torch.as_tensor(vals, device=dev), domain)
    # probe keys outside the build domain (either side) miss
    pcode = np.clip(pk - lo, -1, domain).astype(np.int32)
    out = radix_probe(torch.as_tensor(pcode, device=dev), btab).cpu().numpy()
    matched = out[:, 0] > 0
    return matched, out[:, 1:]
