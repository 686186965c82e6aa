"""Plain PyTorch versions of the radix_join kernels (float64).

The same functions as ``csrc/radix_join.cu``, written with torch
operations: the wrappers in ``kernel.py`` run them for tensors on the CPU,
and the tests and ``chip_smoke.py`` hold the kernels against them.  The
build adds rows with ``index_add_``, in torch's own order, so it agrees
with the kernel to float64 rounding (exactly for counts and for unique
keys), not bit for bit; the probe is a plain gather and agrees exactly.
"""

from __future__ import annotations

import torch


def radix_build_ref(code: torch.Tensor, vals: torch.Tensor,
                    domain: int) -> torch.Tensor:
    """code: (n,) int32; vals: (V, n) float64.  Returns (domain, V)
    float64 with out[d, v] = sum of vals[v, r] over rows with
    code[r] == d; rows whose code lies outside [0, domain) contribute
    nothing."""
    V, _n = vals.shape
    out = torch.zeros((domain, V), dtype=vals.dtype, device=vals.device)
    ok = (code >= 0) & (code < domain)
    return out.index_add_(0, code[ok].to(torch.int64), vals[:, ok].t())


def radix_probe_ref(code: torch.Tensor, btab: torch.Tensor) -> torch.Tensor:
    """code: (n,) int32; btab: (D, V) float64.  Returns (n, V) float64
    with out[r] = btab[code[r]], zeros where code[r] lies outside
    [0, D)."""
    D = btab.shape[0]
    ok = (code >= 0) & (code < D)
    rows = btab[code.clamp(0, D - 1).to(torch.int64)]
    return torch.where(ok[:, None], rows, 0.0)
