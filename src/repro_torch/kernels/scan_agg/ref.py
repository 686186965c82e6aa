"""Plain PyTorch version of the scan_agg kernel (float64).

The same function as ``csrc/scan_agg.cu``, written with torch operations:
the wrapper in ``kernel.py`` runs it for tensors on the CPU, and the tests
and ``chip_smoke.py`` hold the kernel against it.  Sums run in torch's own
reduction order, so it agrees with the kernel to float64 rounding, not
bit for bit; counts agree exactly.
"""

from __future__ import annotations

import torch


def scan_agg_ref(cols: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                 valid: torch.Tensor, pairs: torch.Tensor) -> torch.Tensor:
    """cols: (C, n) float64; lo, hi: (C,) inclusive bounds; valid: (n,)
    bool; pairs: (P, 2) int32 column pairs (b == -1: column a alone).
    Returns (P + 1,) float64: one sum per pair over the selected rows, then
    the selected count."""
    ok = valid & ((cols >= lo[:, None]) & (cols <= hi[:, None])).all(dim=0)
    a = pairs[:, 0].long()
    b = pairs[:, 1].long()
    # (P, n) terms, indexed on the device: no wait for the pairs on the host
    v = cols[a] * torch.where((b >= 0)[:, None], cols[b.clamp(min=0)], 1.0)
    sums = torch.where(ok, v, 0.0).sum(dim=1)
    return torch.cat([sums, ok.to(torch.float64).sum()[None]])
