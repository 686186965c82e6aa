"""Plain PyTorch version of the hash_group kernel (float64).

The same function as ``csrc/hash_group.cu``, written with torch operations:
the wrapper in ``kernel.py`` runs it for tensors on the CPU, and the tests
and ``chip_smoke.py`` hold the kernel against it.  Rows are compared with
every group id in chunks that bound the (G, V, chunk) temporary; sums run
in torch's own reduction order, so it agrees with the kernel to float64
rounding, not bit for bit.
"""

from __future__ import annotations

import torch

_CHUNK_ELEMS = 1 << 24          # (G, V, chunk) temporary, in elements


def hash_group_ref(gid: torch.Tensor, vals: torch.Tensor,
                   n_groups: int) -> torch.Tensor:
    """gid: (n,) int32; vals: (V, n) float64.  Returns (n_groups, V)
    float64 with out[g, v] = sum of vals[v, r] over rows with gid[r] == g;
    rows whose gid lies outside [0, n_groups) contribute nothing."""
    V, n = vals.shape
    out = torch.zeros((n_groups, V), dtype=vals.dtype, device=vals.device)
    groups = torch.arange(n_groups, dtype=gid.dtype, device=gid.device)
    step = max(1, _CHUNK_ELEMS // max(1, n_groups * V))
    for s in range(0, n, step):
        hit = gid[None, s:s + step] == groups[:, None]         # (G, c)
        out += torch.where(hit[:, None, :], vals[None, :, s:s + step],
                           0.0).sum(dim=-1)
    return out
