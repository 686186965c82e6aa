"""Plain PyTorch version of the imprint kernel (float64).

The same function as ``csrc/imprint.cu``, written with torch operations:
the wrapper in ``kernel.py`` runs it for tensors on the CPU, and the tests
and ``chip_smoke.py`` hold the kernel against it.  min, max and the bitmap
OR are exact, so the two agree bit for bit.
"""

from __future__ import annotations

import torch

BLOCK = 2048                 # IM_BLOCK in csrc/imprint.cu
BINS = 16                    # IM_BINS
_SENTINEL = {torch.int32: -(2 ** 31), torch.int64: -(2 ** 63)}


def decode(values: torch.Tensor, div: float):
    """``(f, ok)``: each row's float64 value (divided by ``div``, which is
    10**scale for DECIMAL and 1.0 otherwise) and whether it is not NULL
    (not the integer sentinel, not NaN)."""
    if values.dtype in _SENTINEL:
        ok = values != _SENTINEL[values.dtype]
    else:
        ok = ~torch.isnan(values)
    f = values.to(torch.float64)
    # a divisor tensor on the device: torch on CUDA multiplies by the
    # reciprocal of a Python-scalar divisor, which is not IEEE division
    return f / f.new_full((), div), ok


def zone_maps_ref(values: torch.Tensor, div: float = 1.0, rng=None):
    """values: (n,) int32 / int64 / float32 / float64 column.  Returns the
    per-block ``(mins, maxs)`` float64 (+inf / -inf for a block with no
    valid row); with ``rng = (lo, inv)`` also the bitmaps, (n_blocks,)
    int16 holding the uint16 bits of clamp((f - lo) * inv, 0, 15)
    truncated (bin 0 when inv == 0)."""
    n = values.shape[0]
    nb = max(1, -(-n // BLOCK))
    f, ok = decode(values, div)
    pad = nb * BLOCK - n
    f = torch.cat([f, f.new_zeros(pad)]).view(nb, BLOCK)
    ok = torch.cat([ok, ok.new_zeros(pad)]).view(nb, BLOCK)
    mins = torch.where(ok, f, torch.inf).amin(dim=1)
    maxs = torch.where(ok, f, -torch.inf).amax(dim=1)
    if rng is None:
        return mins, maxs
    lo, inv = rng
    if inv > 0:
        x = torch.where(ok, (f - lo) * inv, 0.0)
        bins = x.clamp(0, BINS - 1).to(torch.int64)
    else:
        bins = torch.zeros_like(f, dtype=torch.int64)
    bm = torch.zeros(nb, dtype=torch.int32, device=values.device)
    for b in range(BINS):
        present = (ok & (bins == b)).any(dim=1)
        bm = bm | (present.to(torch.int32) << b)
    return mins, maxs, bm.to(torch.int16)
