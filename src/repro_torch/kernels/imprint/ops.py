"""Engine-level shim for the imprint kernel, with the reference shim's
contract (``repro.kernels.imprint.ops.build_zone_maps``): float64 mins and
maxs, uint16 bitmaps and the histogram range, as numpy arrays for the
planner's zone-map probes.  The column goes in as a tensor in its stored
type, on the device the kernel wrapper runs on."""

from __future__ import annotations

import numpy as np
import torch

from .kernel import zone_maps
from .ref import BINS


def zone_range(mins: torch.Tensor, maxs: torch.Tensor, nbins: int = BINS):
    """``(lo, hi, inv)`` as Python floats, from the block bounds: the
    smallest and largest valid value and ``nbins / (hi - lo)`` (0.0 for a
    constant or unbounded range; all zeros when no row is valid), as the
    reference's ``ops._range`` computes them from the values."""
    lo = float(mins.min())
    hi = float(maxs.max())
    if lo > hi:                       # no valid row in any block
        return 0.0, 0.0, 0.0
    inv = float(nbins / (hi - lo)) if hi > lo else 0.0
    return lo, hi, inv


def _host(mins, maxs, bm):
    return (mins.cpu().numpy(), maxs.cpu().numpy(),
            bm.cpu().numpy().view(np.uint16))


def build_zone_maps(values: torch.Tensor, div: float = 1.0):
    """Zone maps of a whole column: two launches (bounds, then bounds and
    bitmaps over the column's range).  Returns ``(mins, maxs, bitmaps,
    lo, hi)``."""
    mins, maxs = zone_maps(values, div)
    lo, hi, inv = zone_range(mins, maxs)
    mins, maxs, bm = _host(*zone_maps(values, div, (lo, inv)))
    return mins, maxs, bm, lo, hi


def extend_zone_maps(values: torch.Tensor, div: float, lo: float,
                     hi: float):
    """Zone maps of appended rows, binned against an existing imprint's
    ``(lo, hi)`` (one launch).  Returns ``(mins, maxs, bitmaps)``."""
    inv = (BINS / (hi - lo)) if hi > lo else 0.0
    return _host(*zone_maps(values, div, (lo, inv)))
