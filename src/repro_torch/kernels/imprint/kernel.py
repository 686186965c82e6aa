"""Wrapper of the hand-written imprint CUDA kernel (``csrc/imprint.cu``).

``zone_maps`` checks its tensor, then on a CUDA tensor launches the kernel
on the current stream (or raises), and on a CPU tensor runs the plain
version from ``ref.py``.  It never falls back from the kernel to anything.
"""

from __future__ import annotations

import ctypes

import torch

from ..cuda_build import Counter, check, load
from .ref import BINS, BLOCK, zone_maps_ref

LAUNCHES = Counter()  # CUDA kernel launches only
CALLS = Counter()     # every call, either device (shows the route)
_DTYPE_CODE = {torch.int32: 0, torch.int64: 1, torch.float32: 2,
               torch.float64: 3}

_P = ctypes.c_void_p


def _bind(lib):
    if lib.imprint_block_rows() != BLOCK or lib.imprint_bins() != BINS:
        raise RuntimeError("imprint.cu limits disagree with kernel.py")
    fn = lib.imprint_launch
    fn.argtypes = [_P, ctypes.c_int64, ctypes.c_int, ctypes.c_double,
                   ctypes.c_double, ctypes.c_double, ctypes.c_int, _P, _P,
                   _P, _P]
    fn.restype = ctypes.c_int
    return fn


def n_blocks(n: int) -> int:
    return max(1, -(-n // BLOCK))


def zone_maps(values: torch.Tensor, div: float = 1.0, rng=None):
    """Per-block zone maps of one column.

    values: (n,) int32 / int64 / float32 / float64, the column in its
    stored type (integer NULL = the type's sentinel, float NULL = NaN);
    ``div`` divides every value (10**scale for DECIMAL, else 1.0).
    Returns ``(mins, maxs)`` float64 per 2048-row block, +inf / -inf for a
    block without a valid row; with ``rng = (lo, inv)`` it also returns the
    (n_blocks,) int16 bitmaps holding the uint16 bits of the 16-bin
    presence bitmap over ``lo + [0, 16) / inv``."""
    if values.dim() != 1 or values.dtype not in _DTYPE_CODE:
        raise TypeError(f"values must be (n,) int32/int64/float32/float64, "
                        f"got {tuple(values.shape)} {values.dtype}")
    if not values.is_contiguous():
        raise ValueError("values must be contiguous")
    if not div > 0:
        raise ValueError(f"div must be positive, got {div}")
    if rng is not None and not rng[1] >= 0:
        raise ValueError(f"inv must be >= 0, got {rng[1]}")
    CALLS.bump()
    if values.device.type == "cpu":
        return zone_maps_ref(values, div, rng)
    if values.device.type != "cuda":
        raise ValueError(f"zone_maps runs on CUDA or CPU, not "
                         f"{values.device}")
    n = values.shape[0]
    nb = n_blocks(n)
    fn = load("imprint", _bind)
    lo, inv = (0.0, 0.0) if rng is None else (float(rng[0]), float(rng[1]))
    with torch.cuda.device(values.device):
        mins = torch.empty(nb, dtype=torch.float64, device=values.device)
        maxs = torch.empty(nb, dtype=torch.float64, device=values.device)
        bm = None if rng is None else torch.empty(
            nb, dtype=torch.int16, device=values.device)
        stream = torch.cuda.current_stream(values.device).cuda_stream
        rc = fn(values.data_ptr(), n, _DTYPE_CODE[values.dtype],
                float(div), lo, inv, 0 if rng is None else 1,
                mins.data_ptr(), maxs.data_ptr(),
                None if bm is None else bm.data_ptr(), stream)
    check(rc, "imprint")
    LAUNCHES.bump()
    return (mins, maxs) if rng is None else (mins, maxs, bm)
