"""Wrapper of the hand-written scan_agg CUDA kernel (``csrc/scan_agg.cu``).

``scan_agg`` checks its tensors, then on a CUDA tensor launches the kernel
on the current stream (or raises), and on a CPU tensor runs the plain
version from ``ref.py``.  It never falls back from the kernel to anything.
"""

from __future__ import annotations

import ctypes

import torch

from ..cuda_build import Counter, check, load
from .ref import scan_agg_ref

LAUNCHES = Counter()  # CUDA kernel launches only
CALLS = Counter()     # every call, either device (shows the route)
TILE_ROWS = 512             # rows per CTA: 128 CTAs for a 64Ki-row batch
MAX_COLS = 32               # SA_MAX_COLS in csrc/scan_agg.cu
MAX_PAIRS = 16              # SA_MAX_PAIRS in csrc/scan_agg.cu

_P = ctypes.c_void_p


def _bind(lib):
    if lib.scan_agg_max_cols() != MAX_COLS \
            or lib.scan_agg_max_pairs() != MAX_PAIRS:
        raise RuntimeError("scan_agg.cu limits disagree with kernel.py")
    fn = lib.scan_agg_launch
    fn.argtypes = [_P, ctypes.c_int64, ctypes.c_int, _P, _P, _P, _P,
                   ctypes.c_int, ctypes.c_int64, _P, _P, _P]
    fn.restype = ctypes.c_int
    return fn


def _check_args(cols, lo, hi, valid, pairs) -> None:
    if cols.dtype != torch.float64 or cols.dim() != 2:
        raise TypeError(f"cols must be (C, n) float64, got "
                        f"{tuple(cols.shape)} {cols.dtype}")
    C, n = cols.shape
    if not 1 <= C <= MAX_COLS:
        raise ValueError(f"scan_agg takes 1..{MAX_COLS} columns, got {C}")
    for name, t, shape, dtype in (("lo", lo, (C,), torch.float64),
                                  ("hi", hi, (C,), torch.float64),
                                  ("valid", valid, (n,), torch.bool)):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise TypeError(f"{name} must be {shape} {dtype}, got "
                            f"{tuple(t.shape)} {t.dtype}")
    if pairs.dtype != torch.int32 or pairs.dim() != 2 \
            or pairs.shape[1] != 2 or pairs.shape[0] > MAX_PAIRS:
        raise TypeError(f"pairs must be (P <= {MAX_PAIRS}, 2) int32, got "
                        f"{tuple(pairs.shape)} {pairs.dtype}")
    for name, t in (("cols", cols), ("lo", lo), ("hi", hi),
                    ("valid", valid), ("pairs", pairs)):
        if t.device != cols.device:
            raise ValueError(f"{name} is on {t.device}, cols on "
                             f"{cols.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def scan_agg(cols: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
             valid: torch.Tensor, pairs: torch.Tensor) -> torch.Tensor:
    """Fused range filter + multi-aggregate scan.

    cols: (C, n) float64; lo, hi: (C,) float64 inclusive bounds (use
    -inf/+inf for unfiltered columns); valid: (n,) bool; pairs: (P, 2)
    int32 column-index pairs, b == -1 meaning column a alone.  A row is
    selected when it is valid and every column lies in its bounds.
    Returns (P + 1,) float64: per pair the sum of cols[a] * cols[b] over
    the selected rows, then the selected count."""
    _check_args(cols, lo, hi, valid, pairs)
    CALLS.bump()
    if cols.device.type == "cpu":
        return scan_agg_ref(cols, lo, hi, valid, pairs)
    if cols.device.type != "cuda":
        raise ValueError(f"scan_agg runs on CUDA or CPU, not {cols.device}")
    C, n = cols.shape
    P = pairs.shape[0]
    fn = load("scan_agg", _bind)
    n_tiles = -(-n // TILE_ROWS)
    with torch.cuda.device(cols.device):
        partials = torch.empty((max(1, n_tiles), P + 1),
                               dtype=torch.float64, device=cols.device)
        out = torch.empty(P + 1, dtype=torch.float64, device=cols.device)
        stream = torch.cuda.current_stream(cols.device).cuda_stream
        rc = fn(cols.data_ptr(), n, C, lo.data_ptr(), hi.data_ptr(),
                valid.data_ptr(), pairs.data_ptr(), P, TILE_ROWS,
                partials.data_ptr(), out.data_ptr(), stream)
    check(rc, "scan_agg")
    LAUNCHES.bump()
    return out
