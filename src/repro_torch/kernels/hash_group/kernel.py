"""Wrapper of the hand-written hash_group CUDA kernel
(``csrc/hash_group.cu``).

``hash_group`` checks its tensors, then on a CUDA tensor launches the
kernel on the current stream (or raises), and on a CPU tensor runs the
plain version from ``ref.py``.  It never falls back from the kernel to
anything.
"""

from __future__ import annotations

import ctypes

import torch

from ..cuda_build import Counter, check, load
from .ref import hash_group_ref

LAUNCHES = Counter()  # CUDA kernel launches only
CALLS = Counter()     # every call, either device (shows the route)
MIN_TILE = 512              # rows per CTA at small group domains
MAX_TILE = 8192             # HG_MAX_TILE in csrc/hash_group.cu
PARTIAL_ELEMS = 1 << 22     # target size of the (tiles, G, V) scratch

_P = ctypes.c_void_p


def _bind(lib):
    if lib.hash_group_max_tile() != MAX_TILE:
        raise RuntimeError("hash_group.cu limits disagree with kernel.py")
    fn = lib.hash_group_launch
    fn.argtypes = [_P, _P, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, _P, _P, _P]
    fn.restype = ctypes.c_int
    return fn


def tile_rows(n: int, n_groups: int, n_vals: int) -> int:
    """Rows per CTA: MIN_TILE for small domains; larger tiles for large
    domains, so the per-tile partials stay near PARTIAL_ELEMS.  A function
    of the shapes only, so every run splits a batch the same way."""
    max_tiles = max(1, PARTIAL_ELEMS // max(1, n_groups * n_vals))
    tile = max(MIN_TILE, -(-n // max_tiles))
    return min(MAX_TILE, -(-tile // 256) * 256)


def hash_group(gid: torch.Tensor, vals: torch.Tensor,
               n_groups: int) -> torch.Tensor:
    """Dense-domain grouped sum.

    gid: (n,) int32; vals: (V, n) float64.  Returns (n_groups, V) float64
    with out[g, v] = sum of vals[v, r] over rows with gid[r] == g; rows
    whose gid lies outside [0, n_groups) — the trash group the engine
    sends masked rows to — contribute nothing."""
    if gid.dtype != torch.int32 or gid.dim() != 1:
        raise TypeError(f"gid must be (n,) int32, got {tuple(gid.shape)} "
                        f"{gid.dtype}")
    if vals.dtype != torch.float64 or vals.dim() != 2 \
            or vals.shape[1] != gid.shape[0]:
        raise TypeError(f"vals must be (V, {gid.shape[0]}) float64, got "
                        f"{tuple(vals.shape)} {vals.dtype}")
    if n_groups < 1 or vals.shape[0] < 1:
        raise ValueError(f"need n_groups >= 1 and V >= 1, got {n_groups}, "
                         f"{vals.shape[0]}")
    if gid.device != vals.device:
        raise ValueError(f"gid on {gid.device}, vals on {vals.device}")
    if not (gid.is_contiguous() and vals.is_contiguous()):
        raise ValueError("gid and vals must be contiguous")
    CALLS.bump()
    if gid.device.type == "cpu":
        return hash_group_ref(gid, vals, n_groups)
    if gid.device.type != "cuda":
        raise ValueError(f"hash_group runs on CUDA or CPU, not {gid.device}")
    V, n = vals.shape
    tile = tile_rows(n, n_groups, V)
    fn = load("hash_group", _bind)
    n_tiles = -(-n // tile)
    with torch.cuda.device(gid.device):
        partials = torch.empty((max(1, n_tiles), n_groups, V),
                               dtype=torch.float64, device=gid.device)
        out = torch.empty((n_groups, V), dtype=torch.float64,
                          device=gid.device)
        stream = torch.cuda.current_stream(gid.device).cuda_stream
        rc = fn(gid.data_ptr(), vals.data_ptr(), n, V, n_groups, tile,
                partials.data_ptr(), out.data_ptr(), stream)
    check(rc, "hash_group")
    LAUNCHES.bump()
    return out
