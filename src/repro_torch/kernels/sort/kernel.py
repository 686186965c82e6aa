"""Wrapper of the hand-written bitonic sort CUDA kernel (``csrc/sort.cu``).

``sort_pairs`` checks its tensor, then on a CUDA tensor launches the
kernel on the current stream (or raises), and on a CPU tensor runs the
plain version from ``ref.py``.  It never falls back from the kernel to
anything.
"""

from __future__ import annotations

import ctypes

import torch

from ..cuda_build import Counter, check, load
from .ref import sort_pairs_ref

LAUNCHES = Counter()  # CUDA kernel launches only
CALLS = Counter()     # every call, either device (shows the route)
CHUNK = 2048          # SORT_CHUNK in csrc/sort.cu

_P = ctypes.c_void_p


def _bind(lib):
    if lib.sort_chunk() != CHUNK:
        raise RuntimeError("sort.cu limits disagree with kernel.py")
    fn = lib.sort_launch
    fn.argtypes = [_P, ctypes.c_int64, ctypes.c_int64, _P, _P, _P]
    fn.restype = ctypes.c_int
    return fn


def padded_size(n: int) -> int:
    """N: the power of two >= max(n, 2) that the network sorts."""
    return 1 << max(1, (n - 1).bit_length())


def sort_pairs(keys: torch.Tensor):
    """Stable ascending sort of float64 keys.

    keys: (n,) float64.  Returns ``(sorted_keys, perm)``: the keys
    ascending with NaN read as +inf, and the (n,) int64 permutation that
    sorts them, ties in input order — ``torch.sort(stable=True)``'s
    permutation for keys without NaN."""
    if keys.dtype != torch.float64 or keys.dim() != 1:
        raise TypeError(f"keys must be (n,) float64, got "
                        f"{tuple(keys.shape)} {keys.dtype}")
    if keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"sort runs on CUDA or CPU, not {keys.device}")
    if not keys.is_contiguous():
        raise ValueError("keys must be contiguous")
    CALLS.bump()
    n = keys.shape[0]
    if keys.device.type == "cpu":
        return sort_pairs_ref(keys)
    if n == 0:
        return keys.clone(), torch.empty(0, dtype=torch.int64,
                                         device=keys.device)
    N = padded_size(n)
    fn = load("sort", _bind)
    with torch.cuda.device(keys.device):
        kbuf = torch.empty(N, dtype=torch.float64, device=keys.device)
        ibuf = torch.empty(N, dtype=torch.int64, device=keys.device)
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        rc = fn(keys.data_ptr(), n, N, kbuf.data_ptr(), ibuf.data_ptr(),
                stream)
    check(rc, "sort")
    LAUNCHES.bump()
    return kbuf[:n], ibuf[:n]
