"""Wrappers of the hand-written radix_join CUDA kernels
(``csrc/radix_join.cu``): ``radix_build`` and ``radix_probe``.

Each wrapper checks its tensors, then on a CUDA tensor launches its kernel
on the current stream (or raises), and on a CPU tensor runs the plain
version from ``ref.py``.  It never falls back from the kernel to anything.
``BUILD_LAUNCHES``/``PROBE_LAUNCHES`` count CUDA launches only;
``BUILD_CALLS``/``PROBE_CALLS`` count every call.
"""

from __future__ import annotations

import ctypes

import torch

from ..cuda_build import Counter, check, load
from .ref import radix_build_ref, radix_probe_ref

BUILD_LAUNCHES = Counter()
BUILD_CALLS = Counter()
PROBE_LAUNCHES = Counter()
PROBE_CALLS = Counter()
TILE = 256                  # RB_TILE in csrc/radix_join.cu

_P = ctypes.c_void_p


def _bind(lib):
    """Both entry points of the one library (``cuda_build.load`` keeps one
    bound object per source file)."""
    if lib.radix_build_tile() != TILE:
        raise RuntimeError("radix_join.cu limits disagree with kernel.py")
    build = lib.radix_build_launch
    build.argtypes = [_P, _P, _P, ctypes.c_int64, ctypes.c_int,
                      ctypes.c_int, _P, _P, _P]
    build.restype = ctypes.c_int
    probe = lib.radix_probe_launch
    probe.argtypes = [_P, _P, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                      _P, _P]
    probe.restype = ctypes.c_int
    return build, probe


def _check_code(code: torch.Tensor) -> None:
    if code.dtype != torch.int32 or code.dim() != 1:
        raise TypeError(f"code must be (n,) int32, got {tuple(code.shape)} "
                        f"{code.dtype}")


def _check_device(what: str, *tensors) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{what}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on CUDA or CPU, not {dev}")


def radix_build(code: torch.Tensor, vals: torch.Tensor,
                domain: int) -> torch.Tensor:
    """Dense join-table build (a scatter-add by key code).

    code: (n,) int32; vals: (V, n) float64.  Returns (domain, V) float64
    with out[d, v] = sum of vals[v, r] over rows with code[r] == d; rows
    whose code lies outside [0, domain) — the trash code — contribute
    nothing.  With a lane of ones, that lane counts each code's rows."""
    _check_code(code)
    if vals.dtype != torch.float64 or vals.dim() != 2 \
            or vals.shape[1] != code.shape[0]:
        raise TypeError(f"vals must be (V, {code.shape[0]}) float64, got "
                        f"{tuple(vals.shape)} {vals.dtype}")
    if domain < 1 or vals.shape[0] < 1:
        raise ValueError(f"need domain >= 1 and V >= 1, got {domain}, "
                         f"{vals.shape[0]}")
    _check_device("radix_build", code, vals)
    BUILD_CALLS.bump()
    if code.device.type == "cpu":
        return radix_build_ref(code, vals, domain)
    V, n = vals.shape
    build, _probe = load("radix_join", _bind)
    with torch.cuda.device(code.device):
        # rows in code order, equal codes in row order: each code's rows
        # form one run, which the kernel sums in order
        scode, perm = torch.sort(code, stable=True)
        n_tiles = -(-n // TILE)
        edge = torch.empty((max(1, 2 * n_tiles), V), dtype=torch.float64,
                           device=code.device)
        out = torch.zeros((domain, V), dtype=torch.float64,
                          device=code.device)
        stream = torch.cuda.current_stream(code.device).cuda_stream
        rc = build(scode.data_ptr(), perm.data_ptr(), vals.data_ptr(), n, V,
                   domain, edge.data_ptr(), out.data_ptr(), stream)
    check(rc, "radix_build")
    BUILD_LAUNCHES.bump()
    return out


def radix_probe(code: torch.Tensor, btab: torch.Tensor) -> torch.Tensor:
    """Dense join-table probe (a gather by key code).

    code: (n,) int32; btab: (D, V) float64.  Returns (n, V) float64 with
    out[r] = btab[code[r]], zeros where code[r] lies outside [0, D) — so
    lane 0 > 0 is the inner-join match bit when lane 0 holds presence."""
    _check_code(code)
    if btab.dtype != torch.float64 or btab.dim() != 2 \
            or btab.shape[0] < 1 or btab.shape[1] < 1:
        raise TypeError(f"btab must be (D >= 1, V >= 1) float64, got "
                        f"{tuple(btab.shape)} {btab.dtype}")
    _check_device("radix_probe", code, btab)
    PROBE_CALLS.bump()
    if code.device.type == "cpu":
        return radix_probe_ref(code, btab)
    D, V = btab.shape
    n = code.shape[0]
    _build, probe = load("radix_join", _bind)
    with torch.cuda.device(code.device):
        out = torch.empty((n, V), dtype=torch.float64, device=code.device)
        stream = torch.cuda.current_stream(code.device).cuda_stream
        rc = probe(code.data_ptr(), btab.data_ptr(), n, V, D,
                   out.data_ptr(), stream)
    check(rc, "radix_probe")
    PROBE_LAUNCHES.bump()
    return out
