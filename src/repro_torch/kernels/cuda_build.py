"""Build and load the port's hand-written CUDA kernels at first use.

Each kernel is one ``.cu`` file under ``src/repro_torch/csrc/`` with a
plain C interface.  ``load(name, bind)`` compiles it with ``nvcc`` for Hopper
(``sm_90a``) into ``build/`` at the repository root — once per source
content, the file name carries a hash of the source and flags — and opens
the shared library with ``ctypes``.  Nothing here runs at import time: the
CPU tests import every module on a machine with no CUDA toolkit.

``Counter`` is the count of launches (and of calls) each wrapper keeps,
so a run can show that the engine's main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# name -> (bound C entry point, nvcc seconds; 0.0 when already built)
_LIBS: dict = {}
_LIBS_LOCK = threading.Lock()


class Counter:
    """A thread-safe count.  Each kernel wrapper keeps two: ``LAUNCHES``,
    bumped right after a CUDA launch that returned no error and nowhere
    else, and ``CALLS``, bumped on every call (CPU calls run the plain
    version and launch nothing)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0

    def bump(self) -> None:
        with self._lock:
            self._n += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._n

    def reset(self) -> None:
        with self._lock:
            self._n = 0


def nvcc() -> str:
    """Path of the CUDA compiler: PyTorch's notion of the toolkit home
    first, then ``nvcc`` on the PATH."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "need the CUDA toolkit")
    return found


def _build(name: str) -> tuple[Path, float]:
    src = CSRC / f"{name}.cu"
    text = src.read_bytes()
    tag = hashlib.sha1(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"lib{name}-{tag}.so"
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)               # atomic: concurrent builders agree
    return out, seconds


def load(name: str, bind):
    """Kernel ``name``'s entry point: the library is built on first use,
    opened with ``ctypes`` and handed to ``bind``, which declares the C
    function's argument types and returns it.  The build runs outside the
    lock, so kernels loaded from several threads compile in parallel (one
    ``nvcc`` each)."""
    with _LIBS_LOCK:
        entry = _LIBS.get(name)
    if entry is None:
        path, seconds = _build(name)
        fn = bind(ctypes.CDLL(str(path)))
        with _LIBS_LOCK:
            entry = _LIBS.setdefault(name, (fn, seconds))
    return entry[0]


def build_seconds(name: str) -> float:
    """Seconds ``nvcc`` took for ``name`` in this process (0.0 when the
    library was already built, or has not been loaded)."""
    with _LIBS_LOCK:
        entry = _LIBS.get(name)
    return 0.0 if entry is None else entry[1]


def check(rc: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what} failed to launch: CUDA error {rc}")
