"""Build a hand-written CUDA kernel at first use: ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, bound with ``ctypes``.

Each library lands in ``_build/`` beside this file (listed in
``.gitignore``), named by the source's stem and a hash of its bytes and
the flags, so an edited source or flag set builds anew and an unchanged
one is reused. Nothing here runs at import: importing a kernel module
needs no compiler and no card.
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
from typing import Callable, Sequence, Tuple

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "build", "CudaLibrary"]

BUILD_DIR = Path(__file__).resolve().parent / "_build"
# Every kernel: Hopper's arch-specific target, a shared library with a C
# entry point. ``-fmad=false``: no multiply-add contraction, so a kernel's
# float arithmetic rounds step for step like PyTorch's eager kernels.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-fmad=false",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                           "to build the port's CUDA kernels")
    return found


def build(source: Path, flags: Sequence[str] = NVCC_FLAGS) -> Tuple[Path, float]:
    """Compile ``source`` (once per source and flag set). Returns the shared
    library's path and the seconds the compile took (0.0 when it was
    already built)."""
    src = source.read_bytes()
    tag = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"{source.stem}_{tag}.so"
    if lib.exists():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp.so")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *flags, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {source.name}:\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib, time.perf_counter() - t0


class CudaLibrary:
    """One kernel's shared library, built and loaded at first use.
    ``bind(lib)`` sets the entry points' ``argtypes``/``restype``."""

    def __init__(self, source: Path, bind: Callable[[ctypes.CDLL], None],
                 flags: Sequence[str] = NVCC_FLAGS) -> None:
        self.source = source
        self.flags = tuple(flags)
        self._bind = bind
        self._lib = None
        self._lock = threading.Lock()

    def build(self) -> Tuple[Path, float]:
        return build(self.source, self.flags)

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                path, _ = self.build()
                lib = ctypes.CDLL(str(path))
                self._bind(lib)
                self._lib = lib
        return self._lib
