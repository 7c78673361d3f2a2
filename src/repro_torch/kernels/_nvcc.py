"""Build a hand-written CUDA kernel at first use: ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, bound with ``ctypes``.

Each library lands in ``_build/`` beside this file (listed in
``.gitignore``), named by the source's stem and a hash of its bytes, the
shared headers' (``csrc/*.cuh``) and the flags, so an edited source,
header or flag set builds anew and an unchanged one is reused. Beside each
library, ``<lib>.ptxas.txt`` keeps what ``ptxas -v`` said of its kernels
(registers, shared memory, spills); :func:`resources` condenses it.
Nothing here runs at import: importing a kernel module needs no compiler
and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "build", "resources", "CudaLibrary", "raw_stream"]

BUILD_DIR = Path(__file__).resolve().parent / "_build"
# Every kernel: Hopper's arch-specific target, a shared library with a C
# entry point. ``-fmad=false``: no multiply-add contraction, so a kernel's
# float arithmetic rounds step for step like PyTorch's eager kernels.
# ``-Xptxas=-v``: each kernel's registers, shared memory and spills.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-fmad=false",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def _find_nvcc() -> Optional[str]:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    return shutil.which("nvcc")


def _nvcc() -> str:
    found = _find_nvcc()
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                           "to build the port's CUDA kernels")
    return found


def build(source: Path, flags: Sequence[str] = NVCC_FLAGS) -> Tuple[Path, float]:
    """Compile ``source`` (once per source and flag set). Returns the shared
    library's path and the seconds the compile took (0.0 when it was
    already built)."""
    src = source.read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(source.parent.glob("*.cuh")))
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
    Path(f"{lib}.ptxas.txt").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib, time.perf_counter() - t0


def _demangle(names: List[str]) -> List[str]:
    """C++ names through the toolkit's ``cu++filt`` (the mangled names
    where it is missing)."""
    nvcc = _find_nvcc()
    tool = Path(nvcc).parent / "cu++filt" if nvcc else None
    if names and tool is not None and tool.exists():
        out = subprocess.run([str(tool)], input="\n".join(names), capture_output=True,
                             text=True)
        if out.returncode == 0 and len(out.stdout.splitlines()) == len(names):
            return out.stdout.splitlines()
    return names


def resources(lib: Path) -> List[str]:
    """One line per kernel of a built library, from its ``ptxas -v`` log:
    registers a thread, static shared memory, stack and spill bytes."""
    log = Path(f"{lib}.ptxas.txt")
    if not log.exists():
        return []
    names, stats, current = [], {}, None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = m.group(1)
            names.append(current)
            stats[current] = {}
            continue
        if current is None:
            continue
        for key, pat in (("registers", r"Used (\d+) registers"), ("smem", r"(\d+) bytes smem"),
                         ("stack", r"(\d+) bytes stack frame"),
                         ("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads")):
            found = re.search(pat, line)
            if found:
                stats[current][key] = int(found.group(1))
    return [f"{pretty.replace('(anonymous namespace)::', '').rsplit('(', 1)[0]}: "
            f"{st.get('registers', '?')} registers, "
            f"{st.get('smem', 0)} B static smem, {st.get('stack', 0)} B stack, "
            f"spills {st.get('spill_stores', 0)}/{st.get('spill_loads', 0)} B"
            for pretty, st in zip(_demangle(names), (stats[n] for n in names))]


def raw_stream(device) -> int:
    """The handle of PyTorch's current CUDA stream on a tensor's ``device``
    (which names its index), for a kernel's C entry point: the raw accessor
    PyTorch's own compiler uses, which builds no ``Stream`` object."""
    import torch

    return torch._C._cuda_getCurrentRawStream(device.index)


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
