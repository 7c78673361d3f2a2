"""The port stands alone: importing every module of ``repro_torch`` loads
neither JAX nor the reference package, no source line imports them, and an
entry point called without ``device=`` on a host without a card raises
instead of moving to the CPU."""

import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch

ROOT = Path(__file__).resolve().parents[1]
PKG_DIR = Path(repro_torch.__file__).resolve().parent

_PROBE = """
import pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    __import__(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "repro.")) or m == "repro")
assert not bad, bad
print(len(names))
"""


def test_importing_every_module_loads_no_jax_and_no_reference():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True, text=True,
                          env=env, cwd=str(ROOT), timeout=120)
    assert proc.returncode == 0, proc.stderr
    n_modules = len(list(pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")))
    assert int(proc.stdout.strip()) == n_modules > 10


_FORBIDDEN = re.compile(r"^\s*(import jax|from jax|import repro\.|from repro[. ])", re.M)


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT))
                                        for p in [*PKG_DIR.rglob("*.py"),
                                                  ROOT / "chip_smoke.py"]))
def test_no_source_imports_jax_or_the_reference(path):
    assert not _FORBIDDEN.findall((ROOT / path).read_text())


def _entry_points():
    from repro_torch.core import BufferPool, DeviceWindowRunner, SlabArena, make_scheduler
    from repro_torch.core import run_serial
    from repro_torch.sim import ENVIRONMENTS, PhysicsEngine

    return {
        "BufferPool": lambda: BufferPool(),
        "SlabArena.pack": lambda: SlabArena().pack(),
        "PhysicsEngine": lambda: PhysicsEngine(ENVIRONMENTS["cheetah"], n_envs=2, group_size=1),
        "DeviceWindowRunner": lambda: DeviceWindowRunner(),
        "make_scheduler[serial]": lambda: make_scheduler("serial"),
        "make_scheduler[wave]": lambda: make_scheduler("wave"),
        "make_scheduler[threaded]": lambda: make_scheduler("threaded"),
        "make_scheduler[device]": lambda: make_scheduler("device"),
        "run_serial": lambda: run_serial([]),
    }


@pytest.mark.parametrize("entry", sorted(_entry_points()))
def test_default_device_without_a_card_raises(entry):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry_points()[entry]()


def test_explicit_cpu_device_runs():
    from repro_torch.core import BufferPool, run_serial

    pool = BufferPool(device="cpu")
    buf = pool.alloc((4,), np.float32, value=np.ones(4, np.float32))
    assert buf.value.device.type == "cpu"
    assert run_serial([], device="cpu").exec_stats["tasks_run"] == 0
