"""The port stands alone: importing every module of ``repro_torch`` loads
neither JAX, nor ``ml_dtypes``, nor the reference package, no source line
(the package's, ``chip_smoke.py``'s and the port's examples') imports
them, and an entry point called without ``device=`` on a host without a
card raises instead of moving to the CPU. Its public surface matches the
reference's: ``repro_torch.core``, ``models``, ``runtime``, ``data`` and
``checkpoint``, ``optim`` and ``parallel`` export every name of their
reference packages (``loss_fn``, ``Trainer``, ``TrainerConfig``,
``opt_specs`` and ``policy_for`` among them), each module of the
reference's ``launch`` has a port with every public function of it, and
each name the two ``kernels`` packages share is a function in both or a
module in both."""

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
             if m in ("jax", "repro", "ml_dtypes")
             or m.startswith(("jax.", "jaxlib", "repro.", "ml_dtypes.")))
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


_FORBIDDEN = re.compile(r"^\s*(import jax|from jax|import repro\.|from repro[. ]"
                        r"|import ml_dtypes|from ml_dtypes)", re.M)


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT))
                                        for p in [*PKG_DIR.rglob("*.py"),
                                                  ROOT / "chip_smoke.py",
                                                  *ROOT.glob("examples/torch_*.py")]))
def test_no_source_imports_jax_or_the_reference(path):
    assert not _FORBIDDEN.findall((ROOT / path).read_text())


def _entry_points():
    from repro_torch.core import (AsyncFrontierScheduler, BufferPool, DagRunner, DeviceSession,
                                  DeviceWindowRunner, FrontierSession, GroupExecutor,
                                  MeshDeviceSession, SlabArena)
    from repro_torch.launch import make_window_mesh
    from repro_torch.core import make_scheduler, make_session, run_serial
    from repro_torch.dyn import WORKLOADS, params_from_numpy
    from repro_torch.configs import ARCHS
    from repro_torch.models import init_cache, init_params
    from repro_torch.runtime import ContinuousBatchingServer, SessionServer, Trainer, TrainerConfig
    from repro_torch.sim import ENVIRONMENTS, PhysicsEngine

    cfg = ARCHS["recurrentgemma-2b"].reduced()
    moe = ARCHS["granite-moe-3b-a800m"].reduced()
    return {
        "init_params": lambda: init_params(cfg, 0),
        "init_params[moe]": lambda: init_params(moe, 0),
        "init_cache": lambda: init_cache(cfg, 1, 8),
        **{f"init_params[{name}]": lambda name=name: init_params(ARCHS[name].reduced(), 0)
           for name in ("deepseek-v2-236b", "falcon-mamba-7b", "musicgen-large")},
        "init_cache[mamba]": lambda: init_cache(ARCHS["falcon-mamba-7b"].reduced(), 1, 8),
        "SessionServer": lambda: SessionServer(cfg, init_params(cfg, 0, device="cpu")),
        "ContinuousBatchingServer": lambda: ContinuousBatchingServer(
            cfg, init_params(cfg, 0, device="cpu")),
        "BufferPool": lambda: BufferPool(),
        "SlabArena.pack": lambda: SlabArena().pack(),
        "PhysicsEngine": lambda: PhysicsEngine(ENVIRONMENTS["cheetah"], n_envs=2, group_size=1),
        "DeviceWindowRunner": lambda: DeviceWindowRunner(),
        "DeviceWindowRunner[frontier]": lambda: DeviceWindowRunner(plan_mode="frontier"),
        "DeviceSession": lambda: DeviceSession(),
        "SessionServer[device]": lambda: SessionServer(
            cfg, init_params(cfg, 0, device="cpu"), scheduler="device"),
        "make_session[device]": lambda: make_session("device"),
        "make_session[wave]": lambda: make_session("wave"),
        "make_scheduler[serial]": lambda: make_scheduler("serial"),
        "make_scheduler[wave]": lambda: make_scheduler("wave"),
        "make_scheduler[threaded]": lambda: make_scheduler("threaded"),
        "make_scheduler[device]": lambda: make_scheduler("device"),
        "run_serial": lambda: run_serial([]),
        "GroupExecutor": lambda: GroupExecutor(),
        "FrontierSession": lambda: FrontierSession(),
        "AsyncFrontierScheduler": lambda: AsyncFrontierScheduler(),
        "DagRunner": lambda: DagRunner(),
        "SessionServer[frontier]": lambda: SessionServer(
            cfg, init_params(cfg, 0, device="cpu"), scheduler="frontier"),
        "make_session[frontier]": lambda: make_session("frontier"),
        "make_scheduler[frontier]": lambda: make_scheduler("frontier"),
        "MeshDeviceSession": lambda: MeshDeviceSession(),
        "MeshDeviceSession[n_shards]": lambda: MeshDeviceSession(n_shards=2),
        "make_window_mesh": lambda: make_window_mesh(),
        "make_session[mesh]": lambda: make_session("mesh"),
        "SessionServer[mesh]": lambda: SessionServer(
            cfg, init_params(cfg, 0, device="cpu"), scheduler="mesh"),
        **{f"dyn.init[{name}]": lambda init=init: init(0)
           for name, (init, _, _) in WORKLOADS.items()},
        "dyn.params_from_numpy": lambda: params_from_numpy("squeezenet", {}),
        "Trainer": lambda: Trainer(cfg, TrainerConfig(), ROOT / ".never_written"),
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


def test_public_surface_matches_the_reference():
    import inspect

    import repro.core as R_core
    import repro.kernels as R_kernels
    import repro_torch.core as T_core
    import repro_torch.kernels as T_kernels

    assert set(R_core.__all__) <= set(T_core.__all__)
    shared = set(R_kernels.__all__) & set(T_kernels.__all__)
    assert shared >= {"flash_attention", "grouped_matmul", "lru_scan", "wave_elementwise",
                      "apply_wave", "ops", "ref"}
    for name in sorted(shared):
        assert inspect.ismodule(getattr(T_kernels, name)) == \
            inspect.ismodule(getattr(R_kernels, name)), name
    for name in ("ready_queue", "selective_scan", "ops", "ref"):
        assert inspect.ismodule(getattr(T_kernels, name)), name


@pytest.mark.parametrize("package", ["models", "runtime", "optim", "data", "checkpoint",
                                     "parallel"])
def test_training_surface_matches_the_reference(package):
    import importlib

    theirs = importlib.import_module(f"repro.{package}")
    ours = importlib.import_module(f"repro_torch.{package}")
    assert set(theirs.__all__) <= set(ours.__all__)
    for name in set(theirs.__all__):
        assert callable(getattr(ours, name)) == callable(getattr(theirs, name)), name
    if package == "models":
        assert {"loss_fn", "forward", "init_params"} <= set(ours.__all__)
    if package == "runtime":
        assert {"Trainer", "TrainerConfig"} <= set(ours.__all__)


_REF_LAUNCH = sorted(p.stem for p in (ROOT / "src" / "repro" / "launch").glob("*.py")
                     if p.stem != "__init__")


@pytest.mark.parametrize("module", _REF_LAUNCH)
def test_launch_modules_match_the_reference(module):
    """Every public function of the reference's ``launch/<module>.py`` (read
    from its source: importing some of them sets the XLA device count) is a
    function of the port's module."""
    import ast
    import importlib

    tree = ast.parse((ROOT / "src" / "repro" / "launch" / f"{module}.py").read_text())
    public = {n.name for n in tree.body if isinstance(n, ast.FunctionDef)
              and not n.name.startswith("_")}
    ours = importlib.import_module(f"repro_torch.launch.{module}")
    assert public and all(callable(getattr(ours, name, None)) for name in public), \
        sorted(name for name in public if not callable(getattr(ours, name, None)))
