"""Brax-like physics simulation — the paper's workload 1 (§II-B), ported
to PyTorch: many parallel environment instances, each stepped by a stream
of small kernels whose dependency graph is input-dependent."""

from .engine import PhysicsEngine, SimKernelStats, SIM_KERNELS, register_device_kernels
from .envs import ENVIRONMENTS, EnvSpec, make_env

__all__ = ["PhysicsEngine", "SimKernelStats", "SIM_KERNELS",
           "register_device_kernels", "ENVIRONMENTS", "EnvSpec", "make_env"]
