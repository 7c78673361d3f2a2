"""Dispatch to the port's kernels, and the ready-queue kernel's fixed
branch table (PyTorch port of ``repro/kernels/ops.py``).

``attention``, ``grouped_matmul``, ``lru_scan`` and ``mamba_scan`` (a
Mamba layer's scan with its softplus, skip and gate; ``selective_scan`` is
the scan alone) are what the models call. The reference chooses Pallas or its jnp oracle by JAX backend; the
port chooses by the tensor's device, inside each kernel's wrapper: a CUDA
tensor launches the hand-written kernel or raises, a CPU tensor takes the
plain version. There is no fallback from a failed build or launch.

``wave_step`` runs one ACS wave of elementwise tasks through the wave
megakernel and scatters its rows back into the slab (the reference's
API; the device window runs a whole plan through
``wave_elementwise.wave_epoch`` instead).

``LOOP_BRANCHES`` are elementwise, row-shape-preserving branches the
device ready queue and the wave kernel may dispatch. They ARE the fns the test and smoke
streams launch: fast-path eligibility checks fn identity against this
table, so the kernel can never silently diverge from what the host path
would have executed. Each rounds its multiply-add once, as the reference's
XLA-compiled kernels and the CUDA kernels do (``_fma``).
"""

from __future__ import annotations

import torch

# The models' entry names; each wrapper picks kernel or plain version by
# its tensors' device.
from .flash_attention import flash_attention as attention
from .grouped_matmul import grouped_matmul
from .lru_scan import lru_scan
from .selective_scan import mamba_scan, selective_scan

__all__ = ["attention", "grouped_matmul", "lru_scan", "mamba_scan", "selective_scan", "wave_step",
           "register_device_ops",
           "LOOP_BRANCHES", "LOOP_OPCODES", "branch_table", "register_loop_branches"]


def register_device_ops(registry) -> dict:
    """Register the kernel dispatchers as device opcodes, so streams built
    from :class:`~repro_torch.core.AcsKernel`s named after them lower
    through the slab arena (fn-less entries: the arena path runs each
    task's own callable). Returns name -> opcode."""
    return {name: registry.register(name)
            for name in ("attention", "grouped_matmul", "lru_scan")}


def _fma(a, b: torch.Tensor, c) -> torch.Tensor:
    """``a * b + c`` rounded once, in ``b``'s dtype: the reference's XLA
    contracts ``1.5 * x + y`` and ``x * y - 0.5`` into fused multiply-adds
    (the jnp oracle and the Pallas kernels alike), and the CUDA kernels run
    ``__fmaf_rn``. PyTorch has no fused multiply-add, so: the product of
    two float32s is exact in float64, the float64 sum is rounded to odd
    (its error, from Knuth's two-sum, decides the sticky last bit), and a
    sum rounded to odd with 29 spare bits rounds to float32 as the exact
    sum does; an infinite or NaN sum is left as it is. Float64 operands
    take the unfused expression."""
    if b.dtype == torch.float64:
        return a * b + c
    p = a * b.double()
    cd = c.double() if isinstance(c, torch.Tensor) else c
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    bits = s.view(torch.int64)
    even = (err != 0) & s.isfinite() & ((bits & 1) == 0)
    toward = torch.where((err > 0) == (s > 0), 1, -1)
    return torch.where(even, bits + toward, bits).view(torch.float64).to(b.dtype)


def _axpy_row(x, y):
    return _fma(1.5, x, y) + 1.0


def _mul_row(x, y):
    return _fma(x, y, -0.5)


LOOP_BRANCHES = {"axpy": _axpy_row, "mul": _mul_row}

# Branch fn -> its opcode in the CUDA kernels (csrc/ready_queue.cu and
# csrc/wave_elementwise.cu, OP_*).
LOOP_OPCODES = {_axpy_row: 0, _mul_row: 1}

# (device, opcodes) -> a branch table on that device, uploaded once.
_TABLES: dict = {}


def branch_table(branches, device):
    """The CUDA kernels' ``[len(branches)] int32`` opcode table for
    ``branches`` (each a :data:`LOOP_BRANCHES` fn) on ``device``: copied to
    the device at its first use, then reused, so a launch makes no
    host-to-device copy of it."""
    key = (device, tuple(LOOP_OPCODES[fn] for fn in branches))
    table = _TABLES.get(key)
    if table is None:
        table = _TABLES[key] = torch.tensor(key[1], dtype=torch.int32, device=device)
    return table


def register_loop_branches(registry) -> dict:
    """Admit :data:`LOOP_BRANCHES` to a device registry's switch table
    (the ready-queue kernel path). Returns name -> opcode."""
    return {name: registry.register_switch_branch(name, fn)
            for name, fn in LOOP_BRANCHES.items()}


def wave_step(slab, desc, *, branches, err=None):
    """Execute one ACS wave of elementwise tasks over the row slab and
    scatter the results back, out of place (see ``wave_elementwise.py``;
    ``err`` is its deferred error flag)."""
    from .wave_elementwise import apply_wave, wave_elementwise

    return apply_wave(slab, desc, wave_elementwise(slab, desc, branches=branches, err=err))
