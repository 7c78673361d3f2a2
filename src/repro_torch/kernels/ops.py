"""Dispatch to the port's kernels, and the ready-queue kernel's fixed
branch table (PyTorch port of ``repro/kernels/ops.py``).

``attention``, ``grouped_matmul`` and ``lru_scan`` are what the models
call. The reference chooses Pallas or its jnp oracle by JAX backend; the
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
would have executed.
"""

from __future__ import annotations

import torch

# The models' entry names; each wrapper picks kernel or plain version by
# its tensors' device.
from .flash_attention import flash_attention as attention
from .grouped_matmul import grouped_matmul
from .lru_scan import lru_scan

__all__ = ["attention", "grouped_matmul", "lru_scan", "wave_step", "register_device_ops",
           "LOOP_BRANCHES", "LOOP_OPCODES", "branch_table", "register_loop_branches"]


def register_device_ops(registry) -> dict:
    """Register the kernel dispatchers as device opcodes, so streams built
    from :class:`~repro_torch.core.AcsKernel`s named after them lower
    through the slab arena (fn-less entries: the arena path runs each
    task's own callable). Returns name -> opcode."""
    return {name: registry.register(name)
            for name in ("attention", "grouped_matmul", "lru_scan")}


def _axpy_row(x, y):
    return 1.5 * x + y + 1.0


def _mul_row(x, y):
    return x * y - 0.5


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
