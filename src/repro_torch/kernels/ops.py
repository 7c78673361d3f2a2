"""The ready-queue kernel's fixed branch table (PyTorch port of the
``LOOP_BRANCHES`` part of ``repro/kernels/ops.py``).

These are elementwise, row-shape-preserving branches the device ready
queue may dispatch. They ARE the fns the test and smoke streams launch:
fast-path eligibility checks fn identity against this table, so the kernel
can never silently diverge from what the host path would have executed.
"""

from __future__ import annotations

__all__ = ["LOOP_BRANCHES", "LOOP_OPCODES", "register_loop_branches"]


def _axpy_row(x, y):
    return 1.5 * x + y + 1.0


def _mul_row(x, y):
    return x * y - 0.5


LOOP_BRANCHES = {"axpy": _axpy_row, "mul": _mul_row}

# Branch fn -> its opcode in the CUDA kernel (csrc/ready_queue.cu, OP_*).
LOOP_OPCODES = {_axpy_row: 0, _mul_row: 1}


def register_loop_branches(registry) -> dict:
    """Admit :data:`LOOP_BRANCHES` to a device registry's switch table
    (the ready-queue kernel path). Returns name -> opcode."""
    return {name: registry.register_switch_branch(name, fn)
            for name, fn in LOOP_BRANCHES.items()}
