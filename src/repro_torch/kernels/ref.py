"""Plain PyTorch versions of the port's kernels: the test oracles and the
CPU path (counterpart of ``repro/kernels/ref.py``).

``ready_queue_ref`` is the plain version of ``kernels/ready_queue.py``;
the reference package has no oracle for that kernel, so this one is
written to do exactly what its Pallas kernel (``_ready_queue_kernel``)
does, step for step.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

__all__ = ["ready_queue_ref"]


def ready_queue_ref(
    slab: torch.Tensor,       # [rows, d] the single shape class's slab
    task_tbl: torch.Tensor,   # [n, 5] int32 (branch, in0, in1, in2, out_row)
    dep_tbl: torch.Tensor,    # [n, m] int32 forward edges, sentinel n
    ring0: torch.Tensor,      # [n+1] int32 initially-ready positions, pad n
    rem0: torch.Tensor,       # [n+1] int32 in-degrees + one trash slot
    tail0: torch.Tensor,      # [1] int32 count of initially-ready tasks
    *,
    branches: Sequence[Callable],  # per branch id: fn over 1-3 rows
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One epoch of the ready queue; returns ``(slab', done, ring)``.

    Pops ``n`` tasks from the ring in order. Each pop applies
    ``branches[task[0]]`` to the rows ``task[1:1+arity]`` and writes row
    ``task[4]``, sets ``done[t]``, then walks ``dep_tbl[t]`` in column
    order: decrement the dependent's counter and write it at ``ring[tail]``
    if it just reached zero (``tail`` advances), else at the trash slot
    ``ring[n]``. A pop that finds no task (``ring[i] >= n``: the queue ran
    dry, which only corrupted tables cause) or a row or branch id out of
    range ends the epoch early, leaving the rest of ``done`` at zero for the
    caller to report; an edge outside ``[0, n]`` counts as the sentinel.
    ``in0``/``in1`` are checked always (every kernel opcode reads two rows),
    ``in2`` only when the branch reads it. The CUDA kernel does the same.
    """
    n, m = dep_tbl.shape
    rows = slab.shape[0]
    out = slab.clone()
    tasks = task_tbl.tolist()
    deps = dep_tbl.tolist()
    ring = ring0.tolist()
    rem = rem0.tolist()
    tail = int(tail0.reshape(-1)[0])
    done = [0] * n
    for i in range(n):
        t = ring[i]
        if not 0 <= t < n:
            break
        b, i0, i1, i2, o = tasks[t]
        if not (0 <= b < len(branches) and 0 <= i0 < rows and 0 <= i1 < rows
                and 0 <= o < rows):
            break
        fn = branches[b]
        k = fn.__code__.co_argcount
        if k > 2 and not 0 <= i2 < rows:
            break
        out[o] = fn(*(out[r] for r in (i0, i1, i2)[:k]))
        done[t] = 1
        for d in deps[t]:
            if not 0 <= d <= n:
                d = n  # a corrupted edge hits the trash slot
            rem[d] -= 1
            ready = d < n and rem[d] == 0
            ring[tail if ready else n] = d
            tail += int(ready)
    as_int = dict(dtype=torch.int32, device=slab.device)
    return out, torch.tensor(done, **as_int), torch.tensor(ring, **as_int)
