"""Plain PyTorch versions of the port's kernels: the test oracles and the
CPU path (counterpart of ``repro/kernels/ref.py``). Each runs on any
device; ``chip_smoke.py`` holds every kernel against its plain version on
the card.

``attention_ref`` and ``lru_scan_ref`` follow the reference's oracles of
the same names: fully masked attention rows give 0, and the recurrence
carries its state in float32.

``ready_queue_ref`` is the plain version of ``kernels/ready_queue.py``;
the reference package has no oracle for that kernel, so this one pops
the ring as its Pallas kernel (``_ready_queue_kernel``) does, after the
checks of ``ready_queue_tables_error``, which the CUDA kernel makes on
the device: tables that fail one run no task.

``wave_rows_ref`` is the plain version of ``kernels/wave_elementwise.py``
(the ``[S, D]`` slot rows), and ``wave_elementwise_ref`` the reference's
oracle of the same name (the rows scattered into the slab).

``grouped_matmul_ref`` follows the reference's ragged grouped-GEMM oracle:
each ``block_m``-row tile times its group's weights, in float32.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["attention_ref", "grouped_matmul_ref", "lru_scan_ref", "ready_queue_ref",
           "ready_queue_tables_error", "wave_rows_ref", "wave_elementwise_ref"]


def attention_ref(
    q: torch.Tensor,  # [B, H, Sq, D]
    k: torch.Tensor,  # [B, Hkv, Sk, D]
    v: torch.Tensor,  # [B, Hkv, Sk, Dv]
    *,
    causal: bool = True,
    window: Optional[int] = None,     # local/sliding window size (keys kept)
    softcap: Optional[float] = None,  # gemma2-style logit soft capping
    scale: Optional[float] = None,
    q_offset: int = 0,    # global position of q[0] (decode: Sk - Sq)
    prefix_len: int = 0,  # prefix-LM: first N keys visible to every query
) -> torch.Tensor:
    """Masked softmax attention with GQA, causal/local/prefix masks and
    softcap, in float32; the output is in ``q``'s dtype. Masked logits are
    ``-inf``, so a query row with no visible key gives 0."""
    b, h, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    dv = v.shape[-1]
    if h % hkv:
        raise ValueError(f"attention_ref: {h} query heads over {hkv} kv heads")
    group = h // hkv
    scale = (1.0 / float(np.sqrt(d))) if scale is None else scale

    qg = q.reshape(b, hkv, group, sq, d).float()
    s = torch.einsum("bkgqd,bkld->bkgql", qg, k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)

    rows = q_offset + torch.arange(sq, device=q.device)[:, None]  # global q positions
    cols = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= cols <= rows
    if window is not None:
        mask &= cols > rows - window
    if prefix_len:
        mask |= cols < prefix_len
    s = s.masked_fill(~mask, float("-inf"))

    p = torch.softmax(s, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)  # fully masked rows -> zeros
    out = torch.einsum("bkgql,bkld->bkgqd", p, v.float())
    return out.reshape(b, h, sq, dv).to(q.dtype)


def grouped_matmul_ref(
    x: torch.Tensor,            # [M, K] rows sorted by group, padded per group
    w: torch.Tensor,            # [G, K, N]
    tile_groups: torch.Tensor,  # [M // block_m] int32: group id of each m-tile
    *,
    block_m: int,
) -> torch.Tensor:
    """Ragged grouped GEMM: ``out[t] = x[t] @ w[tile_groups[t // block_m]]``,
    accumulated in float32; the output is in ``x``'s dtype."""
    m, k = x.shape
    n = w.shape[2]
    xt = x.reshape(m // block_m, block_m, k)
    wt = w[tile_groups.long()]  # [T, K, N]
    out = torch.einsum("tmk,tkn->tmn", xt.float(), wt.float())
    return out.reshape(m, n).to(x.dtype)


def lru_scan_ref(
    a: torch.Tensor,   # [B, S, D] decay
    b: torch.Tensor,   # [B, S, D] input
    h0: torch.Tensor,  # [B, D]
) -> torch.Tensor:
    """Diagonal linear recurrence ``h_t = a_t * h_{t-1} + b_t`` with a
    float32 carry; the output is in ``b``'s dtype. Each step is a multiply
    then an add, each rounded to float32 (two eager kernels, no fused
    multiply-add), the rounding the CUDA kernel reproduces bit for bit."""
    af, bf = a.float(), b.float()
    h = h0.float()
    out = torch.empty(b.shape, dtype=torch.float32, device=b.device)
    for t in range(a.shape[1]):
        h = af[:, t] * h + bf[:, t]
        out[:, t] = h
    return out.to(b.dtype)


def ready_queue_tables_error(
    task_tbl: torch.Tensor,   # [n, 5] int32 (branch, in0, in1, in2, out_row)
    dep_tbl: torch.Tensor,    # [n, m] int32 forward edges, sentinel n
    ring0: torch.Tensor,      # [n+1] int32 initially-ready positions, pad n
    rem0: torch.Tensor,       # [n+1] int32 in-degrees + one unused slot
    tail0: torch.Tensor,      # [1] int32 count of initially-ready tasks
    *,
    rows: int,                # the slab's rows
    branches: Sequence[Callable],  # per branch id: fn over 1-3 rows
) -> Optional[str]:
    """What is wrong with one ready-queue epoch's tables, or None when they
    provably drain: every branch id in the table; every row a task's
    branch reads (in0 and in1 always, as every kernel opcode reads two
    rows; in2 only where the branch reads three) and its out row in
    ``[0, rows)``; every live edge pointing forward (``t < dep < n``;
    ``dep == n`` is the sentinel); the in-degrees counted from ``dep_tbl``
    equal to ``rem0[:n]``; and ``ring0[:tail0]`` listing each task whose
    ``rem0`` is 0 exactly once, and nothing else. The CUDA kernel makes the
    same checks on the device before it runs any task."""
    tasks = task_tbl.cpu().numpy().reshape(-1, 5).astype(np.int64)
    deps = dep_tbl.cpu().numpy().astype(np.int64)
    n = deps.shape[0]
    rem = rem0.cpu().numpy().astype(np.int64)[:n]
    tail = int(tail0.reshape(-1)[0])
    if not 0 <= tail <= n:
        return f"tail0 {tail} outside [0, {n}]"
    b = tasks[:, 0]
    bad = (b < 0) | (b >= len(branches))
    if bad.any():
        return f"tasks {np.flatnonzero(bad).tolist()} name a branch outside the table"
    arity = np.array([fn.__code__.co_argcount for fn in branches])[b]
    read = np.concatenate([tasks[:, 1:3], np.where(arity > 2, tasks[:, 3], 0)[:, None],
                           tasks[:, 4:5]], axis=1)
    bad = ((read < 0) | (read >= rows)).any(axis=1)
    if bad.any():
        return f"tasks {np.flatnonzero(bad).tolist()} name a row outside [0, {rows})"
    live = deps != n
    src = np.broadcast_to(np.arange(n)[:, None], deps.shape)
    bad = live & ((deps <= src) | (deps > n))
    if bad.any():
        return f"edges {np.argwhere(bad).tolist()} do not point forward to a task"
    counts = np.bincount(deps[live], minlength=n)
    if not np.array_equal(counts, rem):
        return f"rem0 differs from dep_tbl's in-degrees at {np.flatnonzero(counts != rem).tolist()}"
    ready = ring0.cpu().numpy().astype(np.int64)[:tail]
    if ((ready < 0) | (ready >= n)).any() or len(np.unique(ready)) != tail \
            or (rem[ready] != 0).any() or tail != int((rem == 0).sum()):
        return "ring0[:tail0] is not the set of tasks whose rem0 is 0"
    return None


def ready_queue_ref(
    slab: torch.Tensor,       # [rows, d] the single shape class's slab
    task_tbl: torch.Tensor,   # [n, 5] int32 (branch, in0, in1, in2, out_row)
    dep_tbl: torch.Tensor,    # [n, m] int32 forward edges, sentinel n
    ring0: torch.Tensor,      # [n+1] int32 initially-ready positions, pad n
    rem0: torch.Tensor,       # [n+1] int32 in-degrees + one unused slot
    tail0: torch.Tensor,      # [1] int32 count of initially-ready tasks
    *,
    branches: Sequence[Callable],  # per branch id: fn over 1-3 rows
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One epoch of the ready queue; returns ``(slab', done, ring)``.

    Checks the tables first (:func:`ready_queue_tables_error`). If a check
    fails, no task runs: ``slab'`` is a copy of the slab, ``done`` all 0 and
    ``ring`` a copy of ``ring0``, for the caller to report as a stall. Else
    it pops the ``n`` tasks from the ring in order (FIFO): each pop applies
    ``branches[task[0]]`` to the rows ``task[1:1+arity]`` and writes row
    ``task[4]``, sets ``done[t]``, then walks ``dep_tbl[t]`` in column
    order, decrementing each dependent's counter and appending it to the
    ring when it reaches zero. ``ring[:n]`` is then the pop order, a
    topological order of ``dep_tbl``, and ``ring[n]`` keeps ``ring0[n]``.
    The CUDA kernel gives the same ``slab'`` and ``done``; its ``ring`` is
    the order in which its blocks started the tasks.
    """
    n, m = dep_tbl.shape
    out = slab.clone()
    ring = ring0.tolist()
    done = [0] * n
    if ready_queue_tables_error(task_tbl, dep_tbl, ring0, rem0, tail0, rows=slab.shape[0],
                                branches=branches) is None:
        tasks = task_tbl.tolist()
        deps = dep_tbl.tolist()
        rem = rem0.tolist()
        tail = int(tail0.reshape(-1)[0])
        for i in range(n):
            t = ring[i]
            b, i0, i1, i2, o = tasks[t]
            fn = branches[b]
            out[o] = fn(*(out[r] for r in (i0, i1, i2)[:fn.__code__.co_argcount]))
            done[t] = 1
            for d in deps[t]:
                if d < n:
                    rem[d] -= 1
                    if rem[d] == 0:
                        ring[tail] = d
                        tail += 1
    as_int = dict(dtype=torch.int32, device=slab.device)
    return out, torch.tensor(done, **as_int), torch.tensor(ring, **as_int)


def check_wave_desc(desc: torch.Tensor, rows: int, n_branches: int) -> None:
    """Raise ``ValueError`` when a wave descriptor ``(branch, in0, in1,
    out)`` names a branch outside ``[0, n_branches)`` or a row outside
    ``[0, rows)`` (the CUDA kernel flags the same slots)."""
    d = desc.reshape(-1, 4).cpu().numpy()
    bad = ((d[:, 0] < 0) | (d[:, 0] >= n_branches)
           | (d[:, 1:] < 0).any(axis=1) | (d[:, 1:] >= rows).any(axis=1))
    if bad.any():
        raise ValueError(
            f"wave_elementwise: descriptor slots {np.flatnonzero(bad).tolist()} name a "
            f"branch outside [0, {n_branches}) or a row outside [0, {rows})")


def wave_rows_ref(
    slab: torch.Tensor,   # [R, D] buffer rows
    desc: torch.Tensor,   # [S, 4] int32 (branch, in0_row, in1_row, out_row)
    branches: Sequence[Callable],  # per branch id: fn(x, y) -> [D]
) -> torch.Tensor:
    """One wave's ``[S, D]`` slot rows: row ``si`` is
    ``branches[b](slab[in0], slab[in1])``, one slot at a time, every slot
    reading the unmodified input slab. A bad descriptor raises
    ``ValueError`` (:func:`check_wave_desc`)."""
    check_wave_desc(desc, slab.shape[0], len(branches))
    out = torch.empty((desc.shape[0],) + tuple(slab.shape[1:]), dtype=slab.dtype,
                      device=slab.device)
    for si, (b, i0, i1, _) in enumerate(desc.tolist()):
        out[si] = branches[b](slab[i0], slab[i1])
    return out


def wave_elementwise_ref(slab, opcodes, in_ids, out_ids, branches) -> torch.Tensor:
    """One ACS wave of elementwise tasks over a row slab (the reference's
    loop oracle): slot ``i`` writes ``branches[opcodes[i]](src[in_ids[i,
    0]], src[in_ids[i, 1]])`` at row ``out_ids[i]`` of a copy of the slab,
    reading only the unmodified ``src``."""
    desc = torch.as_tensor(np.concatenate(
        [np.asarray(opcodes).reshape(-1, 1), np.asarray(in_ids).reshape(-1, 2),
         np.asarray(out_ids).reshape(-1, 1)], axis=1).astype(np.int32))
    new = slab.clone()
    new[desc[:, 3].long().to(slab.device)] = wave_rows_ref(slab, desc, branches)
    return new
