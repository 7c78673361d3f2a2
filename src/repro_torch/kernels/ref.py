"""Plain PyTorch versions of the port's kernels: the test oracles and the
CPU path (counterpart of ``repro/kernels/ref.py``). Each runs on any
device; ``chip_smoke.py`` holds every kernel against its plain version on
the card.

``attention_ref`` and ``lru_scan_ref`` follow the reference's oracles of
the same names: fully masked attention rows give 0 (and a gradient of 0,
not NaN: training differentiates ``attention_ref`` on the CPU), and the
recurrence carries its state in float32. ``attention_bwd_ref`` is the
plain version of the flash backward (``flash_attention_bwd.cu``): dq, dk
and dv from the formulas, in float32, given the forward's output and row
log-sum-exp (``attention_lse_ref`` computes the latter).

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
``grouped_matmul_bwd_ref`` is the plain version of its backward
(``dx``, ``dw``), and ``lru_scan_bwd_ref`` that of the recurrence's reverse
scan; the reference has no kernel for either (XLA differentiates its
oracles), so these are the test oracles and the plain versions of
``csrc/grouped_matmul.cu``'s and ``csrc/lru_scan.cu``'s backward entries.

``selective_scan_ref`` is the plain version of ``kernels/selective_scan.py``,
the Mamba recurrence: the reference has no kernel for it, and runs the
``step`` of ``repro/models/recurrent.py`` ``apply_mamba`` under
``lax.scan``; this loop makes the same products in the same order.
``mamba_scan_ref`` is the plain version of ``selective_scan.mamba_scan``:
the span of a Mamba layer around that scan as eager ops, each its own
kernel (softplus of the biased dt projection, ``-exp(A_log)``, the scan,
the ``D`` skip and the ``silu(z)`` gate, the cast to the model dtype).
``selective_scan_bwd_ref`` and ``mamba_scan_bwd_ref`` are their backwards
from the formulas, in float32 (a reverse loop over S): the reference has
no kernel for either (XLA differentiates its ``lax.scan``), so these are
the test oracles and the plain versions of ``csrc/selective_scan.cu``'s
backward entry.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["attention_ref", "attention_lse_ref", "attention_bwd_ref", "grouped_matmul_ref",
           "grouped_matmul_bwd_ref", "lru_scan_ref", "lru_scan_bwd_ref", "ready_queue_ref",
           "ready_queue_tables_error", "selective_scan_ref", "selective_scan_bwd_ref",
           "mamba_scan_ref", "mamba_scan_bwd_ref",
           "wave_rows_ref", "wave_elementwise_ref"]


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
    dv = v.shape[-1]
    s, mask = _scores(q, k, causal=causal, window=window, softcap=softcap, scale=scale,
                      q_offset=q_offset, prefix_len=prefix_len)
    s = s.masked_fill(~mask, float("-inf"))
    # A row that sees no key softmaxes zeros in place of its -inf logits and
    # is then zeroed: 0 out, and 0 (not NaN) back through the softmax.
    seen = mask.any(dim=-1, keepdim=True)
    p = torch.softmax(torch.where(seen, s, 0.0), dim=-1)
    p = torch.where(seen, p, 0.0)
    out = torch.einsum("bkgql,bkld->bkgqd", p, v.float())
    return out.reshape(b, h, sq, dv).to(q.dtype)


def _scores(q, k, *, causal, window, softcap, scale, q_offset, prefix_len):
    """The scaled (and softcapped) scores ``[B, Hkv, group, Sq, Sk]`` in
    float32, and the ``[Sq, Sk]`` mask of the keys each row sees."""
    b, h, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if h % hkv:
        raise ValueError(f"attention_ref: {h} query heads over {hkv} kv heads")
    scale = (1.0 / float(np.sqrt(d))) if scale is None else scale
    qg = q.reshape(b, hkv, h // hkv, sq, d).float()
    s = torch.einsum("bkgqd,bkld->bkgql", qg, k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    return s, _visible(sq, sk, q.device, causal=causal, window=window, q_offset=q_offset,
                       prefix_len=prefix_len)


def _visible(sq, sk, device, *, causal, window, q_offset, prefix_len) -> torch.Tensor:
    """The ``[Sq, Sk]`` mask of the keys each query row sees."""
    rows = q_offset + torch.arange(sq, device=device)[:, None]  # global q positions
    cols = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= cols <= rows
    if window is not None:
        mask &= cols > rows - window
    if prefix_len:
        mask |= cols < prefix_len
    return mask


def attention_lse_ref(q, k, *, causal=True, window=None, softcap=None, scale=None,
                      q_offset=0, prefix_len=0) -> torch.Tensor:
    """Each row's log-sum-exp of its visible scaled (softcapped) scores,
    float32 ``[B, H, Sq]``; -inf for a row that sees no key."""
    b, h, sq, _ = q.shape
    s, mask = _scores(q, k, causal=causal, window=window, softcap=softcap, scale=scale,
                      q_offset=q_offset, prefix_len=prefix_len)
    return torch.logsumexp(s.masked_fill(~mask, float("-inf")), dim=-1).reshape(b, h, sq)


def attention_bwd_ref(q, k, v, o, lse, do, *, causal=True, window=None, softcap=None,
                      scale=None, q_offset=0, prefix_len=0):
    """The gradient of :func:`attention_ref` from the formulas, in float32
    (q and k of width D, v of width Dv): with the visible keys' ``P = exp(s' - lse)`` (s' the scaled,
    softcapped score; 0 for a masked key or a row whose lse is -inf),
    ``Di = rowsum(dO * O)``, ``dS = P * (dO V^T - Di)`` times
    ``1 - tanh^2`` under a softcap, ``dq = scale * dS K``,
    ``dk = scale * dS^T Q`` and ``dv = P^T dO`` (dk and dv summed over each
    kv group's query heads). ``o`` and ``lse`` are the forward's; ``do``,
    ``o`` and dv are Dv wide, Di sums over Dv. Returns ``(dq, dk, dv)`` in
    float32."""
    b, h, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    dv_dim = v.shape[-1]
    group = h // hkv
    scale = (1.0 / float(np.sqrt(d))) if scale is None else scale
    qg = q.reshape(b, hkv, group, sq, d).float()
    s = torch.einsum("bkgqd,bkld->bkgql", qg, k.float()) * scale
    fac = 1.0
    if softcap is not None:
        th = torch.tanh(s / softcap)
        s = softcap * th
        fac = 1.0 - th * th
    mask = _visible(sq, sk, q.device, causal=causal, window=window, q_offset=q_offset,
                    prefix_len=prefix_len)
    lse_g = lse.float().reshape(b, hkv, group, sq, 1)
    live = mask & (lse_g > float("-inf"))
    p = torch.where(live, torch.exp(s - torch.where(live, lse_g, 0.0)), 0.0)
    dog = do.reshape(b, hkv, group, sq, dv_dim).float()
    di = (dog * o.reshape(b, hkv, group, sq, dv_dim).float()).sum(-1, keepdim=True)
    dp = torch.einsum("bkgqd,bkld->bkgql", dog, v.float())
    ds = p * (dp - di) * fac
    dq = torch.einsum("bkgql,bkld->bkgqd", ds, k.float()) * scale
    dk = torch.einsum("bkgql,bkgqd->bkld", ds, qg) * scale
    dv = torch.einsum("bkgql,bkgqd->bkld", p, dog)
    return dq.reshape(b, h, sq, d), dk, dv


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


def grouped_matmul_bwd_ref(
    x: torch.Tensor,            # [M, K] the forward's input
    w: torch.Tensor,            # [G, K, N]
    tile_groups: torch.Tensor,  # [M // block_m] int32
    dy: torch.Tensor,           # [M, N] the output's gradient
    *,
    block_m: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradient of :func:`grouped_matmul_ref`: ``dx[t] = dy[t] @
    w[g_t]^T`` and ``dw[g] = sum of x[t]^T @ dy[t]`` over the tiles ``t``
    of group ``g`` in tile order (0 for a group no tile names; a tile whose
    id lies outside ``[0, G)`` adds nothing to ``dw`` and gets ``dx`` 0).
    Accumulated in float32, returned in ``x``'s and ``w``'s dtypes."""
    m, k = x.shape
    g, _, n = w.shape
    tiles = m // block_m
    dyt = dy.reshape(tiles, block_m, n).float()
    ids = tile_groups.long()
    valid = ((ids >= 0) & (ids < g))[:, None, None]
    dx = torch.where(valid, torch.einsum("tmn,tkn->tmk", dyt, w[ids.clamp(0, g - 1)].float()),
                     0.0)
    per_tile = torch.einsum("tmk,tmn->tkn", x.reshape(tiles, block_m, k).float(), dyt)
    dw = torch.zeros((g, k, n), dtype=torch.float32, device=x.device)
    for t, gid in enumerate(tile_groups.tolist()):
        if 0 <= gid < g:
            dw[gid] += per_tile[t]
    return dx.reshape(m, k).to(x.dtype), dw.to(w.dtype)


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


def lru_scan_bwd_ref(
    a: torch.Tensor,   # [B, S, D] decay
    h: torch.Tensor,   # [B, S, D] the forward's output
    h0: torch.Tensor,  # [B, D]
    dh: torch.Tensor,  # [B, S, D] the output's gradient
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of :func:`lru_scan_ref` by the reverse scan, in float32:
    the carry ``g_{S-1} = dh_{S-1}``, ``g_t = dh_t + a_{t+1} * g_{t+1}``,
    then ``db_t = g_t``, ``da_t = g_t * h_{t-1}`` (``h_{-1} = h0``) and
    ``dh0 = a_0 * g_0``. Each step is one multiply and one add, each
    rounded to float32, as in the forward; ``h`` is the saved output (in
    ``b``'s dtype). Returns ``(da, db, dh0)`` in the dtypes of ``a``, ``h``
    and ``h0``."""
    af, hf, dhf = a.float(), h.float(), dh.float()
    da = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    db = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    seq = a.shape[1]
    g = dhf[:, seq - 1]
    for t in range(seq - 1, -1, -1):
        if t < seq - 1:
            g = dhf[:, t] + af[:, t + 1] * g
        db[:, t] = g
        da[:, t] = g * (hf[:, t - 1] if t > 0 else h0.float())
    return da.to(a.dtype), db.to(h.dtype), (af[:, 0] * g).to(h0.dtype)


def selective_scan_ref(
    dt: torch.Tensor,    # [B, S, E] step sizes
    x: torch.Tensor,     # [B, S, E] inputs
    bmat: torch.Tensor,  # [B, S, N] input projections
    cmat: torch.Tensor,  # [B, S, N] output projections
    a: torch.Tensor,     # [E, N] state decay rates (negative)
    h0: torch.Tensor,    # [B, E, N] initial state
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba's selective scan in float32: for each step ``t``,
    ``h = exp(dt_t[..., None] * a) * h + (dt_t * x_t)[..., None] * b_t[:, None, :]``
    and ``y_t = einsum("ben,bn->be", h, c_t)``. Returns ``(ys [B, S, E],
    hT [B, E, N])``. Each product and sum is its own eager kernel, rounded
    to float32, as in the reference's ``step``."""
    dt, x, bmat, cmat, a = dt.float(), x.float(), bmat.float(), cmat.float(), a.float()
    h = h0.float()
    ys = torch.empty(dt.shape, dtype=torch.float32, device=dt.device)
    for t in range(dt.shape[1]):
        dt_t = dt[:, t]
        da = torch.exp(dt_t[..., None] * a[None])
        h = da * h + (dt_t * x[:, t])[..., None] * bmat[:, t, None, :]
        ys[:, t] = torch.einsum("ben,bn->be", h, cmat[:, t])
    return ys, h


def mamba_scan_ref(
    dt_raw: torch.Tensor,   # [B, S, E] the dt projection's output, model dtype
    dt_bias: torch.Tensor,  # [E] float32
    x: torch.Tensor,        # [B, S, E] the conv + silu output, model dtype
    z: torch.Tensor,        # [B, S, E] the gate branch
    bmat: torch.Tensor,     # [B, S, N]
    cmat: torch.Tensor,     # [B, S, N]
    a_log: torch.Tensor,    # [E, N] float32
    d: torch.Tensor,        # [E] float32 skip weights
    h0: torch.Tensor,       # [B, E, N] float32 initial state
    *,
    out_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """A Mamba layer from its dt projection to its gated output, eagerly:
    ``dt = softplus(dt_raw + dt_bias)`` in float32, ``a = -exp(A_log)``,
    :func:`selective_scan_ref`, ``y = (ys + D * x) * silu(z)``, cast to
    ``out_dtype`` (default: x's dtype, the model's). Returns ``(y,
    hT [B, E, N] float32)``."""
    dt = F.softplus(dt_raw + dt_bias[None, None]).float()
    bmat = bmat.float().contiguous()
    cmat = cmat.float().contiguous()
    a = -torch.exp(a_log)
    xf = x.float()
    ys, h_t = selective_scan_ref(dt.contiguous(), xf.contiguous(), bmat, cmat, a.contiguous(),
                                 h0.contiguous())
    y = ys + d[None, None] * xf
    y = (y * F.silu(z.float())).to(out_dtype or x.dtype)
    return y, h_t


def selective_scan_bwd_ref(
    dt: torch.Tensor,    # [B, S, E]
    x: torch.Tensor,     # [B, S, E]
    bmat: torch.Tensor,  # [B, S, N]
    cmat: torch.Tensor,  # [B, S, N]
    a: torch.Tensor,     # [E, N]
    h0: torch.Tensor,    # [B, E, N]
    dys: torch.Tensor,   # [B, S, E] the gradient of ys
    dht: Optional[torch.Tensor] = None,  # [B, E, N] the gradient of hT
) -> Tuple[torch.Tensor, ...]:
    """The gradient of :func:`selective_scan_ref` from the formulas, in
    float32, by a reverse loop over S. With ``decay_t = exp(dt_t a)``, the
    states ``h_t`` of the forward (kept for every step), the carry
    ``G_{S-1} = dht`` (0 when None) and, for t from S - 1 down to 0,
    ``g_t = dys_t c_t + G_t`` and ``G_{t-1} = decay_t g_t``:
    ``dc_t = sum_e dys_t h_t``, ``db_t = sum_e g_t dt_t x_t``,
    ``dx_t = dt_t sum_n g_t b_t``, ``ddt_t = x_t sum_n g_t b_t + sum_n q_t a``
    and ``da = sum_{b, t} q_t dt_t`` with ``q_t = g_t decay_t h_{t-1}``;
    ``dh0 = G_{-1}``. Returns ``(ddt, dx, db, dc, da, dh0)`` in float32."""
    dt, x, bmat, cmat, a = dt.float(), x.float(), bmat.float(), cmat.float(), a.float()
    dys = dys.float()
    h = h0.float()
    prev = []  # h_{t-1} for each step
    for t in range(dt.shape[1]):
        prev.append(h)
        h = (torch.exp(dt[:, t, :, None] * a[None]) * h
             + (dt[:, t] * x[:, t])[..., None] * bmat[:, t, None, :])
    g_carry = torch.zeros_like(h) if dht is None else dht.float()
    ddt, dx = torch.empty_like(dt), torch.empty_like(dt)
    db, dc = torch.empty_like(bmat), torch.empty_like(cmat)
    da = torch.zeros_like(a)
    for t in range(dt.shape[1] - 1, -1, -1):
        decay = torch.exp(dt[:, t, :, None] * a[None])
        dtx = dt[:, t] * x[:, t]
        h_t = decay * prev[t] + dtx[..., None] * bmat[:, t, None, :]
        g = dys[:, t, :, None] * cmat[:, t, None, :] + g_carry
        dc[:, t] = torch.einsum("ben,be->bn", h_t, dys[:, t])
        db[:, t] = torch.einsum("ben,be->bn", g, dtx)
        gb = torch.einsum("ben,bn->be", g, bmat[:, t])
        q = g * decay * prev[t]
        dx[:, t] = dt[:, t] * gb
        ddt[:, t] = x[:, t] * gb + torch.einsum("ben,en->be", q, a)
        da += torch.einsum("ben,be->en", q, dt[:, t])
        g_carry = decay * g
    return ddt, dx, db, dc, da, g_carry


def mamba_scan_bwd_ref(
    dt_raw: torch.Tensor,   # [B, S, E] model dtype
    dt_bias: torch.Tensor,  # [E] float32
    x: torch.Tensor,        # [B, S, E]
    z: torch.Tensor,        # [B, S, E]
    bmat: torch.Tensor,     # [B, S, N]
    cmat: torch.Tensor,     # [B, S, N]
    a_log: torch.Tensor,    # [E, N] float32
    d: torch.Tensor,        # [E] float32
    h0: torch.Tensor,       # [B, E, N] float32
    dy: torch.Tensor,       # [B, S, E] the gradient of y
    dht: Optional[torch.Tensor] = None,  # [B, E, N] the gradient of hT
) -> Tuple[torch.Tensor, ...]:
    """The gradient of :func:`mamba_scan_ref` from the formulas, in float32:
    with ``v = dt_raw + dt_bias``, ``dt = softplus(v)``, ``a = -exp(A_log)``,
    the scan's ``ys`` and ``gy = dy silu(z)``: :func:`selective_scan_bwd_ref`
    with ``dys = gy``, then ``dx += D gy``, ``dz = dy (ys + D x) silu'(z)``,
    ``dD = sum gy x``, ``d dt_raw = ddt softplus'(v)`` (torch's threshold of
    20: 1 above it, else ``sigmoid(v)``), ``d dt_bias = sum d dt_raw`` and
    ``dA_log = da a``. Returns the gradients of ``(dt_raw, dt_bias, x, z, b,
    c, A_log, D, h0)``, each in its input's dtype."""
    v = dt_raw + dt_bias[None, None]
    dt = F.softplus(v).float()
    a = -torch.exp(a_log)
    xf, zf = x.float(), z.float()
    ys, _ = selective_scan_ref(dt, xf, bmat.float(), cmat.float(), a, h0)
    sig = torch.sigmoid(zf)
    dyf = dy.float()
    gy = dyf * F.silu(zf)
    ddt, dxs, db, dc, da, dh0 = selective_scan_bwd_ref(dt, xf, bmat, cmat, a, h0, gy, dht)
    dz = dyf * (ys + d[None, None] * xf) * (sig * (1 + zf * (1 - sig)))
    ev = torch.exp(v.float())
    ddt_raw = torch.where(v > 20, ddt, ddt * (ev / (ev + 1)))
    return (ddt_raw.to(dt_raw.dtype), ddt_raw.sum((0, 1)), (dxs + d[None, None] * gy).to(x.dtype),
            dz.to(z.dtype), db.to(bmat.dtype), dc.to(cmat.dtype), da * a,
            (gy * xf).sum((0, 1)), dh0.to(h0.dtype))


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
