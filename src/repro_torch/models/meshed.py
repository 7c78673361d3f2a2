"""The model's computations over a mesh of ranks, where the tensors are
``DTensor``s and the active sharding policy names a mesh
(``parallel.axes``): each is a ``local_map`` that hands every rank its own
shards, runs the one-card code on them, and says how the results and the
gradients lie over the mesh.

* ``embed``: the vocab-sharded table's lookup, each rank's own rows (a
  token outside them reads zeros), summed over ``model`` by the caller's
  ``shard``.
* ``attention``: flash over the policy's attention layout. Heads and kv
  heads both sharded: the op's own sharding rule. Heads sharded over more
  ranks than there are kv heads: each rank takes the kv heads its query
  heads read. Neither (the sequence-sharded fallback): each rank's query
  rows against k and v gathered whole, its ``q_offset`` shifted by the
  rows before its shard.
* ``cached_attention``: decode against a cache whose rows are sharded: each
  rank's rows, then the softmax combined across the ranks (a max and two
  sums over the row axes).
* ``project``: ``[B, S, K] @ [K, D]`` as a batched product, so that rows
  sharded over both the batch and the sequence need no flattened view.
* ``update_rows``: a cache write, each rank writing the new rows that fall
  in its own.
* ``ring_update``: a ring-buffer window cache's shift by the new rows:
  rank-local with kv heads sharded; with rows sharded, each rank keeps
  its own rows past the shift and takes the rest from the next ranks'
  first rows (one all-gather of each rank's first ``min(s, rows a
  rank)`` rows) and from the new rows.
* ``moe``: the expert-parallel MoE block: each rank routes the tokens of
  its dispatch groups over every expert and computes its own experts
  (``E_pad / tp``, tile ids rebased to them); the combine is summed across
  ``model``.
* ``cross_entropy``: the mean next-token loss over vocab-sharded logits.

A gradient that several ranks each hold a part of (k and v read whole, a
replicated weight read by every rank's experts) is declared partial, so
DTensor sums it where it is used.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, List, Optional

import torch

from ..parallel import current_policy, placements
from ..parallel.axes import ShardingPolicy

__all__ = ["mesh_policy", "mesh_context", "embed", "attention", "cached_attention",
           "update_rows", "ring_update", "project", "moe", "cross_entropy"]


def mesh_policy() -> Optional[ShardingPolicy]:
    """The active policy where it names a mesh, else ``None``."""
    pol = current_policy()
    return pol if pol is not None and pol.mesh is not None else None


@contextlib.contextmanager
def mesh_context(pol: ShardingPolicy):
    """``pol`` active, and plain tensors (positions, masks) read as
    replicated DTensors beside DTensors, restored on exit. The per-stage
    recompute enters it again: the backward may run it on the autograd
    engine's device thread, which sees neither the caller's thread-local
    policy nor its flag."""
    from torch.distributed.tensor import DTensor

    from ..parallel import use_policy

    dispatcher = DTensor._op_dispatcher
    prev = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        with use_policy(pol):
            yield
    finally:
        dispatcher._allow_implicit_replication = prev


def _pl(pol: ShardingPolicy, spec, **partial: Any) -> List[Any]:
    """``spec``'s placements, with ``Partial(op)`` on the mesh axes named
    in ``partial`` (axis=op): a list, which ``local_map`` reads as one
    tensor's placements (a tuple of lists as one per output)."""
    from torch.distributed.tensor import Partial

    out = list(placements(spec, pol.mesh))
    for i, name in enumerate(pol.mesh.mesh_dim_names):
        if name in partial:
            out[i] = Partial(partial[name])
    return out


def _dp(pol: ShardingPolicy):
    return pol.dp if pol.batch_shardable else ()


def _coord(pol: ShardingPolicy, axis: str) -> int:
    """This rank's coordinate on ``axis`` (0 on a mesh without it)."""
    names = pol.mesh.mesh_dim_names or ()
    return pol.mesh.get_local_rank(axis) if axis in names else 0


def _offset(global_shape, pol: ShardingPolicy, spec, dim: int) -> int:
    """This rank's first index along ``dim`` of a tensor laid out by
    ``spec``: the mesh dims that shard ``dim`` split it in mesh order, each
    into chunks of ``ceil(size / n)`` as DTensor does."""
    from torch.distributed.tensor import Shard

    coord = pol.mesh.get_coordinate()
    size, offset = int(global_shape[dim]), 0
    for i, p in enumerate(placements(spec, pol.mesh)):
        if isinstance(p, Shard) and p.dim == dim:
            n = pol.mesh.size(i)
            chunk = -(-size // n)
            start = min(coord[i] * chunk, size)
            offset += start
            size = min(chunk, size - start)
    return offset


def _local_map(pol: ShardingPolicy, fn: Callable, out, ins, grads=None):
    from torch.distributed.tensor.experimental import local_map

    return local_map(fn, out_placements=out, in_placements=ins, in_grad_placements=grads,
                     device_mesh=pol.mesh, redistribute_inputs=True)


def embed(ids, table, pol: ShardingPolicy):
    """``table[ids]`` with ``table [V, D]`` sharded over its rows as the
    ``embed`` spec says: partial over those axes (each rank's rows)."""
    dp = _dp(pol)
    tspec = (pol.tp, None)
    tp_axes = (pol.tp,)
    v = table.shape[0]
    ids_spec = (dp, None)

    def body(ids, table):
        v0 = _offset((v, 1), pol, tspec, 0)
        local = ids.long() - v0
        hit = (local >= 0) & (local < table.shape[0])
        rows = torch.nn.functional.embedding(local.clamp(0, table.shape[0] - 1), table)
        return rows * hit[..., None].to(rows.dtype)
    out = _pl(pol, (dp, None, None), **{a: "sum" for a in tp_axes})
    return _local_map(pol, body, out, (_pl(pol, ids_spec), _pl(pol, tspec)),
                      (_pl(pol, ids_spec), _pl(pol, tspec, **{a: "sum" for a in dp})))(
        ids, table)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def attention(q, k, v, pol: ShardingPolicy, *, attend: Callable, q_offset: int = 0,
              **flags):
    """``attend(q, k, v, q_offset=..., **flags)`` (the flash op) over the
    policy's layout of q ``[B, H, Sq, D]`` and k, v ``[B, Hkv, Sk, *]``."""
    dp, tp = _dp(pol), pol.tp
    if pol.shard_heads and pol.shard_kv_heads:
        return attend(q, k, v, q_offset=q_offset, **flags)  # the op's sharding rule
    whole = (dp, None, None, None)
    kv_grad = _pl(pol, whole, **{tp: "sum"})
    if pol.shard_heads:
        n_heads, n_kv = q.shape[1], k.shape[1]
        group = n_heads // n_kv

        def body(q, k, v):
            h_loc = q.shape[1]
            if h_loc % group and group % h_loc:
                raise ValueError(f"attention: {h_loc} query heads a rank do not tile "
                                 f"kv groups of {group}")
            kv0 = _coord(pol, tp) * h_loc // group
            n = max(1, h_loc // group)
            return attend(q, k[:, kv0:kv0 + n].contiguous(), v[:, kv0:kv0 + n].contiguous(),
                          q_offset=q_offset, **flags)
        q_spec = (dp, tp, None, None)
    else:  # the sequence-sharded fallback (policy_for: heads that tp does not divide)
        q_spec = (dp, None, tp, None)
        sq = q.shape[2]

        def body(q, k, v):
            shift = _offset((1, 1, sq, 1), pol, (None, None, tp, None), 2)
            return attend(q, k, v, q_offset=q_offset + shift, **flags)
    qp = _pl(pol, q_spec)
    fn = _local_map(pol, body, qp, (qp, _pl(pol, whole), _pl(pol, whole)),
                    (qp, kv_grad, kv_grad))
    return fn(q, k, v)


def cached_attention(q, k, v, pol: ShardingPolicy, cache_spec, *, local: Callable, **flags):
    """``local(q, k, v, **flags)`` (the plain cached attention) against a
    cache laid out by ``cache_spec``: with kv heads sharded, head by head
    (q's heads alike); with rows sharded, each rank's rows, the softmax's
    max and sums combined across the ranks (``local(..., row0=,
    part="max")`` gives a rank's row max, ``part="sums"`` with the global
    max ``m`` its exp-sums and weighted values). Returns ``[B, H, Sq, Dv]`` in q's dtype, replicated
    over ``model``."""
    from torch.distributed.tensor import DTensor

    # a decode position held as a replicated DTensor: its value on this rank
    flags = {k: a.to_local() if isinstance(a, DTensor) else a for k, a in flags.items()}
    dp = _dp(pol)
    if cache_spec[1] is not None:  # kv heads sharded
        hp = _pl(pol, (dp, pol.tp, None, None))
        return _local_map(pol, lambda q, k, v: local(q, k, v, **flags), hp, (hp, hp, hp))(
            q, k, v)
    rows = cache_spec[2]
    row_axes = rows if isinstance(rows, tuple) else (rows,)
    sk = k.shape[2]
    row0 = lambda: _offset((1, 1, sk, 1), pol, (None, None, rows, None), 2)  # noqa: E731
    whole, cp = _pl(pol, (dp, None, None, None)), _pl(pol, cache_spec)
    full = lambda t: t.redistribute(t.device_mesh, placements((dp,), pol.mesh))  # noqa: E731
    m = _local_map(pol, lambda q, k, v: local(q, k, v, row0=row0(), part="max", **flags),
                   _pl(pol, (dp, None, None), **{a: "max" for a in row_axes}),
                   (whole, cp, cp))(q, k, v)
    summed = _pl(pol, (dp, None, None), **{a: "sum" for a in row_axes})
    l, o = _local_map(pol, lambda q, k, v, m: local(q, k, v, row0=row0(), part="sums", m=m,
                                                    **flags),
                      (summed, _pl(pol, (dp, None, None, None), **{a: "sum" for a in row_axes})),
                      (whole, cp, cp, _pl(pol, (dp, None, None))))(q, k, v, full(m))
    return (full(o) / full(l)[..., None]).to(q.dtype)


def update_rows(c, new, pos, pol: ShardingPolicy, cache_spec, *, write: Callable, dim: int = 2):
    """``write(c, new, pos)`` (``_update_rows``) on a cache laid out by
    ``cache_spec``: with the rows sharded, each rank writes the new rows
    that fall in its own (``new`` gathered whole along the rows); else
    rank by rank as on one card."""
    from torch.distributed.tensor import DTensor

    rows_entry = cache_spec[dim]
    cp = _pl(pol, cache_spec)
    pp = _pl(pol, ()) if isinstance(pos, DTensor) else None
    if rows_entry is None:
        return _local_map(pol, write, cp, (cp, cp, pp))(c, new, pos)
    new_spec = tuple(None if i == dim else e for i, e in enumerate(cache_spec))
    rows = c.shape[dim]

    def body(c, new, pos):
        row0 = _offset(tuple(1 if i != dim else rows for i in range(c.dim())), pol,
                       tuple(None if i != dim else rows_entry for i in range(c.dim())), dim)
        s = new.shape[dim]
        start = torch.clamp(torch.as_tensor(pos, device=c.device).long(), 0, rows - s)
        j = row0 + torch.arange(c.shape[dim], device=c.device) - start  # row in new
        keep = (j < 0) | (j >= s)
        picked = new.index_select(dim, j.clamp(0, s - 1))
        shape = [1] * c.dim()
        shape[dim] = c.shape[dim]
        return torch.where(keep.reshape(shape), c, picked)
    return _local_map(pol, body, cp, (cp, _pl(pol, new_spec), pp))(c, new, pos)


def _spans(size: int, pol: ShardingPolicy, axes) -> List[tuple]:
    """``(first index, length)`` of each rank's chunk of a dim of ``size``
    sharded over the mesh axes ``axes`` (mesh order), in the ranks' order
    along them (the outer axis major): DTensor's nested ``ceil`` chunks,
    as :func:`_offset` computes one rank's."""
    spans = [(0, size)]
    for axis in axes:
        n = pol.mesh.size(pol.mesh.mesh_dim_names.index(axis))
        out = []
        for start, length in spans:
            chunk = -(-length // n)
            for c in range(n):
                first = min(c * chunk, length)
                out.append((start + first, min(chunk, length - first)))
        spans = out
    return spans


def ring_update(c, new, pol: ShardingPolicy, cache_spec, dim: int = 2):
    """A ring-buffer window cache after ``new``'s ``s`` rows: row ``r`` of
    the result is ``cat(c, new)[r + s]`` along ``dim`` (the one-card
    ``cat`` and trailing slice), on a cache laid out by ``cache_spec``.

    With the rows unsharded (kv heads sharded) each rank shifts its own.
    With the rows sharded each rank keeps its rows from ``s`` on, takes the
    ones it lacks from the first rows of the ranks after it along the row
    axes (every rank's first ``min(s, chunk)`` rows all-gathered, O(s) a
    rank, never the whole cache) and from ``new`` gathered whole along the
    rows; with ``s >= rows`` the cache is the last rows of ``new`` and no
    old row moves."""
    from torch.distributed._functional_collectives import all_gather_tensor

    cp = _pl(pol, cache_spec)
    rows_entry = cache_spec[dim]
    if rows_entry is None:
        def shift(c, new):
            return torch.cat([c, new], dim=dim).narrow(dim, new.shape[dim], c.shape[dim])
        return _local_map(pol, shift, cp, (cp, cp))(c, new)
    axes = rows_entry if isinstance(rows_entry, tuple) else (rows_entry,)
    rows = c.shape[dim]
    spans = _spans(rows, pol, axes)
    chunk = max(length for _, length in spans)

    def body(c, new):
        s, n = new.shape[dim], c.shape[dim]
        me = 0
        for axis in axes:
            me = me * pol.mesh.size(pol.mesh.mesh_dim_names.index(axis)) + _coord(pol, axis)
        row0 = spans[me][0]
        if s >= rows:  # the last rows of new; no old row moves
            return new.narrow(dim, s - rows + row0, n)
        h = min(s, chunk)
        head = c.narrow(dim, 0, min(h, n))
        if head.shape[dim] < h:
            pad = list(head.shape)
            pad[dim] = h - head.shape[dim]
            head = torch.cat([head, head.new_zeros(pad)], dim=dim)
        for axis in reversed(axes):  # the inner axis first: the ranks' order
            head = all_gather_tensor(head, dim, (pol.mesh, pol.mesh.mesh_dim_names.index(axis)))
        index = []
        for j in range(n):
            src = row0 + j + s
            if src >= rows:  # past the old rows: new's
                index.append(n + len(spans) * h + src - rows)
            elif src < row0 + n:  # this rank's own
                index.append(j + s)
            else:  # the first rows of the rank that holds it
                k = next(i for i, (first, length) in enumerate(spans)
                         if first <= src < first + length)
                index.append(n + k * h + src - spans[k][0])
        source = torch.cat([c, head, new], dim=dim)
        return source.index_select(dim, torch.tensor(index, dtype=torch.long, device=c.device))

    new_spec = tuple(None if i == dim else e for i, e in enumerate(cache_spec))
    return _local_map(pol, body, cp, (cp, _pl(pol, new_spec)))(c, new)


def project(x, w):
    """``x [B, S, K] @ w [K, D]`` over DTensors: ``einsum`` would flatten
    B and S into one dim, which DTensor cannot shard over two mesh axes
    (batch over the data axes, sequence over ``model``); a batched product
    keeps them apart."""
    return torch.bmm(x, w.expand(x.shape[0], *w.shape))


# ---------------------------------------------------------------------------
# MoE and the loss
# ---------------------------------------------------------------------------

def moe(x, router, w_gate, w_up, w_down, pol: ShardingPolicy, *, core: Callable,
        groups: int, cdt: torch.dtype):
    """``core(x, router, w_gate, w_up, w_down, e0, e_pad, groups)`` (the
    one-card MoE block on a rank's experts ``[e0, e0 + E_loc)`` of
    ``e_pad``, its tokens in ``groups`` dispatch groups) with the experts
    sharded over ``model``. Tokens stay sharded over the data axes where
    the batch's dispatch groups (``min(groups, B)``) are a multiple of the
    data ranks, each rank routing its own groups, else every rank routes
    the whole batch, as a group spanning ranks needs. The result, in
    ``cdt``, is partial over ``model`` (each rank's experts' share), for
    ``shard(.., "act_btd")`` to sum."""
    dp, tp = _dp(pol), pol.tp
    n_groups = max(1, min(groups, x.shape[0]))
    aligned = bool(dp) and n_groups % pol.dp_size == 0
    local_groups = n_groups // pol.dp_size if aligned else n_groups
    x_spec = (dp, None, None) if aligned else (None, None, None)
    # tokens sharded over dp: every weight's grad is a sum over the dp ranks
    over_dp = {a: "sum" for a in dp} if aligned else {}

    def body(x, router, w_gate, w_up, w_down):
        e_loc = w_gate.shape[0]
        return core(x, router, w_gate, w_up, w_down, _coord(pol, tp) * e_loc,
                    pol.tp_size * e_loc, local_groups).to(cdt)

    xp, rp, wp = _pl(pol, x_spec), _pl(pol, (None, None)), _pl(pol, (tp, None, None))
    wgrad = _pl(pol, (tp, None, None), **over_dp)
    grads = (_pl(pol, x_spec, **{tp: "sum"}), _pl(pol, (None, None), **{tp: "sum"}, **over_dp),
             wgrad, wgrad, wgrad)
    fn = _local_map(pol, body, _pl(pol, x_spec, **{tp: "sum"}), (xp, rp, wp, wp, wp), grads)
    return fn(x, router, w_gate, w_up, w_down)


def cross_entropy(logits, labels, vocab: int, pol: ShardingPolicy) -> torch.Tensor:
    """Mean next-token cross entropy over logits ``[B, S, V_pad]`` sharded
    over the vocab (the padded columns masked out, as on one card): each
    rank's max, exp-sum and gold logit over its columns, combined across
    the ranks."""
    dp = _dp(pol)
    lspec = pol.spec("logits")
    vaxes = tuple(a for a in (lspec[2] if isinstance(lspec[2], tuple) else (lspec[2],)))
    v_pad = logits.shape[2]

    def local_cols(lg):
        v0 = _offset((1, 1, v_pad), pol, (None, None, lspec[2]), 2)
        col = v0 + torch.arange(lg.shape[-1], device=lg.device)
        return col, torch.where(col < vocab, lg, -1e30)

    def row_max(lg):
        return local_cols(lg)[1].amax(dim=-1)

    def parts(lg, m, lab):
        col, lg = local_cols(lg)
        se = torch.exp(lg - m[..., None]).sum(dim=-1)
        hit = col == lab.long()[..., None]
        gold = torch.where(hit, lg, 0.0).sum(dim=-1)
        return se, gold

    lp = _pl(pol, lspec)
    row = (dp, None)
    m = _local_map(pol, row_max, _pl(pol, row, **{a: "max" for a in vaxes}), (lp,))(
        logits.detach())
    full = lambda t: t.redistribute(t.device_mesh, placements(row, pol.mesh))  # noqa: E731
    m = full(m)
    se, gold = _local_map(pol, parts, (_pl(pol, row, **{a: "sum" for a in vaxes}),) * 2,
                          (lp, _pl(pol, row), _pl(pol, row)),
                          (lp, _pl(pol, row), _pl(pol, row)))(logits, m, labels)
    lse = m + torch.log(full(se))
    return torch.mean(lse - full(gold))
