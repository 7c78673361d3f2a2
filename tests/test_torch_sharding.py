"""The port's sharding specs against the reference's, on stub meshes (no
process group, no device): ``policy_for``'s fields, every leaf of
``param_specs`` (the port's per-stage leaves against the reference's
stacked ones without their leading ``None``, matched through
``models.convert``'s layout), ZeRO-1's ``opt_specs``, ``batch_specs`` and
``cache_specs``, for all ten archs on the 16 x 16 and 2 x 16 x 16 meshes at
each ``SHAPES`` batch and at batch 1, all equal exactly. And for each
arch's ``train_4k``, rank 0's argument bytes (parameters, AdamW state,
inputs) from the port's DTensor placements (DTensor's chunking, mesh dim by
mesh dim) equal the bytes reckoned from the reference's specs over
``jax.eval_shape`` shapes (JAX's padded shards).

ZeRO-1 is compared as the reference's rule over the port's layout: on its
own stacked leaves the reference may put the data axes on the stage axis
(where ``n_stages`` divides them), which a per-stage leaf has not; there
its specs equal the port's but for that axis, and the port's optimizer
state is at least as large (falcon-mamba's 1-D Mamba leaves stay
replicated over ``data``).
"""

import functools
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from repro import models as RM
from repro.configs import ARCHS as R_ARCHS
from repro.configs import SHAPES as R_SHAPES
from repro.launch.steps import input_specs as r_input_specs
from repro.optim import adamw_init as r_adamw_init
from repro.optim import opt_specs as r_opt_specs
from repro.parallel import sharding as RS
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.launch.steps import input_specs
from repro_torch.models.transformer import param_shapes, split_pattern
from repro_torch.optim import opt_specs
from repro_torch.parallel import (batch_specs, cache_specs, param_specs, placements,
                                  policy_for)
from repro_torch.tree import tree_leaves_with_names

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
BATCHES = sorted({b for _, b, _ in SHAPES.values()} | {1})
POLICY_FIELDS = ("dp", "tp", "shard_heads", "shard_kv_heads", "shard_experts",
                 "seq_shard_attn", "tp_size", "dp_size", "batch_shardable")


def _stub(mesh_name):
    shape, names = MESHES[mesh_name]
    return SimpleNamespace(axis_names=names, devices=np.empty(shape, dtype=object))


@functools.lru_cache(maxsize=None)
def _ref_shapes(arch):
    """The reference's parameter shapes (``jax.eval_shape``), once per arch."""
    return jax.eval_shape(lambda k: RM.init_params(R_ARCHS[arch], k, tp_size=16),
                          jax.random.PRNGKey(0))


def _norm(spec):
    """A spec (the port's tuple or a ``PartitionSpec``) as a tuple of name
    tuples, one per dim."""
    out = []
    for e in tuple(spec):
        out.append(() if e is None else (tuple(e) if isinstance(e, (tuple, list)) else (e,)))
    return tuple(out)


def _is_spec(x):
    return isinstance(x, jax.sharding.PartitionSpec)


def _ref_named(tree):
    """The reference's spec tree as {name: spec}, names as the checkpoint
    names them."""
    leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=_is_spec)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): _norm(s)
            for path, s in leaves}


def _port_named(tree, n_stages):
    """The port's spec tree in the reference's layout: stage 0's specs
    stand for the stacked leaves, with the stage axis's ``None`` in front
    (every stage's specs equal)."""
    out = {}
    for key, value in tree.items():
        if key == "stages":
            if not value:
                continue
            assert all(stage == value[0] for stage in value)
            for name, spec in _walk(value[0], "stages"):
                out[name] = ((),) + _norm(spec)
        else:
            for name, spec in _walk(value, key):
                out[name] = _norm(spec)
    return out


def _walk(tree, prefix):
    """(name, spec) pairs of a spec tree whose leaves are spec tuples."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, list) or (isinstance(tree, tuple) and tree
                                    and isinstance(tree[0], (dict, list))):
        for i, t in enumerate(tree):
            yield from _walk(t, f"{prefix}/{i}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_specs_equal_the_reference(arch, mesh_name):
    cfg, rcfg = ARCHS[arch], R_ARCHS[arch]
    mesh = _stub(mesh_name)
    rshapes = _ref_shapes(arch)
    ours_shapes = param_shapes(cfg, tp_size=16)
    _, n_stages = split_pattern(cfg)
    for batch in [None] + BATCHES:
        pol, rpol = policy_for(cfg, mesh, batch=batch), RS.policy_for(rcfg, mesh, batch=batch)
        assert {f: getattr(pol, f) for f in POLICY_FIELDS} == \
            {f: getattr(rpol, f) for f in POLICY_FIELDS}, batch
        for kind in ("train", "prefill", "decode"):
            ours_b = batch_specs(cfg, pol, kind)
            theirs_b = RS.batch_specs(rcfg, rpol, kind)
            if kind == "train":
                assert [_norm(s) for s in ours_b] == [_norm(s) for s in theirs_b]
            else:
                assert _norm(ours_b) == _norm(theirs_b)

        ours_p = param_specs(ours_shapes, pol)
        theirs_p = RS.param_specs(rshapes, rpol)
        want = _ref_named(theirs_p)
        got = _port_named(ours_p, n_stages)
        assert got == want, batch

        # ZeRO-1: the reference's rule over the port's layout, exactly; over
        # its own stacked layout it may put the data axes on the stage axis
        # (where n_stages divides them), which per-stage leaves cannot have
        dp_size = int(np.prod([s for a, s in zip(*MESHES[mesh_name][::-1]) if a != "model"]))
        ours_o = opt_specs(ours_p, pol.dp, dp_size, ours_shapes)
        port_layout = _to_jax(ours_p, ours_shapes)
        theirs_o = r_opt_specs(*port_layout[:1], rpol.dp, dp_size, port_layout[1])
        stacked = r_opt_specs(theirs_p, rpol.dp, dp_size,
                              jax.eval_shape(r_adamw_init, rshapes)["master"])
        assert _norm(ours_o["step"]) == _norm(theirs_o["step"]) == _norm(stacked["step"])
        for k in ("master", "m", "v"):
            got = _port_named(ours_o[k], n_stages)
            assert got == _port_named(_from_jax(theirs_o[k]), n_stages), (batch, k)
            for name, spec in _ref_named(stacked[k]).items():
                assert got[name] == spec or (name.startswith("stages/") and spec[0]
                                             and spec[1:] == want[name][1:]), (batch, name)

        ours_c = cache_specs(cfg, pol)
        theirs_c = RS.cache_specs(rcfg, rpol)
        assert len(ours_c["prefix"]) == len(theirs_c["prefix"])
        for o, t in zip(ours_c["prefix"], theirs_c["prefix"]):
            assert [_norm(s) for s in o] == [_norm(s) for s in t]
        assert len(ours_c["stages"]) == n_stages
        if n_stages:
            for stage in ours_c["stages"]:
                for o, t in zip(stage, theirs_c["stages"]):
                    assert [((),) + _norm(s) for s in o] == [_norm(s) for s in t], batch
        else:
            assert theirs_c["stages"] is None


def _to_jax(spec_tree, shapes):
    """The port's spec tree and meta shapes as jax pytrees (specs as
    ``PartitionSpec`` leaves), in the port's layout."""
    specs = jax.tree.map(lambda s: jax.sharding.PartitionSpec(*s), spec_tree,
                         is_leaf=lambda x: isinstance(x, tuple) and not (
                             x and isinstance(x[0], (dict, list))))
    structs = jax.tree.map(lambda t: jax.ShapeDtypeStruct(tuple(t.shape), np.float32), shapes,
                           is_leaf=lambda x: hasattr(x, "shape"))
    return specs, structs


def _from_jax(tree):
    return jax.tree.map(tuple, tree, is_leaf=_is_spec)


def _local_bytes(shape, dtype_size, placement_list, mesh_shape):
    """Rank 0's shard bytes under DTensor's placements: each mesh dim that
    shards a tensor dim takes its first chunk, ``ceil(size / n)``."""
    from torch.distributed.tensor import Shard

    dims = list(shape)
    for p, n in zip(placement_list, mesh_shape):
        if isinstance(p, Shard):
            dims[p.dim] = -(-dims[p.dim] // n)
    return int(np.prod(dims, dtype=np.int64)) * dtype_size


def _ref_local_bytes(shape, dtype, spec, axis_sizes):
    """The same from a reference spec: each dim padded to a multiple of its
    axes' product, as JAX shards it."""
    dims = list(shape)
    for i, e in enumerate(tuple(spec) + (None,) * (len(dims) - len(tuple(spec)))):
        names = () if e is None else (tuple(e) if isinstance(e, tuple) else (e,))
        n = int(np.prod([axis_sizes[a] for a in names])) if names else 1
        dims[i] = -(-dims[i] // n)
    return int(np.prod(dims, dtype=np.int64)) * np.dtype(dtype).itemsize


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_train_argument_bytes_equal_the_reference(arch):
    cfg, rcfg = ARCHS[arch], R_ARCHS[arch]
    shape, names = MESHES["16x16"]
    mesh, sizes = _stub("16x16"), dict(zip(names, shape))
    specs = input_specs(cfg, "train_4k", SHAPES)
    pol = policy_for(cfg, mesh, batch=specs["inputs"].shape[0])
    ours_shapes = param_shapes(cfg, tp_size=16)
    pspecs = param_specs(ours_shapes, pol)
    ospecs = opt_specs(pspecs, pol.dp, pol.dp_size, ours_shapes)
    in_spec, lab_spec = batch_specs(cfg, pol, "train")

    def leaves(tree):
        return [t for _, t in tree_leaves_with_names(tree)]

    def spec_leaves(tree):
        return [s for _, s in _walk(tree, "")]

    ours = 0
    for tree_shapes, tree_specs, size in [(ours_shapes, pspecs, None)] + [
            (ours_shapes, ospecs[k], 4) for k in ("master", "m", "v")]:
        for t, s in zip(leaves(tree_shapes), spec_leaves(tree_specs)):
            ours += _local_bytes(t.shape, size or t.element_size(), placements(s, mesh), shape)
    ours += 4  # AdamW's step
    for t, s in ((specs["inputs"], in_spec), (specs["labels"], lab_spec)):
        ours += _local_bytes(t.shape, t.element_size(), placements(s, mesh), shape)

    rshapes = _ref_shapes(arch)
    rpol = RS.policy_for(rcfg, mesh, batch=specs["inputs"].shape[0])
    rp = RS.param_specs(rshapes, rpol)
    flat = lambda tree: jax.tree_util.tree_leaves(tree, is_leaf=_is_spec)  # noqa: E731
    theirs = sum(_ref_local_bytes(a.shape, a.dtype, s, sizes)
                 for a, s in zip(flat(rshapes), flat(rp)))
    # the optimizer state by the reference's ZeRO-1 rule over the port's
    # per-stage layout (its stacked layout may shard the stage axis instead,
    # which holds at most as much: checked below)
    port_specs, master = _to_jax(pspecs, ours_shapes)
    ro = r_opt_specs(port_specs, rpol.dp, rpol.dp_size, master)
    opt = sum(_ref_local_bytes(a.shape, np.float32, s, sizes)
              for k in ("master", "m", "v") for a, s in zip(flat(master), flat(ro[k])))
    stacked_master = jax.eval_shape(r_adamw_init, rshapes)["master"]
    stacked = r_opt_specs(rp, rpol.dp, rpol.dp_size, stacked_master)
    assert opt >= sum(_ref_local_bytes(a.shape, np.float32, s, sizes)
                      for k in ("master", "m", "v")
                      for a, s in zip(flat(stacked_master), flat(stacked[k])))
    theirs += opt + 4
    rin = r_input_specs(rcfg, "train_4k", R_SHAPES)
    r_in, r_lab = RS.batch_specs(rcfg, rpol, "train")
    theirs += _ref_local_bytes(rin["inputs"].shape, rin["inputs"].dtype, r_in, sizes)
    theirs += _ref_local_bytes(rin["labels"].shape, rin["labels"].dtype, r_lab, sizes)
    assert ours == theirs
