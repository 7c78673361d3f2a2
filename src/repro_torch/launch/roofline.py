"""Roofline analysis on H100s (PyTorch port of ``repro/launch/roofline.py``).

Three terms per (arch x shape) on a mesh of H100 SXM cards, each at its
700 W limit, from the NVIDIA H100 data sheet (SXM part, dense rates
without sparsity) and the DGX H100 system's:

    compute    = FLOPs_per_device / 989e12                 [s]  bf16 tensor cores
    memory     = bytes_per_device / 3.35e12                [s]  HBM3
    collective = sum over links of wire_bytes / link rate  [s]

A collective runs over the ranks of its mesh axes. On DGX H100 nodes of 8
cards, a group whose ranks all lie in one node (``rank // 8`` the same)
rides NVLink (450 GB/s a card each way); any other group crosses the
nodes' network, 8 x 400 Gb/s ConnectX-7 a node, about 50 GB/s a card, the
slowest link its ring crosses. On the 16 x 16 production mesh every axis
is 16 wide, so every group spans at least two nodes.

The counts come from the port's own traced step (``steps.StepBundle.trace``:
one rank's ops under ``FakeTensorMode`` over DTensors), counted by
:class:`StepCounter`: FLOPs by PyTorch's flop formulas (the kernels'
ops register theirs), bytes as each compute op's operands and results
read and written once, one record per collective, and the peak of the
live bytes. Wire bytes per
collective use the reference's ring estimates: all-reduce 2x, all-gather,
reduce-scatter, all-to-all and permutes 1x the largest operand (the
(n-1)/n factor is ~1 at n = 16..512).

The port traces every layer it runs, so it needs no 1-stage / 2-stage
differencing (the reference's ``analyze_unrolled``, for XLA's cost
analysis, which counts a ``while`` body once); ``analyze_unrolled`` stays
to check that assumption (``tests/test_torch_dryrun.py``), and
``analyze`` records both reduced-depth traces beside the full one.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import re
import sys
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["PEAK_FLOPS", "HBM_BW", "LINK_BW", "NET_BW", "CARDS_PER_NODE", "RooflineTerms",
           "roofline_terms", "StepCounter", "card_collectives", "collective_bytes",
           "collective_bytes_from_text", "link_of", "analyze", "analyze_unrolled"]

PEAK_FLOPS = 989e12  # bf16 dense / card (H100 SXM, 700 W)
HBM_BW = 3.35e12     # B/s / card (H100 SXM)
LINK_BW = 450e9      # B/s / card, NVLink 4 each way (H100 SXM)
NET_BW = 50e9        # B/s / card between nodes (DGX H100: 8 x 400 Gb/s ConnectX-7)
CARDS_PER_NODE = 8   # DGX H100

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}

_COLLECTIVES = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute",
)
_SHAPE_RE = re.compile(r"\b(" + "|".join(_DTYPE_BYTES) + r")\[([0-9,]*)\]")

# _c10d_functional op -> the collective kind it is
_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "collective-permute",
}


def _line_max_bytes(line: str) -> int:
    best = 0
    for dt, dims in _SHAPE_RE.findall(line):
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        best = max(best, n * _DTYPE_BYTES[dt])
    return best


def collective_bytes_from_text(text: str) -> Dict[str, Any]:
    """Per-collective-kind wire-byte estimate from HLO-style text (a copy
    of the reference's, for collectives written as HLO lines)."""
    out: Dict[str, Any] = {k: 0.0 for k in _COLLECTIVES}
    counts = {k: 0 for k in _COLLECTIVES}
    for line in text.splitlines():
        stripped = line.strip()
        for kind in _COLLECTIVES:
            # match op invocations (e.g. "all-reduce(", "all-gather-start(")
            if f"{kind}(" in stripped or f"{kind}-start(" in stripped:
                size = _line_max_bytes(stripped)
                mult = 2.0 if kind == "all-reduce" else 1.0
                out[kind] += mult * size
                counts[kind] += 1
                break
    out["total_bytes"] = sum(out[k] for k in _COLLECTIVES)
    out["counts"] = counts
    return out


def _group_axes(mesh) -> Dict[str, Dict[str, Any]]:
    """Process-group name -> the mesh axes it spans and its link, for every
    mesh dim of ``mesh`` (each dim's group holding this rank)."""
    out: Dict[str, Dict[str, Any]] = {}
    if mesh is None:
        return out
    names = mesh.mesh_dim_names or tuple(str(i) for i in range(mesh.ndim))
    ranks = mesh.mesh
    for i, name in enumerate(names):
        group = mesh.get_group(i)
        # this rank's group along dim i: the mesh's ranks with the other
        # coordinates fixed at this rank's
        coord = mesh.get_coordinate() or [0] * mesh.ndim
        index = [c if j != i else slice(None) for j, c in enumerate(coord)]
        members = [int(r) for r in ranks[tuple(index)].reshape(-1).tolist()]
        out[group.group_name] = {"axes": (name,), "link": link_of(members)}
    return out


def link_of(ranks: List[int]) -> str:
    """``"nvlink"`` where every rank lies in one node of
    ``CARDS_PER_NODE``, else ``"network"``."""
    return "nvlink" if len({r // CARDS_PER_NODE for r in ranks}) <= 1 else "network"


_PROPAGATION_FILE = os.path.join("tensor", "_sharding_prop.py")
# DTensor's redistribution: the pads, chunks and copies around a collective
_REDISTRIBUTE_FILES = (os.path.join("tensor", "_redistribute.py"),
                       os.path.join("tensor", "placement_types.py"))


def _dtensor_frames() -> Tuple[bool, bool]:
    """Whether DTensor's sharding propagator, and its redistribution, are
    on this thread's stack."""
    frame = sys._getframe(2)
    redistributing = False
    while frame is not None:
        name = frame.f_code.co_filename
        if name.endswith(_PROPAGATION_FILE):
            return True, redistributing
        redistributing = redistributing or name.endswith(_REDISTRIBUTE_FILES)
        frame = frame.f_back
    return False, redistributing


class StepCounter(TorchDispatchMode):
    """One rank's work, counted op by op on its local tensors: FLOPs by
    ``torch.utils.flop_counter``'s formulas, bytes (each compute op's
    tensor operands and results once; views and factories move none), one
    record for each collective (``_c10d_functional`` ops: its kind, dtype,
    largest operand shape, mesh axes and link), and the live bytes of
    every storage an op makes or :meth:`hold` is given, until it is freed,
    with their peak (``peak_bytes``).

    A DTensor op is passed on (``NotImplemented``) to DTensor, whose
    dispatch then runs the local ops and collectives this mode counts.
    Under ``FakeTensorMode`` DTensor's sharding propagation also runs each
    op on fake tensors of the global shapes, to learn its output's; an op
    called from inside that propagation (``_sharding_prop.py`` on the
    Python stack) is no work of the rank's and is not counted. The pads,
    chunks and copies DTensor makes around a collective when it
    redistributes (``_redistribute.py``, ``placement_types.py``) are no
    compute op: their storages count toward the peak, their bytes not
    (they differ between PyTorch versions; the collective is counted)."""

    def __init__(self, mesh=None):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.records: List[Dict[str, Any]] = []
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: Dict[int, int] = {}
        self._groups = _group_axes(mesh)

    def hold(self, tensors) -> None:
        """Count ``tensors``' storages as live from now (the step's
        arguments)."""
        for t in tensors:
            self._track(t)

    def _track(self, t: torch.Tensor) -> None:
        import weakref

        storage = t.untyped_storage()
        key = id(storage)
        if key in self._live:
            return
        n = storage.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(storage, self._free, key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils._pytree import tree_flatten
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if func is torch.ops._c10d_functional.wait_tensor.default and isinstance(
                args[0], FakeTensor):
            # on the card a wait returns its own tensor; a fake tensor's
            # wait makes a new one, which no card would hold (MemTracker
            # counts it so too)
            return args[0]
        out = func(*args, **kwargs)
        propagating, redistributing = _dtensor_frames()
        if propagating:
            return out
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                self._track(t)
        packet = func._overloadpacket
        if func.namespace == "_c10d_functional":
            kind = _KINDS.get(packet.__name__)
            if kind is not None:
                self._record(kind, args, out)
            return out
        if func.namespace == "_dtensor" and packet.__name__ == "shard_dim_alltoall":
            # DTensor's Shard(a) -> Shard(b) on a CUDA mesh (on a CPU one it
            # falls back to an all-gather and a chunk, counted as those)
            self._record("all-to-all", args, out)
            return out
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if not func.is_view and not redistributing and func.namespace != "prim" and (
                args or kwargs) and not packet.__name__.startswith(("empty", "new_empty")):
            tensors = [t for t in tree_flatten((args, kwargs, out))[0]
                       if isinstance(t, torch.Tensor)]
            self.bytes += sum(t.numel() * t.element_size() for t in tensors)
        return out

    def _record(self, kind: str, args, out) -> None:
        from torch.utils._pytree import tree_flatten

        tensors = [t for t in tree_flatten((args, out))[0] if isinstance(t, torch.Tensor)]
        big = max(tensors, key=lambda t: t.numel() * t.element_size())
        group = next((a for a in args if isinstance(a, str) and a in self._groups), None)
        where = self._groups.get(group, {"axes": (), "link": "network"})
        self.records.append({"kind": kind, "dtype": str(big.dtype).replace("torch.", ""),
                             "shape": tuple(big.shape),
                             "bytes": big.numel() * big.element_size(),
                             "axes": where["axes"], "link": where["link"]})


@contextlib.contextmanager
def card_collectives() -> Iterator[None]:
    """Within it, DTensor's ``Shard(a) -> Shard(b)`` on a CPU mesh runs the
    all-to-all op a CUDA mesh runs (``_dtensor::shard_dim_alltoall``), not
    gloo's stand-in (an all-gather of the whole dim and a chunk, n times the
    bytes and, for a moment, the memory): under ``FakeTensorMode`` the op's
    fake implementation moves nothing, so a trace on the CPU counts what the
    card's counts. For fake tensors only."""
    import torch.distributed.tensor.placement_types as placement_types
    from torch.distributed import _functional_collectives as funcol

    real = placement_types.shard_dim_alltoall

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        if mesh.device_type != "cpu":
            return real(input, gather_dim, shard_dim, mesh, mesh_dim)
        group = funcol._resolve_group((mesh, mesh_dim))
        return torch.ops._dtensor.shard_dim_alltoall(input, gather_dim, shard_dim,
                                                     funcol._group_or_group_name(group))

    placement_types.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = real


def collective_bytes(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Wire bytes by kind (all-reduce 2x, the others 1x the largest
    operand, as the reference counts), by link and by mesh axis, with
    counts, from :class:`StepCounter`'s records."""
    out: Dict[str, Any] = {k: 0.0 for k in _COLLECTIVES}
    counts = {k: 0 for k in _COLLECTIVES}
    by_link: Dict[str, float] = {"nvlink": 0.0, "network": 0.0}
    by_axis: Dict[str, float] = {}
    for r in records:
        wire = (2.0 if r["kind"] == "all-reduce" else 1.0) * r["bytes"]
        out[r["kind"]] += wire
        counts[r["kind"]] += 1
        by_link[r["link"]] += wire
        axis = "+".join(r["axes"]) or "?"
        by_axis[axis] = by_axis.get(axis, 0.0) + wire
    out["total_bytes"] = sum(out[k] for k in _COLLECTIVES)
    out["counts"] = counts
    out["by_link"] = by_link
    out["by_axis"] = by_axis
    return out


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_device: float
    bytes_per_device: float
    wire_bytes_per_device: float
    model_flops: float = 0.0

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Lower bound assuming perfect overlap of the three engines."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_fraction(self) -> Optional[float]:
        if self.model_flops and self.flops_per_device:
            return self.model_flops / self.flops_per_device
        return None

    def as_dict(self) -> Dict[str, float]:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "wire_bytes_per_device": self.wire_bytes_per_device,
            "model_flops_per_device": self.model_flops,
            "useful_flops_fraction": self.useful_flops_fraction,
        }


def roofline_terms(flops: float, bytes_: float, wire_bytes: float,
                   model_flops: float = 0.0, *,
                   wire_by_link: Optional[Dict[str, float]] = None) -> RooflineTerms:
    """The three terms; the collective one over ``wire_by_link`` (bytes on
    ``"nvlink"`` and ``"network"``) where given, else all of
    ``wire_bytes`` at NVLink's rate."""
    if wire_by_link is None:
        collective = wire_bytes / LINK_BW
    else:
        collective = (wire_by_link.get("nvlink", 0.0) / LINK_BW
                      + wire_by_link.get("network", 0.0) / NET_BW)
    return RooflineTerms(
        compute_s=flops / PEAK_FLOPS,
        memory_s=bytes_ / HBM_BW,
        collective_s=collective,
        flops_per_device=flops,
        bytes_per_device=bytes_,
        wire_bytes_per_device=wire_bytes,
        model_flops=model_flops,
    )


def _measure(cfg, mesh, shape_name, shapes, bundle_cls) -> Dict[str, Any]:
    t = bundle_cls(cfg, mesh).trace(shape_name, shapes)
    coll = collective_bytes(t["records"])
    return {"flops": t["flops"], "bytes": t["bytes"], "wire": coll["total_bytes"],
            "wire_nvlink": coll["by_link"]["nvlink"], "wire_network": coll["by_link"]["network"]}


def _depths(cfg):
    from ..models.transformer import split_pattern

    prefix, n_stages = split_pattern(cfg)
    unit = len(cfg.pattern_unit)
    return len(prefix) + unit, len(prefix) + 2 * unit, n_stages


def analyze_unrolled(cfg, mesh, shape_name, shapes, bundle_cls=None):
    """Per-cell counts from traces at 1 and 2 stages: ``(total, m1, m2)``,
    ``total = m1 + (m2 - m1) * (n_stages - 1)``, the reference's
    extrapolation, exact where the stages are alike."""
    if bundle_cls is None:
        from .steps import StepBundle as bundle_cls
    n1, n2, n_stages = _depths(cfg)
    m1 = _measure(dataclasses.replace(cfg, n_layers=n1), mesh, shape_name, shapes, bundle_cls)
    m2 = _measure(dataclasses.replace(cfg, n_layers=n2), mesh, shape_name, shapes, bundle_cls)
    total = {k: m1[k] + (m2[k] - m1[k]) * (n_stages - 1) for k in m1}
    return total, m1, m2


def analyze(cfg, mesh, shape_name, shapes, bundle_cls=None, *, unrolled: bool = True):
    """Per-cell counts from one trace of the whole model: ``(total, m1,
    m2)``, with the 1-stage and 2-stage traces of the reference's record
    beside it (``None`` without ``unrolled``)."""
    if bundle_cls is None:
        from .steps import StepBundle as bundle_cls
    total = _measure(cfg, mesh, shape_name, shapes, bundle_cls)
    if not unrolled:
        return total, None, None
    _, m1, m2 = analyze_unrolled(cfg, mesh, shape_name, shapes, bundle_cls)
    return total, m1, m2
