"""Meshes (PyTorch port of ``repro/launch/mesh.py``): the training
meshes and the scheduling window's device list.

Every factory here is a FUNCTION (not a module-level constant), so
importing this module touches no device and no process group.

* ``make_production_mesh`` lays the default process group's ranks out as
  the reference's production meshes, 16 x 16 = 256 cards over ``("data",
  "model")``, or 2 x 16 x 16 = 512 over ``("pod", "data", "model")``, as a
  ``DeviceMesh``. It needs a world of that size: ``torch.distributed``
  started on that many cards, or :func:`fake_world`, the counterpart of the
  reference's ``--xla_force_host_platform_device_count``, under which the
  dry run traces a step of one rank with no card at all.
* ``make_local_mesh`` is a 1-D ``data`` mesh over the whole world.
* ``make_window_mesh`` is the list of ``torch.device``s a
  :class:`~repro_torch.core.mesh_session.MeshDeviceSession` pins its shards
  to, one shard per entry (the reference returns a 1-D ``jax`` mesh).
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional

import torch

from ..core.buffers import DeviceLike, resolve_device

__all__ = ["make_production_mesh", "make_local_mesh", "make_window_mesh", "fake_world"]


def _world(wanted: Optional[int], what: str) -> int:
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(f"{what} lays out the default process group, and none is "
                           f"initialised: start torch.distributed on the cards, or enter "
                           f"repro_torch.launch.mesh.fake_world(n) to trace without them")
    size = dist.get_world_size()
    if wanted is not None and size != wanted:
        raise RuntimeError(f"{what} wants a world of {wanted} ranks, the default process "
                           f"group has {size}")
    return size


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """16 x 16 = 256 cards over ``("data", "model")``; with ``multi_pod``,
    2 x 16 x 16 = 512 over ``("pod", "data", "model")``. ``device`` is the
    mesh's device type."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for d in shape:
        n *= d
    _world(n, "make_production_mesh")
    return init_device_mesh(device, shape, mesh_dim_names=axes)


def make_local_mesh(device: str = "cuda"):
    """Every rank of the world on a 1-D ``data`` axis (tests, examples and
    a one-card trace). ``parallel.sharding`` reads a missing ``model``
    axis as tensor-parallel degree 1."""
    from torch.distributed.device_mesh import init_device_mesh

    n = _world(None, "make_local_mesh")
    return init_device_mesh(device, (n,), mesh_dim_names=("data",))


@contextlib.contextmanager
def fake_world(n: int) -> Iterator[None]:
    """A world of ``n`` ranks in this one process, as rank 0, on PyTorch's
    ``fake`` process-group backend: collectives return at once and move no
    data, so a step traced under ``FakeTensorMode`` over a mesh of this
    world records each collective's shape without a card or a peer. The
    group is destroyed on exit (it is global to the process).

    The backend's store lives in ``torch.testing._internal``; this is the
    one place the port imports it. Checked with torch 2.13 (CPU build) and
    2.11 (CUDA 12 build, on an H100)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_world: a default process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_window_mesh(n: Optional[int] = None, device: DeviceLike = "cuda") -> List[torch.device]:
    """``n`` devices for the scheduling window. On the card: ``cuda:0`` up
    to ``cuda:{n-1}``, ``n=None`` taking every visible card; more than are
    visible raises. On the CPU: ``n`` times ``cpu`` (one for ``n=None``),
    the logical-shard mode the CPU tests run."""
    dev = resolve_device(device)
    if n is not None and n < 1:
        raise ValueError(f"window mesh wants n >= 1, got {n}")
    if dev.type == "cpu":
        return [torch.device("cpu")] * (1 if n is None else n)
    visible = torch.cuda.device_count()
    if n is None:
        n = visible
    if n > visible:
        raise ValueError(f"window mesh wants {n} devices but {visible} are visible")
    return [torch.device("cuda", i) for i in range(n)]
