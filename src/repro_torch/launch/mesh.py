"""The scheduling window's mesh (PyTorch port of
``repro/launch/mesh.py``'s ``make_window_mesh``).

The reference returns a 1-D ``jax.sharding.Mesh`` over its devices; the
port's mesh is the list of ``torch.device``s that a
:class:`~repro_torch.core.mesh_session.MeshDeviceSession` pins its shards
to, one shard per entry. A function, not a constant: importing this module
touches no device.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..core.buffers import DeviceLike, resolve_device

__all__ = ["make_window_mesh"]


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
