"""Launch helpers (PyTorch port of ``repro/launch``): the scheduling
window's device list (``mesh.make_window_mesh``). Training pods, dry runs
and the roofline wait for the training slice (ROADMAP queue 1 item 11)."""

from .mesh import make_window_mesh

__all__ = ["make_window_mesh"]
