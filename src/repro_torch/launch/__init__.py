"""Launch layer (PyTorch port of ``repro/launch``): the scheduling window's
device list (``mesh.make_window_mesh``), an arch's train and serving
steps (``steps.StepBundle``), the trainer CLI (``python -m
repro_torch.launch.train``), and the H100 roofline terms and useful-FLOPs
count (``roofline``, ``roofline_run.model_flops_per_device``). The
reference's TPU-pod tools (``dryrun``, ``hillclimb``, ``report`` and the
XLA cost analysis behind its roofline) are not ported (ROADMAP)."""

from .mesh import make_window_mesh

__all__ = ["make_window_mesh"]
