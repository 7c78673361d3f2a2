"""Launch layer (PyTorch port of ``repro/launch``): the meshes
(``mesh``: the production meshes over a world of cards or a fake world,
and the scheduling window's device list), an arch's train and serving
steps and their trace over a mesh (``steps.StepBundle``), the trainer CLI
(``python -m repro_torch.launch.train``), and the tools that need no card:
the production-mesh dry run (``dryrun``), the H100 roofline terms
(``roofline``, ``roofline_run``), the hill-climbing driver
(``hillclimb``) and the tables (``report``)."""

from .mesh import make_window_mesh

__all__ = ["make_window_mesh"]
