"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version in ``ref.py``:

ready_queue — the ACS-HW device ready queue (CUDA, ``csrc/ready_queue.cu``)

``ops.py`` holds the kernel's fixed branch table. Kernels build at first
use; importing this package needs no compiler and no card.
"""

from . import ops, ready_queue, ref

__all__ = ["ops", "ready_queue", "ref"]
