"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version in ``ref.py``:

ready_queue      — the ACS-HW device ready queue (CUDA, ``csrc/ready_queue.cu``)
adamw            — the optimizer's global-norm clip and AdamW update over every leaf
                   in a fixed number of launches (CUDA, ``csrc/adamw.cu``); the
                   reference's optimizer is plain ``jnp``, with no Pallas kernel
flash_attention  — online-softmax attention (CUDA, ``csrc/flash_attention.cu``)
grouped_matmul   — the ragged grouped GEMM of the MoE experts (CUDA,
                   ``csrc/grouped_matmul.cu``)
lru_scan         — the RG-LRU diagonal recurrence (CUDA, ``csrc/lru_scan.cu``)
selective_scan   — Mamba's selective scan, alone or fused with its layer's softplus,
                   skip and gate (``mamba_scan``), and its backward (``mamba_scan_bwd``,
                   ``selective_scan_bwd``) (CUDA, ``csrc/selective_scan.cu``); the
                   reference runs it as ``lax.scan``, with no Pallas kernel
wave_elementwise — the ACS-HW wave megakernel, one wave or a whole epoch in one
                   persistent launch (CUDA, ``csrc/wave_elementwise.cu``)

``ops.py`` holds the models' dispatch (``attention``, ``grouped_matmul``,
``lru_scan``, ``mamba_scan``), ``register_device_ops``, the reference's ``wave_step``
and the fixed branch table the ready queue and the wave kernel share.
``tile_sweep.py`` times tile-shape variants of flash and the grouped GEMM
on the card (``python -m repro_torch.kernels.tile_sweep``).
Kernels build at first use (``_nvcc.py``); importing this package needs
no compiler and no card.

As in the reference's ``repro.kernels``, the package binds
``flash_attention``, ``grouped_matmul``, ``lru_scan``, ``wave_elementwise``
and ``apply_wave`` to the functions; their modules (launch counters,
``build``) are ``importlib.import_module("repro_torch.kernels.<name>")``.
``adamw``, ``ready_queue``, ``selective_scan``, ``ops`` and ``ref`` are modules.
"""

from . import adamw, ops, ready_queue, ref, selective_scan
from .flash_attention import flash_attention
from .grouped_matmul import grouped_matmul
from .lru_scan import lru_scan
from .wave_elementwise import apply_wave, wave_elementwise

__all__ = ["adamw", "apply_wave", "flash_attention", "grouped_matmul", "lru_scan", "ops",
           "ready_queue", "ref", "selective_scan", "wave_elementwise"]
