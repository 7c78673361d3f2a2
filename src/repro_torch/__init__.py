"""repro_torch — the ACS reproduction on PyTorch and CUDA (NVIDIA H100).

A second package beside the JAX reference ``repro``, with the same layout
(``core/``, ``kernels/``, ``sim/``, ``dyn/``, ``models/``, ``configs/``,
``runtime/``, ``optim/``, ``checkpoint/``, ``data/``, ``parallel/``,
``launch/``) so each module's counterpart is found by path; ``tree.py``
walks nested containers of tensors as ``jax.tree_util`` does. It imports
``torch`` and ``numpy`` only — never ``jax`` and nothing from ``repro``.

Every entry point that touches tensors (``BufferPool``, ``PhysicsEngine``,
``DeviceWindowRunner``, ``make_scheduler``, ``run_serial``,
``models.init_params``, ``models.init_cache``, the servers, the
``Trainer``) takes ``device=`` and defaults to ``"cuda"``; on a host
without a card the default raises and the caller passes ``device="cpu"``.
"""

import torch

# ACS's invariant is bit-identity: every scheduler must leave exactly the
# buffers the serial baseline leaves. TF32 matmuls/convolutions round
# differently depending on the kernel cuBLAS/cuDNN picks for a shape, so a
# batched or reordered run could drift from serial; pin full float32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["checkpoint", "configs", "core", "data", "dyn", "kernels", "launch", "models",
           "optim", "parallel", "runtime", "sim", "trace", "tree"]
