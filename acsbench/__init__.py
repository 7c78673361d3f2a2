"""The benchmark of the PyTorch and CUDA port (``repro_torch``): cells of
``BENCHMARK.json`` run one at a time by ``run.py``. Nothing here imports
JAX or the JAX package; the plain reference in ``reference/`` imports
nothing of the port."""
