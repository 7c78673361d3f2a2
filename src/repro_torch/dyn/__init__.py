"""Dynamic & static DNN workloads — the paper's workloads 2 and 3 (§II-C,
§V); PyTorch port of ``repro/dyn``.

* ``instanas``       — InstaNAS-like instance-aware dynamic CNN: a per-input
                       controller picks a subset of candidate blocks per stage.
* ``dynamic_routing``— grid-of-cells segmentation net with per-input gates.
* ``condconv``       — CondConv mixture-of-experts CNN: example-dependent
                       convolution weights mixed at runtime.
* ``static_nets``    — NAS-produced irregular static CNNs: NASNet-like,
                       AmoebaNet-like, SqueezeNet, RandomWire.

Every network is expressed as a stream of small ACS kernels over a
``BufferPool`` — batch size 1 (paper §V), 3x32x32 inputs, small feature
maps, so a GPU would be underutilized by serial execution. Sizes are the
reference's. Every ``init_*`` takes ``device=`` (default ``"cuda"``) and
draws its weights with numpy's ``RandomState(seed)`` in the reference's
order: the same seed gives the reference's arrays.
"""

from typing import Dict

import numpy as np
import torch

from ..core.buffers import DeviceLike
from .blocks import DynParams, init_conv, init_dense
from .condconv import build_condconv, init_condconv
from .dynamic_routing import build_dynamic_routing, init_dynamic_routing
from .instanas import build_instanas, init_instanas
from .static_nets import (
    build_amoebanet,
    build_nasnet,
    build_randwire,
    build_squeezenet,
    init_amoebanet,
    init_nasnet,
    init_randwire,
    init_squeezenet,
)

#: name -> (init_fn, build_fn, dynamic): a dynamic net's task stream
#: depends on its input, a static net's does not.
WORKLOADS = {
    "instanas": (init_instanas, build_instanas, True),
    "dynamic_routing": (init_dynamic_routing, build_dynamic_routing, True),
    "condconv": (init_condconv, build_condconv, True),
    "nasnet": (init_nasnet, build_nasnet, False),
    "amoebanet": (init_amoebanet, build_amoebanet, False),
    "squeezenet": (init_squeezenet, build_squeezenet, False),
    "randwire": (init_randwire, build_randwire, False),
}


def params_from_numpy(name: str, arrays: Dict[str, np.ndarray], seed: int = 0,
                      device: DeviceLike = "cuda") -> DynParams:
    """Workload ``name``'s parameters with the weight values ``arrays``
    (the reference's ``{k: np.asarray(b.value) for k, b in
    params.weights.items()}``). The port's own init at ``seed`` supplies the
    structure (genotype, wiring, the classifier's generator); every named
    array replaces the weight of that name, shape and dtype checked. A
    name the port has not drawn yet (the classifier, drawn at the first
    build) is added as given, and then is not drawn."""
    params = WORKLOADS[name][0](seed, device=device)
    for key, arr in arrays.items():
        arr = np.asarray(arr)
        buf = params.weights.get(key)
        if buf is None:
            params.raw(key, arr)
            continue
        if tuple(buf.shape) != arr.shape or buf.dtype != arr.dtype:
            raise ValueError(f"{name} weight {key!r}: {arr.dtype}{list(arr.shape)} does not "
                             f"match the port's {buf.dtype}{list(buf.shape)}")
        buf.value = torch.tensor(arr, device=params.pool.device)  # a copy
    return params


__all__ = ["WORKLOADS", "DynParams", "init_conv", "init_dense", "params_from_numpy"] + [
    n for n in dir() if n.startswith(("build_", "init_")) and n not in ("init_conv", "init_dense")]
