"""Roofline terms on the H100 (PyTorch port of ``repro/launch/roofline.py``'s
``RooflineTerms`` and ``roofline_terms``).

Three terms per step, against one H100 SXM's published peaks (NVIDIA H100
data sheet, SXM part, dense rates without sparsity, at its 700 W limit):

    compute    = FLOPs_per_device / 989e12      [s]   (bf16 tensor cores)
    memory     = bytes_per_device / 3.35e12     [s]   (HBM3)
    collective = wire_bytes_per_device / 450e9  [s]   (NVLink, one direction)

The reference takes its FLOPs and bytes from XLA's ``cost_analysis`` of
unrolled lowerings and its wire bytes from the post-SPMD HLO text
(``analyze_unrolled``, ``collective_bytes_from_text``); those are tools of
XLA and are not ported (ROADMAP). Here the caller supplies the counts.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

__all__ = ["PEAK_FLOPS", "HBM_BW", "LINK_BW", "RooflineTerms", "roofline_terms"]

PEAK_FLOPS = 989e12  # bf16 dense / card (H100 SXM)
HBM_BW = 3.35e12     # B/s / card
LINK_BW = 450e9      # B/s / card, NVLink each way


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_device: float
    bytes_per_device: float
    wire_bytes_per_device: float
    model_flops: float = 0.0

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Lower bound assuming perfect overlap of the three engines."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_fraction(self) -> Optional[float]:
        if self.model_flops and self.flops_per_device:
            return self.model_flops / self.flops_per_device
        return None

    def as_dict(self) -> Dict[str, float]:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "wire_bytes_per_device": self.wire_bytes_per_device,
            "model_flops_per_device": self.model_flops,
            "useful_flops_fraction": self.useful_flops_fraction,
        }


def roofline_terms(flops: float, bytes_: float, wire_bytes: float,
                   model_flops: float = 0.0) -> RooflineTerms:
    return RooflineTerms(
        compute_s=flops / PEAK_FLOPS,
        memory_s=bytes_ / HBM_BW,
        collective_s=wire_bytes / LINK_BW,
        flops_per_device=flops,
        bytes_per_device=bytes_,
        wire_bytes_per_device=wire_bytes,
        model_flops=model_flops,
    )
