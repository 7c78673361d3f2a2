"""Serving runtime (PyTorch port of ``repro/runtime``): the live
``SessionServer`` on the ACS window and the ``ContinuousBatchingServer``
baseline. Training (``runtime/train.py``) is still to port (ROADMAP queue 1
item 11)."""

from .serve import (
    PRIORITY_HIGH,
    PRIORITY_LOW,
    PRIORITY_NORMAL,
    AdmissionQueueFull,
    ContinuousBatchingServer,
    DrainTimeout,
    Request,
    SessionServer,
)

__all__ = [
    "AdmissionQueueFull", "ContinuousBatchingServer", "DrainTimeout",
    "PRIORITY_HIGH", "PRIORITY_LOW", "PRIORITY_NORMAL", "Request", "SessionServer",
]
