"""Runtime loops (PyTorch port of ``repro/runtime``): the fault-tolerant
``Trainer``, the live ``SessionServer`` on the ACS window and the
``ContinuousBatchingServer`` baseline."""

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
from .train import Trainer, TrainerConfig

__all__ = [
    "AdmissionQueueFull", "ContinuousBatchingServer", "DrainTimeout",
    "PRIORITY_HIGH", "PRIORITY_LOW", "PRIORITY_NORMAL", "Request", "SessionServer",
    "Trainer", "TrainerConfig",
]
