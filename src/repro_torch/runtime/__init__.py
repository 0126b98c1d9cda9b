"""The fault-tolerant training runtime (port of ``repro.runtime``)."""
from .fault_tolerance import StragglerMonitor, TrainLoop

__all__ = ["TrainLoop", "StragglerMonitor"]
