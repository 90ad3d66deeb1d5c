"""Runtime fault tolerance: preemption and stragglers."""
from .ft import PreemptionHandler, StragglerDetector, StragglerEvent

__all__ = ["PreemptionHandler", "StragglerDetector", "StragglerEvent"]
