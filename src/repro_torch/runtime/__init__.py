"""Runtime fault tolerance: preemption, stragglers, elastic restart."""
from .ft import PreemptionHandler, StragglerDetector, StragglerEvent, elastic_restore

__all__ = ["PreemptionHandler", "StragglerDetector", "StragglerEvent", "elastic_restore"]
