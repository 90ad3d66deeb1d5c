"""Static analysis shared by the planner: the ``Finding`` model
(``findings``) and plan feasibility verify/repair (``plan_check``), which
``core.altopt`` reuses. This package root stays lightweight so the planner
can import it without cycles."""
from .findings import (
    Finding,
    GATING_LEVELS,
    LEVELS,
    format_findings,
    gating,
    load_baseline,
    new_findings,
    save_baseline,
    stale_entries,
    to_json,
)

__all__ = [
    "Finding",
    "LEVELS",
    "GATING_LEVELS",
    "gating",
    "load_baseline",
    "save_baseline",
    "new_findings",
    "stale_entries",
    "to_json",
    "format_findings",
]
