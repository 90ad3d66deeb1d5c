"""Static analysis: the ``Finding`` model (``findings``), plan feasibility
verify/repair (``plan_check``, which ``core.altopt`` reuses), delta-safety
typing over the operator IR (``delta_safety``), MQO merge soundness
(``mqo_check``), the determinism lints over sources and over the PTX of the
data-plane kernels (``determinism``), and the must-fire fixtures of both
(``fixtures``). ``tools/sc_lint_torch.py`` drives them all against its
baseline. Import the passes as submodules: this package root stays
lightweight so the planner can import it without cycles."""
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
