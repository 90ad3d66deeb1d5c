"""Finding model + baseline workflow shared by every sc-lint pass.

A ``Finding`` is one static-analysis diagnostic. Its ``fingerprint`` is
deliberately line-number-free (``rule:path:symbol``) so a finding survives
unrelated edits to the same file: the CI gate compares fingerprints of
*gating* findings (error/warning — info is report-only) against the checked-
in baseline (``tools/sc_lint_baseline.json``) and fails only on NEW ones.
Accepted debt is recorded by ``--update-baseline``; entries whose finding
disappeared are reported as stale so the baseline shrinks over time.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Iterable, Sequence

LEVELS = ("error", "warning", "info")
GATING_LEVELS = ("error", "warning")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str      # e.g. "unstable-sort", "agg-overflow", "plan-infeasible"
    level: str     # "error" | "warning" | "info"
    path: str      # repo-relative file, or a logical unit ("ir:<workload>")
    symbol: str    # function / kernel / IR-node the finding anchors to
    message: str
    line: int = 0  # best-effort location; NOT part of the fingerprint

    def __post_init__(self):
        if self.level not in LEVELS:
            raise ValueError(f"unknown level {self.level!r}")

    @property
    def fingerprint(self) -> str:
        return f"{self.rule}:{self.path}:{self.symbol}"

    def format(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{self.level:7s} {self.rule:24s} {loc} [{self.symbol}] " \
               f"{self.message}"


def gating(findings: Iterable[Finding]) -> list[Finding]:
    """The findings the CI gate considers (info is report-only)."""
    return [f for f in findings if f.level in GATING_LEVELS]


def load_baseline(path: str | Path) -> set[str]:
    p = Path(path)
    if not p.exists():
        return set()
    data = json.loads(p.read_text())
    return set(data.get("fingerprints", []))


def save_baseline(path: str | Path, findings: Iterable[Finding],
                  comment: str | None = None) -> set[str]:
    fps = sorted({f.fingerprint for f in gating(findings)})
    payload = {
        "comment": comment or (
            "Accepted sc-lint debt: gating findings (error/warning) whose "
            "fingerprints are sanctioned. Regenerate with "
            "`python tools/sc_lint.py --update-baseline`."
        ),
        "fingerprints": fps,
    }
    Path(path).write_text(json.dumps(payload, indent=2) + "\n")
    return set(fps)


def new_findings(
    findings: Iterable[Finding], baseline: set[str]
) -> list[Finding]:
    return [f for f in gating(findings) if f.fingerprint not in baseline]


def stale_entries(
    findings: Iterable[Finding], baseline: set[str]
) -> list[str]:
    seen = {f.fingerprint for f in gating(findings)}
    return sorted(baseline - seen)


def to_json(findings: Sequence[Finding]) -> list[dict]:
    return [dataclasses.asdict(f) for f in findings]


def format_findings(findings: Sequence[Finding]) -> str:
    order = {lvl: i for i, lvl in enumerate(LEVELS)}
    ranked = sorted(
        findings, key=lambda f: (order[f.level], f.rule, f.path, f.symbol)
    )
    return "\n".join(f.format() for f in ranked)
