"""Predicted-vs-realized plan audit (§12): does the objective's benefit
estimate survive contact with a real run?

The planner flags node ``v`` because its speedup score ``t_v`` (the
``core.speedup`` objective: per-child short-circuited read seconds plus the
write moved off the critical path) predicts that many saved seconds. This
module closes the loop the paper assumes is closed ("metrics from previous
runs"): it joins each round's solved plan — per-node predicted benefit from
the round's scored graph, captured on ``RoundReport.scores`` — against the
savings a real traced run actually realized, derived from ``obs.trace``
spans:

* **realized read saving** — per ``read.catalog`` hit of the entry, the
  modeled disk read it displaced minus the hit's actual duration:
  ``Σ read_disk(nbytes) − dur``.
* **realized write saving** — seconds of the entry's materialization that
  ran on a background writer channel (``write.behind`` span durations) —
  an upper bound: drain-time stalls at round end are not subtracted per
  entry.
* **residency hold** — catalog ``admit`` → ``release`` interval: how long
  the entry's bytes occupied budget for those savings.
* **waste** — a flagged entry that was admitted but never read by any
  child before release (``released-before-use``), or that overflowed
  admission outright: its predicted benefit was priced but never realized.

Per-(mv, partition, round) rows roll up to the per-(mv, partition) drift
report the acceptance criteria name; ``drift = realized − predicted`` per
row, so systematic cost-model optimism/pessimism shows up as a consistent
sign, and eviction-before-use / throttle effects show up as waste rows.

This module depends only on report *shapes* (``rounds[i].plan/scores/run``)
— it never imports the engine, so it audits any run that records spans
under the shared schema.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Iterable, Sequence

from ..core.speedup import CostModel
from .trace import Span, split_entry

__all__ = ["AuditRow", "AuditReport", "audit_scenario"]


@dataclasses.dataclass
class AuditRow:
    """Predicted-vs-realized accounting for one (mv, partition, round)."""

    mv: str
    partition: int
    round: int
    flagged: bool
    predicted_s: float        # planner's speedup score this round (0 unflagged)
    realized_read_s: float    # short-circuited read seconds actually saved
    realized_write_s: float   # materialization seconds moved off-channel
    realized_s: float
    drift_s: float            # realized − predicted
    hits: int                 # catalog reads served
    hold_s: float             # admit → release residency duration
    resident_bytes: float     # bytes the entry occupied while resident
    overflowed: bool          # flagged but admission failed (size estimate low)
    wasted: bool              # resident (or priced) but never read before release

    @property
    def entry(self) -> str:
        return self.mv if self.partition < 0 else f"{self.mv}@p{self.partition}"


@dataclasses.dataclass
class AuditReport:
    rows: list[AuditRow]
    cost_model: CostModel

    @property
    def predicted_s(self) -> float:
        return sum(r.predicted_s for r in self.rows)

    @property
    def realized_s(self) -> float:
        return sum(r.realized_s for r in self.rows)

    @property
    def drift_s(self) -> float:
        return self.realized_s - self.predicted_s

    def by_mv_partition(self) -> dict[tuple[str, int], dict[str, float]]:
        """The per-(mv, partition) drift report: rounds aggregated."""
        out: dict[tuple[str, int], dict[str, float]] = {}
        for r in self.rows:
            key = (r.mv, r.partition)
            agg = out.setdefault(key, {
                "rounds_flagged": 0, "predicted_s": 0.0, "realized_s": 0.0,
                "drift_s": 0.0, "hits": 0, "hold_s": 0.0,
                "wasted_rounds": 0, "overflow_rounds": 0,
            })
            agg["rounds_flagged"] += int(r.flagged)
            agg["predicted_s"] += r.predicted_s
            agg["realized_s"] += r.realized_s
            agg["drift_s"] += r.drift_s
            agg["hits"] += r.hits
            agg["hold_s"] += r.hold_s
            agg["wasted_rounds"] += int(r.wasted)
            agg["overflow_rounds"] += int(r.overflowed)
        return out

    def to_dict(self) -> dict[str, Any]:
        return {
            "schema": "sc-audit/v1",
            "totals": {
                "predicted_s": self.predicted_s,
                "realized_s": self.realized_s,
                "drift_s": self.drift_s,
            },
            "by_mv_partition": {
                (mv if p < 0 else f"{mv}@p{p}"): agg
                for (mv, p), agg in sorted(self.by_mv_partition().items())
            },
            "rows": [dataclasses.asdict(r) for r in self.rows],
        }

    def save_json(self, path: str | Path) -> Path:
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(self.to_dict(), indent=1))
        return p

    def table(self) -> str:
        """Per-(mv, partition) drift summary, worst drift first."""
        hdr = ["mv[@part]", "flagged", "pred(s)", "realized(s)", "drift(s)",
               "hits", "hold(s)", "wasted", "overflow"]
        rows = []
        for (mv, p), agg in sorted(
            self.by_mv_partition().items(), key=lambda kv: kv[1]["drift_s"]
        ):
            rows.append([
                mv if p < 0 else f"{mv}@p{p}",
                agg["rounds_flagged"],
                f"{agg['predicted_s']:.4f}",
                f"{agg['realized_s']:.4f}",
                f"{agg['drift_s']:+.4f}",
                agg["hits"],
                f"{agg['hold_s']:.4f}",
                agg["wasted_rounds"],
                agg["overflow_rounds"],
            ])
        widths = [max(len(str(h)), *(len(str(r[i])) for r in rows), 0)
                  for i, h in enumerate(hdr)]

        def line(vals):
            return " | ".join(str(v).ljust(w) for v, w in zip(vals, widths))

        return "\n".join(
            [line(hdr), "-+-".join("-" * w for w in widths)]
            + [line(r) for r in rows]
        )


def _names_of(workload) -> list[str]:
    if hasattr(workload, "nodes"):
        return [n.name for n in workload.nodes]
    return list(workload)


def audit_scenario(
    workload,
    report,
    spans: Iterable[Span],
    cost_model: CostModel,
    track: str = "real",
) -> AuditReport:
    """Join a scenario's per-round plans against its recorded trace.

    ``workload`` supplies node names (a ``Workload`` or a name sequence,
    index-aligned with each round's plan); ``report`` is a
    ``ScenarioReport``-shaped object whose rounds carry ``plan`` (order +
    flagged), ``scores`` (per-node predicted benefit seconds — empty tuples
    degrade to predicted 0), and ``run.entry_stats`` when available;
    ``spans`` is the trace of the run (``obs.trace.drain()``);
    ``cost_model`` prices the disk reads the catalog hits displaced — pass
    the model matching the run's store throttling, not the paper default.
    """
    names = _names_of(workload)
    by_round: dict[int, list[Span]] = {}
    for s in spans:
        if s.track == track:
            by_round.setdefault(s.round, []).append(s)

    rows: list[AuditRow] = []
    for rr in report.rounds:
        r = rr.round_idx
        rspans = by_round.get(r, ())
        hits: dict[str, list[Span]] = {}
        bg_writes: dict[str, float] = {}
        admits: dict[str, list[Span]] = {}
        releases: dict[str, list[Span]] = {}
        for s in rspans:
            if s.cat == "read.catalog":
                hits.setdefault(s.name, []).append(s)
            elif s.cat == "write.behind":
                bg_writes[s.name] = bg_writes.get(s.name, 0.0) + s.dur
            elif s.cat == "admit":
                admits.setdefault(s.name, []).append(s)
            elif s.cat == "release":
                releases.setdefault(s.name, []).append(s)

        scores: Sequence[float] = getattr(rr, "scores", ()) or ()
        entry_stats = getattr(rr.run, "entry_stats", {}) if hasattr(rr, "run") else {}
        flagged = frozenset(rr.plan.flagged)
        touched = (
            {names[v] for v in flagged}
            | set(hits) | set(admits) | set(bg_writes)
        )
        for name in sorted(touched):
            try:
                v = names.index(name)
            except ValueError:
                v = -1
            is_flagged = v in flagged
            predicted = (
                float(scores[v]) if is_flagged and v < len(scores) else 0.0
            )
            hs = hits.get(name, ())
            read_saved = sum(
                max(cost_model.read_disk(s.nbytes) - s.dur, 0.0) for s in hs
            )
            write_saved = bg_writes.get(name, 0.0)
            adm = admits.get(name, ())
            rel = releases.get(name, ())
            hold = sum(
                max(b.ts - a.ts, 0.0) for a, b in zip(adm, rel)
            )
            resident = sum(a.nbytes for a in adm)
            overflow = bool(entry_stats.get(name, {}).get("overflow", 0)) or (
                is_flagged and not adm and predicted > 0.0
                and name in entry_stats
            )
            realized = read_saved + write_saved
            rows.append(AuditRow(
                mv=split_entry(name)[0],
                partition=split_entry(name)[1],
                round=r,
                flagged=is_flagged,
                predicted_s=predicted,
                realized_read_s=read_saved,
                realized_write_s=write_saved,
                realized_s=realized,
                drift_s=realized - predicted,
                hits=len(hs),
                hold_s=hold,
                resident_bytes=resident,
                overflowed=overflow,
                wasted=is_flagged and len(hs) == 0 and predicted > 0.0,
            ))
    return AuditReport(rows=rows, cost_model=cost_model)
