"""Delta-safety typing over the operator IR (sc-lint pass family 1).

Checks the invariants the incremental engine's correctness story rests on,
*statically*, from a lifted ``ViewIR`` (``mv.ir``):

* **Z-set weight closure** — every operator in the DAG must have a known
  delta rule (how signed row weights propagate through it). An operator the
  engine has no rule for would silently fall back or corrupt weights; an
  unknown op kind is an error.
* **rid stability** — the engine's delta splicing is keyed by rid: a JOIN
  whose left input carries no rid cannot splice corrections, a UNION with a
  rid-less input loses the canonical rid order, and a retracting delta
  cannot be applied to a rid-less stored output. The engine already guards
  each case by falling back to full recompute (``IncrementalEngine.
  _refresh_delta``); the pass surfaces where those fallbacks are *statically
  inevitable* (info-level: correct but worth knowing — the MV pays full
  recompute every round).
* **AGG int64 fixed-point overflow** — sums accumulate as
  ``round(v * AGG_QUANTUM)`` in int64. Given a declared per-value scale and
  the modeled input row count, the worst-case |sum| is
  ``rows * scale * AGG_QUANTUM * max_weight``; past 2^62 headroom is gone
  (warning), past 2^63 the sum wraps (error).
* **JOIN partial-fallback reachability** — a JOIN whose non-left subtree
  contains an ingesting scan can receive right-side deltas that change the
  PK first-occurrence mapping, triggering the partial fallback's historical
  left re-read. Statically unreachable fallbacks (static right subtrees)
  cost nothing; reachable ones are flagged info so cost models and the
  ROADMAP's adaptive full-vs-incremental chooser know where to look.

The counterpart of ``repro.analysis.delta_safety``, over ``repro_torch``'s
IR; ``analyze_workload`` types the IR on a device (the card unless the
caller asks for the CPU).
"""
from __future__ import annotations

import numpy as np
import torch

from ..mv import ir as mvir
from ..mv.tableops import AGG_QUANTUM
from .findings import Finding

__all__ = ["DELTA_RULES", "check_ir", "analyze_workload", "est_rows"]

# op kind -> how Z-set weights propagate (the engine's delta rules;
# mv/incremental.py applies these at runtime)
DELTA_RULES: dict[str, str] = {
    "SCAN": "source: emits the round's signed delta directly",
    "FILTER": "weight-linear: mask rows, weights pass through",
    "PROJECT": "weight-linear: weight column always survives projection",
    "MAP": "weight-linear: derived column computed per row, weight kept",
    "JOIN": "bilinear: left weights pass through the PK probe; right-side "
            "mapping changes emit retract/insert corrections",
    "UNION": "additive: weighted inputs concatenate and consolidate by rid",
    "AGG": "mergeable: signed partial aggregate folded by merge_agg",
}

_I64_WRAP = float(2 ** 63)
_I64_HEADROOM = float(2 ** 62)


def est_rows(node: mvir.OpNode) -> float:
    """Modeled row count of a node from its byte size and typed schema."""
    if node.schema is None or node.size <= 0:
        return 0.0
    bpr = sum(np.dtype(d).itemsize for _, d in node.schema.columns)
    return node.size / max(bpr, 1)


def _reaches(ir: mvir.ViewIR, sources: frozenset[int]) -> list[bool]:
    """reach[v] = some node in ``sources`` is an ancestor-or-self of v."""
    reach = [False] * ir.n
    for v, node in enumerate(ir.nodes):
        reach[v] = v in sources or any(reach[p] for p in node.parents)
    return reach


def check_ir(
    ir: mvir.ViewIR,
    ingest: frozenset[int] | None = None,
    retractions: bool = False,
    value_scale: float = 64.0,
    max_weight: int = 1,
    path: str | None = None,
) -> list[Finding]:
    """Run every delta-safety pass over a schema-typed IR.

    ``ingest`` is the set of scan indices receiving deltas (None = every
    root, mirroring ``UpdateSpec.resolve_ingest``); ``retractions`` declares
    whether the update mix contains UPDATE/DELETE rows (retraction-only
    hazards are unreachable in insert-only scenarios); ``value_scale`` is
    the declared bound on |value| feeding AGG sums, ``max_weight`` the bound
    on |row weight| after consolidation.
    """
    path = path or f"ir:{ir.name or 'workload'}"
    if ingest is None:
        ingest = frozenset(ir.roots())
    out: list[Finding] = []
    dirty = _reaches(ir, ingest)

    def add(rule, level, node, msg):
        out.append(Finding(rule, level, path, node.name, msg))

    for v, node in enumerate(ir.nodes):
        op = node.effective_op
        # -- Z-set weight closure ------------------------------------------
        if op not in DELTA_RULES:
            add("weight-closure", "error", node,
                f"operator {node.op!r} has no Z-set delta rule: the engine "
                "cannot propagate signed weights through it")
            continue
        if not node.lifted:
            add("opaque-view", "warning", node,
                "closure not lifted into the IR: delta-safety is unchecked "
                "for this node")
            continue
        if node.schema is None:
            continue  # untyped IR: schema passes need infer_schemas first
        parents = [ir.nodes[p] for p in node.parents]
        node_dirty = dirty[v]
        # -- rid stability of splice paths ---------------------------------
        if op == "JOIN" and parents and parents[0].schema is not None \
                and not parents[0].schema.has_rid and node_dirty:
            add("join-ridless-left", "info", node,
                f"left input {parents[0].name} carries no rid: JOIN "
                "corrections cannot splice, engine falls back to full "
                "recompute every dirty round")
        if op == "UNION" and len(parents) >= 2 and any(
            p.schema is not None and not p.schema.has_rid for p in parents
        ) and node_dirty:
            add("union-ridless-input", "info", node,
                "a UNION input carries no rid: canonical rid order is "
                "undefined, engine falls back to full recompute")
        if retractions and node_dirty and op not in ("AGG", "SCAN") \
                and not node.schema.has_rid:
            add("ridless-retraction", "info", node,
                "output has no rid but the update mix retracts rows: "
                "retracting deltas cannot splice, engine recomputes fully")
        # -- AGG fixed-point overflow bound --------------------------------
        if op == "AGG" and parents:
            rows = max((est_rows(p) for p in parents), default=0.0)
            bound = rows * float(value_scale) * AGG_QUANTUM * max(
                int(max_weight), 1
            )
            if bound >= _I64_WRAP:
                add("agg-overflow", "error", node,
                    f"worst-case |sum| ≈ {bound:.3g} ≥ 2^63: int64 "
                    f"fixed-point sums wrap (rows≈{rows:.3g}, "
                    f"scale={value_scale:g}, quantum={AGG_QUANTUM:g})")
            elif bound >= _I64_HEADROOM:
                add("agg-overflow", "warning", node,
                    f"worst-case |sum| ≈ {bound:.3g} ≥ 2^62: less than one "
                    "doubling of headroom before int64 wraparound")
        # -- JOIN partial-fallback reachability ----------------------------
        if op == "JOIN" and len(node.parents) >= 2 and any(
            dirty[p] for p in node.parents[1:]
        ):
            add("join-fallback-reachable", "info", node,
                "an ingesting scan feeds the probe side: right-delta "
                "mapping changes can trigger the partial fallback "
                "(historical left re-read) — calibrate its cost via "
                "RoundReport.fallback_stats")
        # -- AGG downstream: children refresh fully ------------------------
        if op == "AGG" and node_dirty:
            kids = [c for p, c in ir.edges() if p == v]
            if kids:
                add("agg-downstream-full", "info", node,
                    f"{len(kids)} consumer(s) of a merged aggregate: AGG "
                    "publishes a REPLACED table, so every dirty round "
                    "recomputes its consumers in full")
    return out


def analyze_workload(
    workload,
    spec=None,
    value_scale: float = 64.0,
    default_n_cols: int = 4,
    device: str | torch.device | None = None,
) -> tuple[mvir.ViewIR, list[Finding]]:
    """Lift + type a workload and run the delta-safety passes.

    ``spec`` (an ``UpdateSpec``) supplies the ingest set and whether the mix
    retracts rows; None assumes the default every-root insert-only feed.
    Schema inference runs on ``device`` (default: the card).
    """
    ir = mvir.infer_schemas(
        mvir.lift_workload(workload), default_n_cols=default_n_cols,
        device=device,
    )
    ingest = None
    retractions = False
    if spec is not None:
        ingest = frozenset(spec.resolve_ingest(workload))
        retractions = (spec.update_frac + spec.delete_frac) > 0.0
    findings = check_ir(
        ir, ingest=ingest, retractions=retractions, value_scale=value_scale,
        path=f"ir:{workload.name}",
    )
    return ir, findings
