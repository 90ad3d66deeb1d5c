"""Merge-soundness checking for MQO shared subtrees (sc-lint, DESIGN.md §11).

``mv.mqo.merge_workload`` collapses structurally identical subexpressions
across MV definitions so each shared subtree refreshes once per round. The
whole scheme is sound only if every member of a merged equivalence class
*really* computes the same content — a forged or drifted merge (two views
whose "shared" prefix differs only in a captured FILTER threshold, say)
would silently serve one view's bytes to another's consumers. This pass
re-derives everything from the unmerged source workload, trusting nothing
the merge recorded:

* **unsound-merge** (error) — a claimed class's members have divergent
  structural fingerprints when recomputed independently (fresh lift +
  schema inference + ``node_fingerprints`` over the *source* workload).
* **opaque-merge** (error) — a class with ≥2 members contains a
  ``lifted=False`` closure: an un-inspectable node has no basis for
  equality and must never merge.
* **delta-unsafety of shared subtrees** — every node a shared
  representative depends on must be delta-safe under all its consumers'
  update kinds: ``delta_safety.check_ir`` runs over the merged IR under a
  retracting mix (the worst kind any consumer can bring), and its
  error-level findings inside a shared subtree are surfaced here; an
  ``opaque-view`` warning inside a shared subtree escalates to error.

The counterpart of ``repro.analysis.mqo_check``; the must-fire fixture is
``fixtures.forged_threshold_merge``, its quiet counterpart
``fixtures.genuine_shared_prefix_merge``. The re-derivation types its IR on
a device (the card unless the caller asks for the CPU).
"""
from __future__ import annotations

import torch

from ..mv import ir as mvir
from ..mv.mqo import MergedWorkload, node_fingerprints
from .delta_safety import check_ir
from .findings import Finding

__all__ = ["check_merged"]


def _shared_subtree(ir: mvir.ViewIR, shared_names: tuple[str, ...]) -> set[str]:
    """Names of every node some shared representative depends on (incl. the
    representatives themselves) in the merged IR."""
    index = {n.name: i for i, n in enumerate(ir.nodes)}
    seen: set[int] = set()
    stack = [index[name] for name in shared_names if name in index]
    while stack:
        v = stack.pop()
        if v in seen:
            continue
        seen.add(v)
        stack.extend(ir.nodes[v].parents)
    return {ir.nodes[v].name for v in seen}


def check_merged(
    merged: MergedWorkload,
    retractions: bool = True,
    value_scale: float = 64.0,
    path: str | None = None,
    device: str | torch.device | None = None,
) -> list[Finding]:
    """Verify a ``MergedWorkload``'s sharing claims against an independent
    re-derivation from its source workload.

    ``retractions`` declares the worst update kind any consumer of a shared
    subtree runs (True = UPDATE/DELETE mixes possible — the default,
    because a subtree shared by several views must be safe under the most
    demanding consumer); ``value_scale`` feeds the AGG overflow bound.
    Returns no findings for any ``merge_workload`` output over lifted
    definitions — the pass exists to catch forged or drifted provenance.
    The re-derivation's schema inference runs on ``device`` (default: the
    card).
    """
    path = path or f"mqo:{merged.source.name}"
    out: list[Finding] = []

    # 1-2. independent re-derivation of every claimed equivalence class
    re_ir = mvir.infer_schemas(mvir.lift_workload(merged.source), device=device)
    re_fps = node_fingerprints(re_ir)
    for rep_name, members in sorted(merged.classes.items()):
        if len(members) < 2:
            continue
        opaque = [m for m in members if not re_ir.nodes[m].lifted]
        if opaque:
            names = [merged.source.nodes[m].name for m in opaque]
            out.append(Finding(
                "opaque-merge", "error", path, rep_name,
                f"merged class contains opaque (lifted=False) closure(s) "
                f"{names}: an un-inspectable node has no basis for "
                "equality and must never merge",
            ))
            continue
        if len({re_fps[m] for m in members}) > 1:
            names = [merged.source.nodes[m].name for m in members]
            out.append(Finding(
                "unsound-merge", "error", path, rep_name,
                f"claimed-equal nodes {names} have divergent structural "
                "fingerprints when re-derived from the source (op, params, "
                "schema, or inputs differ): refreshing the representative "
                "once would serve wrong bytes to some consumer",
            ))

    # 3. delta-safety of the shared subtrees under the consumers' update kinds
    if merged.shared:
        subtree = _shared_subtree(merged.ir, merged.shared)
        op_of = {n.name: n.op for n in merged.ir.nodes}
        for f in check_ir(
            merged.ir, retractions=retractions, value_scale=value_scale,
            path=path,
        ):
            if f.symbol not in subtree:
                continue
            # SCAN deltas are supplied by ingestion, not derived from the
            # closure — opacity there is by design, not a merge hazard.
            if f.rule == "opaque-view" and op_of.get(f.symbol) != "SCAN":
                out.append(Finding(
                    "opaque-merge", "error", path, f.symbol,
                    "shared subtree contains an opaque closure: its delta "
                    "behavior is unchecked under the consumers' update "
                    "kinds",
                ))
            elif f.level == "error":
                out.append(f)
    return out
