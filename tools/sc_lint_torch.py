#!/usr/bin/env python
"""sc-lint for the PyTorch port: static verifier for delta-safety, kernel
determinism, and plan feasibility.

Runs every analysis pass of ``repro_torch.analysis`` over the port and over
the reference's representative workloads, as ``tools/sc_lint.py`` does for
the JAX package, then gates error/warning findings against the checked-in
baseline (``tools/sc_lint_torch_baseline.json``). Info findings are
report-only. The passes, in order:

* ``source``       — the AST lints over ``src/repro_torch/{mv,kernels}``;
* ``ptx``          — the PTX lints over every kernel of ``csrc/dataplane.cu``
  as ``nvcc`` compiles it (one ``lint-skipped`` info finding without
  ``nvcc``);
* ``delta-safety`` — Z-set closure, rid stability, AGG overflow and JOIN
  fallback over a realized workload and its P=4 expansion;
* ``plan``         — the solver's own plans, flat and hierarchical, checked
  for feasibility;
* ``mqo``          — ``check_merged`` over two ``merge_workload`` results;
* ``fixtures``     — the must-fire selftest: the historical-bug fixtures
  (``repro_torch.analysis.fixtures``) must trip their rules and the shipped
  fixes stay quiet, or a ``fixture-regression`` error gates.

Tables live on ``--device`` (default: the card; ``cpu`` runs the kernels'
plain versions). Given a ``record`` dict, the ptx pass puts there what it
read (``record["ptx"]``: per data-plane kernel, its instantiations and PTX
instructions) and the fixtures pass the rules each MAP fixture fired
(``record["fixtures"]``: ``{origin: {fixture: [rule, ...]}}``, origin
``committed`` and, with ``nvcc``, ``fresh``).

Usage:
    PYTHONPATH=src python tools/sc_lint_torch.py                 # human report
    PYTHONPATH=src python tools/sc_lint_torch.py --ci            # gate + JSON report
    PYTHONPATH=src python tools/sc_lint_torch.py --ci --device cpu
    PYTHONPATH=src python tools/sc_lint_torch.py --update-baseline

Exit status: 0 clean, 1 new gating findings or fixture regression.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))

from repro_torch import native  # noqa: E402
from repro_torch.analysis import (  # noqa: E402
    Finding,
    format_findings,
    gating,
    load_baseline,
    new_findings,
    save_baseline,
    stale_entries,
    to_json,
)
from repro_torch.analysis import determinism, fixtures  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402

BASELINE = REPO / "tools" / "sc_lint_torch_baseline.json"
DEFAULT_REPORT = REPO / "results" / "sc_lint_torch" / "report.json"
BASELINE_COMMENT = (
    "Accepted sc-lint debt of the PyTorch port: gating findings "
    "(error/warning) whose fingerprints are sanctioned. The reference's one "
    "entry (group_reduce's unstable grouping sort) has no counterpart: the "
    "port groups with torch.sort(stable=True). Regenerate with "
    "`python tools/sc_lint_torch.py --update-baseline`."
)


def _source_findings(device, record=None) -> list[Finding]:
    return determinism.lint_paths(REPO)


def _ptx_findings(device, record=None) -> list[Finding]:
    findings, per_kernel = determinism.lint_dataplane_kernels()
    if record is not None:
        record["ptx"] = per_kernel
    return findings


def _delta_safety_findings(device, record=None) -> list[Finding]:
    """Lift + type representative realized workloads and run the delta
    passes: the unpartitioned scenario-matrix workload and its P=4
    partitioned expansion, under a retracting update mix."""
    from repro_torch.analysis.delta_safety import analyze_workload
    from repro_torch.mv import (
        DiskStore,
        UpdateSpec,
        calibrate_sizes,
        generate_workload,
        realize_workload,
    )
    from repro_torch.mv.partition import partition_workload

    out: list[Finding] = []
    spec = UpdateSpec(mode="incremental", update_frac=0.2, delete_frac=0.1)
    with tempfile.TemporaryDirectory() as td:
        wl = calibrate_sizes(
            realize_workload(
                generate_workload(n_nodes=14, seed=3),
                bytes_per_root=1 << 15, device=device,
            ),
            DiskStore(Path(td) / "calib", device=device),
        )
        _, f1 = analyze_workload(wl, spec=spec, device=device)
        out.extend(f1)
        pwl, _ = partition_workload(wl, 4)
        _, f2 = analyze_workload(pwl, spec=spec, device=device)
        out.extend(f2)
    return out


def _plan_findings(device, record=None) -> list[Finding]:
    """Feasibility-check the solver's own output on a flat instance and on a
    hierarchical P=16 instance (the path that historically needed the shed
    loop)."""
    from repro_torch.analysis.plan_check import check_plan
    from repro_torch.core.altopt import solve, solve_hierarchical
    from repro_torch.mv import generate_workload

    out: list[Finding] = []

    graph = generate_workload(n_nodes=24, seed=0).to_graph()
    budget = 0.3 * sum(graph.sizes)
    for k in (1, 4):
        plan = solve(graph, budget, n_workers=k)
        out.extend(check_plan(
            graph, plan.flagged, plan.order, budget, k,
            path="plan:flat_n24_s0", symbol=f"k{k}",
        ))

    P = 16
    pplan = solve_hierarchical(graph, budget, P, n_workers=2)
    expanded, _ = graph.expand_partitions(P, None)
    out.extend(check_plan(
        expanded, pplan.plan.flagged, pplan.plan.order, budget,
        pplan.plan.n_workers, path=f"plan:hier_n24_P{P}", symbol="k2",
    ))
    return out


def _mqo_findings(device, record=None) -> list[Finding]:
    """Merge-soundness (DESIGN.md §11): ``check_merged`` over the realized
    shared-prefix MQO workload and the scenario-matrix generator workload
    (no duplicate definitions: its merge must be a no-op and still
    verify)."""
    from repro_torch.analysis.mqo_check import check_merged
    from repro_torch.mv import generate_workload, realize_workload
    from repro_torch.mv.mqo import merge_workload, shared_prefix_workload

    out: list[Finding] = []
    wl = realize_workload(
        shared_prefix_workload(n_views=3), bytes_per_root=1 << 15, seed=3,
        device=device,
    )
    out.extend(check_merged(merge_workload(wl, device=device), device=device))
    wl2 = realize_workload(
        generate_workload(n_nodes=14, seed=3), bytes_per_root=1 << 15,
        device=device,
    )
    out.extend(check_merged(merge_workload(wl2, device=device), device=device))
    return out


def fresh_map_fixtures() -> dict[str, str] | None:
    """The two MAP fixtures compiled now (``native.compile_ptx``), by name,
    or None without ``nvcc``."""
    if native.nvcc_path() is None:
        return None
    return {
        "legacy_fused_map": native.compile_ptx(
            fixtures.LEGACY_FUSED_MAP_CU, "fixture_legacy_fused_map"),
        "shipped_map": native.compile_ptx(
            fixtures.SHIPPED_MAP_CU, "fixture_shipped_map"),
    }


def _fixture_findings(device, record=None) -> list[Finding]:
    """Must-fire selftest: each historical-bug fixture must trip its rules,
    and the shipped fix must be quiet — the filter-mask sources, the
    committed PTX pair, the same pair compiled fresh where ``nvcc`` is, and
    the forged / genuine MQO merges. A miss is a gating, un-baselineable
    regression of the linter itself."""
    out: list[Finding] = []

    def regression(symbol: str, msg: str):
        out.append(Finding(
            "fixture-regression", "error", "repro_torch/analysis/fixtures.py",
            symbol, msg,
        ))

    legacy = determinism.lint_source(
        fixtures.LEGACY_FILTER_MASK_SRC, "fixture:legacy_filter_mask"
    )
    if not any(f.rule == "static-arg-retrace" for f in legacy):
        regression("LEGACY_FILTER_MASK_SRC",
                   "static-arg-retrace no longer fires on the historical "
                   "static-threshold _filter_mask")
    shipped = determinism.lint_source(
        fixtures.SHIPPED_FILTER_MASK_SRC, "fixture:shipped_filter_mask"
    )
    if gating(shipped):
        regression("SHIPPED_FILTER_MASK_SRC",
                   "linter fires on the shipped traced-threshold filter")

    pairs = [("committed", fixtures.LEGACY_FUSED_MAP_PTX,
              fixtures.SHIPPED_MAP_PTX)]
    fresh = fresh_map_fixtures()
    if fresh is not None:
        pairs.append(("fresh", fresh["legacy_fused_map"], fresh["shipped_map"]))
    fired = {}
    for origin, legacy_ptx, shipped_ptx in pairs:
        rules = {f.rule for f in determinism.lint_ptx(
            legacy_ptx, "legacy_fused_map", f"fixture:{origin}_legacy_fused_map")}
        for rule, what in (("transcendental-kernel", "tanhf"),
                           ("fma-contraction", "mul+add")):
            if rule not in rules:
                regression("legacy_fused_map",
                           f"{rule} no longer fires on the {origin} PTX of "
                           f"the fused {what} MAP kernel")
        hits = determinism.lint_ptx(
            shipped_ptx, "shipped_map", f"fixture:{origin}_shipped_map")
        fired[origin] = {"legacy_fused_map": sorted(rules),
                         "shipped_map": sorted({f.rule for f in hits})}
        if gating(hits):
            regression("shipped_map",
                       f"linter fires on the {origin} PTX of the shipped "
                       "softsign map kernel: "
                       + "; ".join(f.rule for f in hits))
    if record is not None:
        record["fixtures"] = fired

    from repro_torch.analysis.mqo_check import check_merged

    forged = check_merged(fixtures.forged_threshold_merge(device=device),
                          device=device)
    if not any(f.rule == "unsound-merge" for f in forged):
        regression("forged_threshold_merge",
                   "unsound-merge no longer fires on the forged "
                   "captured-threshold merge")
    honest = check_merged(fixtures.genuine_shared_prefix_merge(device=device),
                          device=device)
    if gating(honest):
        regression("genuine_shared_prefix_merge",
                   "merge-soundness pass fires on an honest merge_workload "
                   "result: " + "; ".join(f.rule for f in honest))
    return out


PASSES = (
    ("source", _source_findings),
    ("ptx", _ptx_findings),
    ("delta-safety", _delta_safety_findings),
    ("plan", _plan_findings),
    ("mqo", _mqo_findings),
    ("fixtures", _fixture_findings),
)


def collect(device, verbose: bool = True, record: dict | None = None
            ) -> tuple[list[Finding], dict[str, int]]:
    """Every pass's findings, and their number per pass; each pass puts
    what it read into ``record`` when one is given."""
    findings: list[Finding] = []
    counts: dict[str, int] = {}
    for name, pass_fn in PASSES:
        got = pass_fn(device, record)
        counts[name] = len(got)
        findings.extend(got)
        if verbose:
            print(f"  pass {name:13s} {len(got)} finding(s)")
    return findings, counts


def describe(device) -> str:
    """The device the passes ran on, the compiler and the build directory:
    what the PTX pass read."""
    import torch

    card = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "plain PyTorch versions")
    nvcc = native.nvcc_version() if native.nvcc_path() else "not found"
    return (f"device {device} ({card}); nvcc: {nvcc}; "
            f"build: {native.BUILD_DIR}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ci", action="store_true",
                    help="gate against the baseline and write a JSON report")
    ap.add_argument("--update-baseline", action="store_true",
                    help="record current gating findings as accepted debt")
    ap.add_argument("--report", type=Path, default=None,
                    help=f"JSON report path (default {DEFAULT_REPORT} "
                         "under --ci)")
    ap.add_argument("--baseline", type=Path, default=BASELINE)
    ap.add_argument("--device", default=None,
                    help="where tables live (default: the card; cpu runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    env = describe(device)
    print(f"sc-lint (port) over {REPO}")
    print(env)
    findings, counts = collect(device)

    if args.update_baseline:
        fps = save_baseline(args.baseline, findings, comment=BASELINE_COMMENT)
        print(f"baseline updated: {len(fps)} fingerprint(s) -> "
              f"{args.baseline}")
        return 0

    baseline = load_baseline(args.baseline)
    new = new_findings(findings, baseline)
    stale = stale_entries(findings, baseline)
    info = [f for f in findings if f.level == "info"]

    if findings:
        print()
        print(format_findings(findings))
    print()
    print(f"{len(findings)} finding(s): {len(gating(findings))} gating "
          f"({len(new)} new vs baseline), {len(info)} info")
    for fp in stale:
        print(f"stale baseline entry (finding gone — prune it): {fp}")

    report_path = args.report or (DEFAULT_REPORT if args.ci else None)
    if report_path is not None:
        report_path.parent.mkdir(parents=True, exist_ok=True)
        report_path.write_text(json.dumps({
            "environment": env,
            "counts": counts,
            "baseline": sorted(baseline),
            "new_fingerprints": [f.fingerprint for f in new],
            "stale_baseline_entries": stale,
            "findings": to_json(findings),
        }, indent=2) + "\n")
        print(f"report -> {report_path}")

    if new:
        print(f"FAIL: {len(new)} new gating finding(s) not in baseline")
        return 1
    print("OK: no new gating findings")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
