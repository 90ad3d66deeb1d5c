#!/usr/bin/env python
"""sc-trace for the PyTorch port: trace a refresh scenario, export it, and
audit the plan.

Drives the port's observability layer (``repro_torch.obs``, DESIGN.md §12)
end to end, as ``tools/sc_trace.py`` does for the JAX package:

* ``demo``      — run a deterministic multi-round incremental scenario twice
  (traced and untraced) on a throttled store plus its discrete-event
  simulation, then export everything: a Chrome trace-event file with the
  real and sim tracks side by side (load in chrome://tracing or
  https://ui.perfetto.dev), the raw spans, the metrics snapshot, the
  predicted-vs-realized drift report, and the real-vs-sim per-node diff.
  Asserts the bitwise on/off contract (traced and untraced runs store
  identical MVs) and prints the measured tracing overhead. Tables live on
  ``--device`` (default: the card; ``cpu`` runs the kernels' plain
  versions).
* ``validate``  — structural CI gate on an exported trace file: well-formed
  events, non-negative timestamps/durations, spans nested in their rounds.
* ``summary``   — per-(track, category) span count/seconds/bytes table.
* ``diff``      — real-vs-sim task durations per (mv, partition, round).

Usage:
    PYTHONPATH=src python tools/sc_trace_torch.py demo --out results/trace_torch
    PYTHONPATH=src python tools/sc_trace_torch.py demo --device cpu --out /tmp/t
    PYTHONPATH=src python tools/sc_trace_torch.py validate results/trace_torch/trace.json
    PYTHONPATH=src python tools/sc_trace_torch.py summary results/trace_torch/spans.json
    PYTHONPATH=src python tools/sc_trace_torch.py diff results/trace_torch/spans.json

Exit status: 0 ok; 1 validation problems / bitwise divergence.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))

from repro_torch.core.speedup import CostModel  # noqa: E402
from repro_torch.obs import METRICS, Span, trace as tr  # noqa: E402
from repro_torch.obs.audit import audit_scenario  # noqa: E402
from repro_torch.obs.export import (  # noqa: E402
    diff_tracks,
    summarize,
    to_chrome_trace,
    validate_chrome_trace,
    write_chrome_trace,
)

# the laptop-scale "real NFS" tier of tools/sc_trace.py
STORE_KW = dict(read_bw=60e6, write_bw=40e6, latency=2e-4)
CM = CostModel(disk_read_bw=60e6, disk_write_bw=40e6, mem_read_bw=1e12,
               mem_write_bw=1e12, disk_latency=2e-4)


def _scenario(args):
    from repro_torch.mv.workloads import UpdateSpec, generate_workload, realize_workload

    wl = realize_workload(
        generate_workload(args.nodes, seed=args.seed),
        bytes_per_root=1 << 14, seed=args.seed, device=args.device,
    )
    spec = UpdateSpec(mode="incremental", n_rounds=args.rounds,
                      ingest_frac=0.15, update_frac=0.05)
    return wl, spec


def _run(wl, spec, root, device, workers=2):
    from repro_torch.mv.incremental import run_scenario
    from repro_torch.mv.storage import DiskStore

    store = DiskStore(root, device=device, **STORE_KW)
    t0 = time.perf_counter()
    rep = run_scenario(wl, store, budget_bytes=float(1 << 20), spec=spec,
                       cost_model=CM, n_compute_workers=workers, n_writers=1)
    return store, rep, time.perf_counter() - t0


def _save_spans(path: Path, spans) -> None:
    path.write_text(json.dumps([s._asdict() for s in spans]))


def _load_spans(path: str) -> list[Span]:
    return [Span(**d) for d in json.loads(Path(path).read_text())]


def cmd_demo(args) -> int:
    from repro_torch.mv.incremental import simulate_scenario, verify_scenario_equivalence

    wl, spec = _scenario(args)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    rc = 0
    with tempfile.TemporaryDirectory() as td:
        # 1) untraced reference run (also the overhead baseline)
        tr.enable(False)
        store_off, _, wall_off = _run(wl, spec, Path(td) / "off", args.device)
        assert not tr.drain(), "spans recorded while tracing disabled"

        # 2) traced run + its discrete-event simulation
        tr.enable(True)
        tr.clear()
        METRICS.clear()
        store_on, rep, wall_on = _run(wl, spec, Path(td) / "on", args.device)
        real_spans = tr.drain()
        simulate_scenario(wl, spec, CM, budget_bytes=float(1 << 20), n_workers=2)
        sim_spans = tr.drain()
        tr.enable(False)

        # 3) the bitwise on/off contract: tracing is passive
        try:
            verify_scenario_equivalence(wl, store_on, store_off)
            print("bitwise on/off: identical stored MVs")
        except AssertionError as e:
            print(f"bitwise on/off: DIVERGED: {e}")
            rc = 1

    spans = real_spans + sim_spans
    doc = to_chrome_trace(spans)
    problems = validate_chrome_trace(doc)
    if problems:
        rc = 1
        print(f"trace validation: {len(problems)} problem(s)")
        for p in problems[:10]:
            print(f"  {p}")
    else:
        print("trace validation: ok")

    write_chrome_trace(out / "trace.json", spans)
    _save_spans(out / "spans.json", spans)
    METRICS.export_json(out / "metrics.json")
    audit = audit_scenario(wl, rep, real_spans, CM)
    audit.save_json(out / "drift.json")
    (out / "diff.json").write_text(json.dumps(diff_tracks(spans), indent=1))

    overhead = (wall_on - wall_off) / wall_off if wall_off else 0.0
    print(f"real wall ({args.device or 'cuda'}): traced {wall_on:.3f}s vs untraced "
          f"{wall_off:.3f}s (overhead {overhead * 100:+.1f}%)")
    print(f"spans: {len(real_spans)} real + {len(sim_spans)} sim "
          f"-> {out / 'trace.json'}")
    print()
    print(audit.table())
    print()
    print(f"predicted {audit.predicted_s:.4f}s  realized {audit.realized_s:.4f}s"
          f"  drift {audit.drift_s:+.4f}s")
    return rc


def cmd_validate(args) -> int:
    doc = json.loads(Path(args.trace).read_text())
    problems = validate_chrome_trace(doc)
    if problems:
        print(f"{args.trace}: {len(problems)} problem(s)")
        for p in problems:
            print(f"  {p}")
        return 1
    n = len(doc.get("traceEvents", ()))
    print(f"{args.trace}: ok ({n} events)")
    return 0


def cmd_summary(args) -> int:
    agg = summarize(_load_spans(args.spans))
    w = max((len(k) for k in agg), default=10)
    print(f"{'track/cat'.ljust(w)} | {'count':>6} | {'seconds':>9} | bytes")
    for key in sorted(agg):
        a = agg[key]
        print(f"{key.ljust(w)} | {a['count']:6.0f} | {a['seconds']:9.4f} | "
              f"{a['bytes']:.0f}")
    return 0


def cmd_diff(args) -> int:
    rows = diff_tracks(_load_spans(args.spans))
    print(f"{'mv':>6} {'part':>4} {'round':>5} | {'real(s)':>9} {'sim(s)':>9} "
          f"| sim/real")
    for r in rows:
        ratio = r["sim_over_real"]
        print(f"{r['mv']:>6} {r['partition']:>4} {r['round']:>5} | "
              f"{(r['real_s'] if r['real_s'] is not None else float('nan')):9.4f} "
              f"{(r['sim_s'] if r['sim_s'] is not None else float('nan')):9.4f} | "
              f"{'-' if ratio is None else f'{ratio:.2f}'}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="sc-trace-torch", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    demo = sub.add_parser("demo", help="run + trace + export a scenario")
    demo.add_argument("--out", default=str(REPO / "results" / "trace_torch"))
    demo.add_argument("--nodes", type=int, default=12)
    demo.add_argument("--rounds", type=int, default=3)
    demo.add_argument("--seed", type=int, default=3)
    demo.add_argument("--device", default=None,
                      help="torch device of the tables (default: the card)")
    demo.set_defaults(fn=cmd_demo)

    val = sub.add_parser("validate", help="structural gate on a trace file")
    val.add_argument("trace")
    val.set_defaults(fn=cmd_validate)

    summ = sub.add_parser("summary", help="per-(track, cat) span totals")
    summ.add_argument("spans")
    summ.set_defaults(fn=cmd_summary)

    dif = sub.add_parser("diff", help="real-vs-sim per-(mv, round) durations")
    dif.add_argument("spans")
    dif.set_defaults(fn=cmd_diff)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
