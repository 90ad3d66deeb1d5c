"""Trace a refresh scenario on the PyTorch port and export it for Perfetto
(DESIGN.md §12): the walkthrough of ``examples/traced_refresh.py`` on
``repro_torch``.

Runs a short incremental-refresh scenario with span tracing on (the
``SC_TRACE=1`` switch, enabled programmatically here), simulates the same
scenario on the discrete-event backend so both timelines share one trace,
then exports to ``results/trace_example_torch/`` (under the working
directory):

* ``trace.json``  — Chrome trace-event file; open it in chrome://tracing or
  https://ui.perfetto.dev to see the real and simulated tracks side by
  side, with the Memory Catalog occupancy rendered as a counter graph;
* ``drift.json``  — the predicted-vs-realized plan audit: the planner's
  per-node speedup scores joined against the savings the traced run
  actually realized.

    PYTHONPATH=src python examples/traced_refresh_torch.py             # on the card
    SC_SMOKE=1 PYTHONPATH=src python examples/traced_refresh_torch.py --device cpu

(Equivalent one-shot CLI: ``python tools/sc_trace_torch.py demo``.)
"""
import argparse
import json
import os
import shutil
import tempfile
from pathlib import Path

from repro_torch.core import CostModel
from repro_torch.device import resolve_device
from repro_torch.mv import (
    DiskStore,
    UpdateSpec,
    dataplane,
    generate_workload,
    realize_workload,
    run_scenario,
    simulate_scenario,
)
from repro_torch.obs import METRICS, trace
from repro_torch.obs.audit import audit_scenario
from repro_torch.obs.export import summarize, validate_chrome_trace, \
    to_chrome_trace, write_chrome_trace

SMOKE = bool(os.environ.get("SC_SMOKE"))  # CI-sized variant
N_ROUNDS = 2 if SMOKE else 3

CM = CostModel(disk_read_bw=60e6, disk_write_bw=40e6, mem_read_bw=1e12,
               mem_write_bw=1e12, disk_latency=2e-4)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="where tables live (default: the card)")
    dev = resolve_device(ap.parse_args(argv).device)

    trace.enable(True)  # what SC_TRACE=1 does at import time
    trace.clear()
    METRICS.clear()

    root = Path(tempfile.mkdtemp(prefix="sc_traced_"))
    out = Path("results/trace_example_torch")
    try:
        wl = realize_workload(generate_workload(12, seed=3),
                              bytes_per_root=1 << (14 if SMOKE else 16), device=dev)
        spec = UpdateSpec(mode="incremental", n_rounds=N_ROUNDS,
                          ingest_frac=0.15, update_frac=0.05)
        budget = sum(n.size for n in wl.nodes) * 0.5

        store = DiskStore(root / "store", read_bw=60e6, write_bw=40e6,
                          latency=2e-4, device=dev)
        rep = run_scenario(wl, store, budget, spec, CM, n_compute_workers=2)
        real_spans = trace.drain()

        simulate_scenario(wl, spec, CM, budget, n_workers=2)
        sim_spans = trace.drain()

        spans = real_spans + sim_spans
        problems = validate_chrome_trace(to_chrome_trace(spans))
        assert not problems, problems
        p = write_chrome_trace(out / "trace.json", spans)
        print(f"{len(real_spans)} real + {len(sim_spans)} sim spans -> {p}")
        print("open in chrome://tracing or https://ui.perfetto.dev\n")

        for key, agg in sorted(summarize(spans).items()):
            print(f"  {key:<18} {agg['count']:4.0f} spans "
                  f"{agg['seconds']:8.3f}s {agg['bytes']:12.0f}B")

        audit = audit_scenario(wl, rep, real_spans, CM)
        audit.save_json(out / "drift.json")
        print(f"\npredicted {audit.predicted_s:.4f}s vs realized "
              f"{audit.realized_s:.4f}s (drift {audit.drift_s:+.4f}s)")
        print(audit.table())
    finally:
        trace.enable(False)
        shutil.rmtree(root, ignore_errors=True)
    print("launches " + json.dumps(dict(dataplane.launches)))


if __name__ == "__main__":
    main()
