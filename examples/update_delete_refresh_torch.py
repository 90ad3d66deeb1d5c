"""UPDATE/DELETE-capable incremental MV refresh (Z-set weighted-row
deltas) on the PyTorch port: the walkthrough of
``examples/update_delete_refresh.py`` on ``repro_torch``.

Builds a small SPJ workload, then refreshes it for three rounds of mixed
churn — every ingesting scan appends new rows, rewrites 5% of its live
rows in place (retract + reinsert under the same rid), and deletes 3%
(bare tombstones) — twice: once recomputing every MV from scratch (full
updates) and once propagating weighted deltas through the operators
(incremental updates). The stored MVs are verified bitwise identical
before comparing costs, and the tombstone parts are consolidated at the
end to show the storage-side lifecycle.

    PYTHONPATH=src python examples/update_delete_refresh_torch.py             # on the card
    SC_SMOKE=1 PYTHONPATH=src python examples/update_delete_refresh_torch.py --device cpu
"""
import argparse
import json
import os
import shutil
import tempfile
from collections import Counter
from pathlib import Path

from repro_torch.core import CostModel
from repro_torch.device import resolve_device
from repro_torch.mv import (
    DiskStore,
    UpdateSpec,
    calibrate_sizes,
    dataplane,
    generate_workload,
    realize_workload,
    run_scenario,
    verify_scenario_equivalence,
)

SMOKE = bool(os.environ.get("SC_SMOKE"))  # CI-sized variant
N_ROUNDS = 2 if SMOKE else 3

CM = CostModel(disk_read_bw=60e6, disk_write_bw=40e6, mem_read_bw=1e12,
               mem_write_bw=1e12, disk_latency=2e-4)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="where tables live (default: the card)")
    dev = resolve_device(ap.parse_args(argv).device)

    root = Path(tempfile.mkdtemp(prefix="sc_zset_"))
    try:
        wl = realize_workload(generate_workload(14, seed=5),
                              bytes_per_root=1 << (15 if SMOKE else 18), device=dev)
        wl = calibrate_sizes(wl, DiskStore(root / "calib", device=dev))
        budget = sum(n.size for n in wl.nodes) * 0.5

        reports, stores = {}, {}
        for mode in ("full", "incremental"):
            spec = UpdateSpec(mode=mode, ingest_frac=0.1, update_frac=0.05,
                              delete_frac=0.03, n_rounds=N_ROUNDS)
            stores[mode] = DiskStore(root / mode, read_bw=60e6, write_bw=40e6,
                                     latency=2e-4, device=dev)
            reports[mode] = run_scenario(wl, stores[mode], budget, spec, CM)

        verify_scenario_equivalence(wl, stores["incremental"], stores["full"])
        print("=== Mixed insert/update/delete refresh (bitwise-identical MVs) ===")
        for mode, rep in reports.items():
            print(f"\n{mode}: build {rep.build_seconds:.2f}s, "
                  f"refresh {rep.refresh_seconds:.2f}s over {N_ROUNDS} rounds")
            for r in rep.rounds[1:]:
                mix = Counter(r.statuses.values())
                print(f"  round {r.round_idx}: {r.elapsed:.2f}s  "
                      f"statuses={dict(mix)}  flagged={len(r.plan.flagged)}  "
                      f"catalog_hits={r.run.catalog_hits}  "
                      f"partial_join_fallbacks={r.join_fallbacks}")
        ratio = (reports["full"].refresh_seconds
                 / reports["incremental"].refresh_seconds)
        print(f"\nincremental refresh is {ratio:.2f}x faster — same bytes on disk")

        store = stores["incremental"]
        multi = [n.name for n in wl.nodes if store.parts(n.name) > 1]
        print(f"\n{len(multi)} MVs accumulated tombstone/delta parts; "
              "consolidating:")
        for name in multi[:3]:
            before = store.manifest()[name]
            store.consolidate(name)
            print(f"  {name}: {store.parts(name)} part, "
                  f"{before} -> {store.manifest()[name]} manifest bytes")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print("launches " + json.dumps(dict(dataplane.launches)))


if __name__ == "__main__":
    main()
