"""Quickstart on the PyTorch port: S/C on a toy MV refresh workload, end to
end in one file (the walkthrough of ``examples/quickstart.py`` on
``repro_torch``).

    PYTHONPATH=src python examples/quickstart_torch.py                  # on the card
    SC_SMOKE=1 PYTHONPATH=src python examples/quickstart_torch.py --device cpu

1. Build a dependency graph of materialization jobs (the paper's Fig. 4).
2. Solve S/C Opt (MKP + MA-DFS alternating optimization) for a bounded
   Memory Catalog.
3. Execute the plan with the real Controller: flagged outputs are consumed
   from memory while they persist in the background; everything still lands
   on disk (the SLA).
4. Compare wall-clock vs the serial baseline on a throttled store.

Tables live on ``--device`` (default: the card; ``cpu`` runs the plain
PyTorch versions of the data-plane kernels). The last line gives the
data-plane kernels' launches.
"""
import argparse
import json
import os
import shutil
import tempfile
from pathlib import Path

from repro_torch.core import CostModel, serial_plan, solve
from repro_torch.device import resolve_device
from repro_torch.mv import (
    Controller,
    DiskStore,
    calibrate_sizes,
    dataplane,
    generate_workload,
    realize_workload,
)

SMOKE = bool(os.environ.get("SC_SMOKE"))  # CI-sized variant

# a slow storage tier (emulates the paper's NFS) and a fast memory tier
cost_model = CostModel(disk_read_bw=40e6, disk_write_bw=25e6,
                       mem_read_bw=1e12, mem_write_bw=1e12, disk_latency=1e-4)
store_kw = dict(read_bw=40e6, write_bw=25e6, latency=1e-4)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="where tables live (default: the card)")
    dev = resolve_device(ap.parse_args(argv).device)

    root = Path(tempfile.mkdtemp(prefix="sc_quickstart_"))
    try:
        # 1. a 12-node MV refresh workload with real table operators
        workload = realize_workload(generate_workload(12, seed=4),
                                    bytes_per_root=1 << (16 if SMOKE else 19),
                                    device=dev)
        workload = calibrate_sizes(workload, DiskStore(root / "calib", device=dev))
        graph = workload.to_graph(cost_model)

        # 2. solve S/C Opt with a Memory Catalog = 40% of total intermediate bytes
        budget = sum(graph.sizes) * 0.4
        plan = solve(graph, budget=budget)
        print("=== S/C plan ===")
        print(plan.summary(graph))

        # 3 + 4. execute: serial baseline vs short-circuit
        t_serial = Controller(workload, DiskStore(root / "serial", device=dev, **store_kw),
                              0.0).run(serial_plan(graph)).elapsed
        report = Controller(workload, DiskStore(root / "sc", device=dev, **store_kw),
                            budget).run(plan)
        print(f"\nserial: {t_serial:.2f}s   S/C: {report.elapsed:.2f}s   "
              f"speedup: {t_serial / report.elapsed:.2f}x")
        print(f"catalog hits: {report.catalog_hits}   "
              f"peak catalog: {report.peak_catalog_bytes/1e6:.1f}MB "
              f"(budget {budget/1e6:.1f}MB)")
        assert report.peak_catalog_bytes <= budget
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print("launches " + json.dumps(dict(dataplane.launches)))


if __name__ == "__main__":
    main()
