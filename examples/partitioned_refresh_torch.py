"""Partition-granular S/C on a skewed workload at P=8 (DESIGN.md §7-8), on
the PyTorch port: the walkthrough of ``examples/partitioned_refresh.py`` on
``repro_torch``.

    PYTHONPATH=src python examples/partitioned_refresh_torch.py             # on the card
    SC_SMOKE=1 PYTHONPATH=src python examples/partitioned_refresh_torch.py --device cpu

The walkthrough (all on real tables, bitwise-verified):

1. Build a workload whose keys follow a Zipf distribution
   (``realize_workload(key_skew=...)``), so hash partitioning yields
   genuinely uneven partition sizes — a few hot partitions carry most of
   the bytes.
2. Pick a Memory Catalog budget *below the hottest MV's size*. Whole-MV
   planning (P=1) must exclude that MV outright; partition-granular
   planning (P=8) pins whichever of its partitions fit — *partial pinning*
   of an over-budget MV — and the initial build gets faster on a throttled
   store because the hot MV's consumers now read most of it from memory.
3. Refresh for three incremental rounds at P=8. Each round's small delta
   routes to only the partitions its keys hash to; clean partitions are
   pruned before dispatch (*dirty-partition pruning*).
4. Verify the partitioned store reassembles bitwise-identically to an
   unpartitioned full-recompute reference.

Set ``SC_SMOKE=1`` for the CI-sized variant (smaller tables, fewer
rounds).
"""
import argparse
import json
import os
import shutil
import tempfile
from pathlib import Path

from repro_torch.core import CostModel, solve, solve_partitioned
from repro_torch.device import resolve_device
from repro_torch.mv import (
    Controller,
    DiskStore,
    UpdateSpec,
    calibrate_sizes,
    dataplane,
    generate_workload,
    partition_entry_name,
    partition_table,
    partition_workload,
    realize_workload,
    run_partitioned_scenario,
    run_scenario,
    table_nbytes,
    verify_partitioned_equivalence,
)

SMOKE = bool(os.environ.get("SC_SMOKE"))
P = 8
N_ROUNDS = 2 if SMOKE else 3
# big enough that throttled byte movement dwarfs the per-part-file fsync
# overhead P-way partitioning multiplies (80 part files instead of 10)
BYTES_PER_ROOT = 1 << (16 if SMOKE else 22)

# bandwidth-throttled storage (no per-op latency: partitioning multiplies
# the op count by P, and this example is about byte placement, not seeks)
BW = 15e6
CM = CostModel(disk_read_bw=BW, disk_write_bw=BW, mem_read_bw=1e12,
               mem_write_bw=1e12, disk_latency=0.0)
store_kw = dict(read_bw=BW, write_bw=BW, latency=0.0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="where tables live (default: the card)")
    dev = resolve_device(ap.parse_args(argv).device)

    root = Path(tempfile.mkdtemp(prefix="sc_partitioned_"))
    try:
        # -- 1. skewed real workload --------------------------------------
        wl = realize_workload(
            generate_workload(10, seed=23), bytes_per_root=BYTES_PER_ROOT,
            seed=23, key_skew=1.3, device=dev,
        )
        wl = calibrate_sizes(wl, DiskStore(root / "calib", device=dev))

        children = [0] * wl.n
        for a, _ in wl.edges():
            children[a] += 1
        hot = max(
            (v for v in range(wl.n) if children[v] > 0),
            key=lambda v: children[v] * wl.nodes[v].size,
        )
        # budget: 60% of the hot MV — too small to flag it whole, enough for
        # most of its partitions plus the small intermediates
        budget = wl.nodes[hot].size * 0.6
        print("=== Skewed workload ===")
        print(f"nodes: {wl.n}   hot MV: {wl.nodes[hot].name} "
              f"({wl.nodes[hot].size / 1e6:.2f}MB, {children[hot]} consumers)")
        print(f"catalog budget: {budget / 1e6:.2f}MB "
              f"(= 60% of the hot MV -> whole-MV planning cannot flag it)")

        # -- 2. whole-MV vs partition-granular plans ----------------------
        # model the skewed per-partition byte shares from an observed routed
        # scan (the paper's "metrics from previous runs", at partition
        # granularity)
        scan0 = next(n for n in wl.nodes if not n.parents)
        routed = partition_table(scan0.delta_fn(0, 0.1), P)
        shares = [max(table_nbytes(t), 1.0) for t in routed]
        shares = [s / sum(shares) for s in shares]

        g = wl.to_graph(CM)
        whole = solve(g, budget=budget)
        assert hot not in whole.flagged, "whole-MV planner must exclude the hot MV"
        part = solve_partitioned(g, budget, P, cost_model=CM, shares=shares)
        hot_frac = part.residency_fraction(hot)
        print("\n=== Plans ===")
        print(f"P=1: flags {len(whole.flagged)}/{wl.n} MVs, hot MV excluded")
        print(f"P={P}: pins partitions "
              f"{sorted(p for v, p in part.flagged_partitions if v == hot)} "
              f"of the hot MV ({hot_frac:.0%} residency — partial pinning)")
        assert 0.0 < hot_frac, "partition planner should pin some hot partitions"

        # build: the pinned hot partitions short-circuit their consumers'
        # reads, which whole-MV planning structurally cannot
        pwl, _ = partition_workload(wl, P, shares=shares)
        r1 = Controller(wl, DiskStore(root / "b1", device=dev, **store_kw),
                        budget).run(whole)
        r8 = Controller(
            pwl, DiskStore(root / "b8", device=dev, **store_kw), budget
        ).run(part.plan)
        print(f"build: P=1 {r1.elapsed:.2f}s "
              f"({r1.read_seconds:.2f}s reading, {r1.catalog_hits} hits)   "
              f"P={P} {r8.elapsed:.2f}s "
              f"({r8.read_seconds:.2f}s reading, {r8.catalog_hits} hits)   "
              f"-> {r1.elapsed / r8.elapsed:.2f}x wall, "
              f"{r1.read_seconds / max(r8.read_seconds, 1e-9):.1f}x less "
              f"blocking read")

        # -- 3. incremental rounds: routing + dirty-partition pruning -----
        # a trickle of ~12 inserted rows per round: with Zipf keys the
        # handful of new rows hashes into few partitions, so most of the
        # partition tasks are pruned as clean
        rows = max(64, BYTES_PER_ROOT // 32)
        spec_kw = dict(ingest_frac=12.0 / rows, n_rounds=N_ROUNDS)
        ref = DiskStore(root / "ref", device=dev)  # unpartitioned full recompute
        run_scenario(wl, ref, budget, UpdateSpec(mode="full", **spec_kw), CM)

        spec = UpdateSpec(mode="incremental", **spec_kw)
        part_store = DiskStore(root / "p8", device=dev)
        rep8 = run_partitioned_scenario(
            wl, P, part_store, budget, spec, CM, shares=shares
        )
        print("\n=== Incremental rounds at P=8 (dirty-partition pruning) ===")
        for r in rep8.rounds[1:]:
            pruned = sum(1 for s in r.run.skipped if "@p" in s)
            print(f"round {r.round_idx}: {pruned}/{wl.n * P} partition tasks "
                  f"pruned as clean")
            assert pruned > 0, "a skewed trickle must leave clean partitions"

        # -- 4. bitwise equivalence + the skew, straight from the manifest
        verify_partitioned_equivalence(wl, part_store, P, ref)
        scan = next(n for n in wl.nodes if not n.parents)
        sizes = [part_store.manifest().get(partition_entry_name(scan.name, p), 0)
                 for p in range(P)]
        print("\npartitioned == unpartitioned recompute: bitwise OK")
        print(f"{scan.name} partition bytes (Zipf keys): "
              f"{[f'{s / 1e3:.0f}K' for s in sizes]}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print("launches " + json.dumps(dict(dataplane.launches)))


if __name__ == "__main__":
    main()
