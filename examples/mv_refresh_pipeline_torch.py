"""The paper's scenario inside the training framework, on the PyTorch port:
a recurring data-materialization pipeline (ingest → tokenize → pack →
stats → index) scheduled by S/C with a bounded catalog, then consumed by the
deterministic batch iterator (the walkthrough of
``examples/mv_refresh_pipeline.py`` on ``repro_torch``).

    PYTHONPATH=src python examples/mv_refresh_pipeline_torch.py             # on the card
    SC_SMOKE=1 PYTHONPATH=src python examples/mv_refresh_pipeline_torch.py --device cpu
"""
import argparse
import json
import os
import shutil
import tempfile
from pathlib import Path

from repro_torch.data import BatchIterator, DataConfig, materialize_dataset
from repro_torch.device import resolve_device
from repro_torch.mv import dataplane

SMOKE = bool(os.environ.get("SC_SMOKE"))  # CI-sized variant


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="where tables and batches live (default: the card)")
    dev = resolve_device(ap.parse_args(argv).device)

    root = Path(tempfile.mkdtemp(prefix="sc_pipeline_"))
    try:
        dcfg = DataConfig(n_shards=2 if SMOKE else 4,
                          docs_per_shard=32 if SMOKE else 64, doc_len=256,
                          seq_len=65, catalog_budget_bytes=2 << 20)
        out = materialize_dataset(dcfg, root, device=dev)
        plan, report, wl = out["plan"], out["report"], out["workload"]

        print("=== S/C-scheduled data materialization ===")
        print(f"nodes: {wl.n}   flagged in memory: {len(plan.flagged)}")
        print(f"execution order: {[wl.nodes[i].name for i in plan.order]}")
        print(f"catalog hits: {report.catalog_hits}   disk reads: {report.disk_reads}")
        print(f"peak catalog: {report.peak_catalog_bytes/1e6:.2f}MB "
              f"(budget {dcfg.catalog_budget_bytes/1e6:.2f}MB)")
        print(f"all {wl.n} artifacts persisted: "
              f"{sorted(out['store'].manifest())[:5]} ...")

        it = BatchIterator(root, dcfg, batch_size=8, device=dev)
        batch = it.next_batch()
        print(f"\nfirst batch: tokens {tuple(batch['tokens'].shape)} "
              f"labels {tuple(batch['labels'].shape)}")
        snap = it.get_state()
        a = it.next_batch()["tokens"]
        it.set_state(snap)
        b = it.next_batch()["tokens"]
        assert bool((a == b).all()), "iterator must replay deterministically"
        print("iterator state snapshot/restore: deterministic replay OK")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print("launches " + json.dumps(dict(dataplane.launches)))


if __name__ == "__main__":
    main()
