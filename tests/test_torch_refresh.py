"""One S/C refresh round in the port against the same round in the JAX
package: ``generate_workload(12, seed=4)`` realized at 64 KiB per root,
calibrated, solved (Algorithm 2) and run by the ``Controller`` with a
bounded Memory Catalog — in both packages, on the port's CPU path.

The plans must be the same, every stored MV bitwise equal, the catalog
within budget, the manifests complete, and each package must read the
other's store.
"""
import numpy as np
import pytest

import repro.core as rc
import repro.mv as rmv
from repro.mv import tableops as RT
import repro_torch.core as pc
import repro_torch.mv as pmv
from repro_torch.convert import table_from_numpy, table_to_numpy
from repro_torch.mv import tableops as T

BYTES_PER_ROOT = 1 << 16
BUDGET_FRAC = 0.4


@pytest.fixture(scope="module")
def rounds(tmp_path_factory):
    root = tmp_path_factory.mktemp("refresh")
    out = {}
    for pkg, core, mv, kw in (("ref", rc, rmv, {}),
                              ("port", pc, pmv, {"device": "cpu"})):
        wl = mv.realize_workload(mv.generate_workload(12, seed=4),
                                 bytes_per_root=BYTES_PER_ROOT, **kw)
        wl = mv.calibrate_sizes(wl, mv.DiskStore(root / f"{pkg}_calib", **kw))
        graph = wl.to_graph()
        budget = sum(graph.sizes) * BUDGET_FRAC
        plan = core.solve(graph, budget=budget)
        serial = mv.DiskStore(root / f"{pkg}_serial", **kw)
        serial_report = mv.Controller(wl, serial, 0.0).run(core.serial_plan(graph))
        sc = mv.DiskStore(root / f"{pkg}_sc", **kw)
        report = mv.Controller(wl, sc, budget).run(plan)
        out[pkg] = dict(wl=wl, graph=graph, budget=budget, plan=plan,
                        serial=serial, sc=sc, report=report,
                        serial_report=serial_report, root=root / f"{pkg}_sc")
    return out


def test_same_calibrated_sizes_and_plan(rounds):
    ref, port = rounds["ref"], rounds["port"]
    assert ref["graph"].sizes == port["graph"].sizes
    assert ref["graph"].scores == port["graph"].scores
    for f in ("order", "flagged", "score", "peak_memory", "avg_memory",
              "iterations"):
        assert getattr(ref["plan"], f) == getattr(port["plan"], f), f
    assert port["plan"].flagged, "the round should short-circuit something"


def test_catalog_within_budget_and_manifest_complete(rounds):
    port = rounds["port"]
    rep = port["report"]
    assert rep.peak_catalog_bytes <= port["budget"]
    assert rep.peak_catalog_bytes == rounds["ref"]["report"].peak_catalog_bytes
    assert rep.catalog_hits == rounds["ref"]["report"].catalog_hits > 0
    names = {n.name for n in port["wl"].nodes}
    for store in (port["sc"], port["serial"]):
        assert set(store.manifest()) == names
    assert port["sc"].manifest() == rounds["ref"]["sc"].manifest()


def test_every_stored_mv_bitwise_equal_to_reference(rounds):
    ref, port = rounds["ref"], rounds["port"]
    for node in port["wl"].nodes:
        want = ref["sc"].read(node.name)
        RT.assert_tables_bitwise(want, table_to_numpy(port["sc"].read(node.name)),
                                 f"sc {node.name}")
        RT.assert_tables_bitwise(want, table_to_numpy(port["serial"].read(node.name)),
                                 f"serial {node.name}")


def test_each_package_reads_the_others_store(rounds):
    ref, port = rounds["ref"], rounds["port"]
    port_reads_ref = pmv.DiskStore(ref["root"], device="cpu")
    ref_reads_port = rmv.DiskStore(port["root"])
    for node in port["wl"].nodes:
        T.assert_tables_bitwise(port["sc"].read(node.name),
                                port_reads_ref.read(node.name), node.name)
        RT.assert_tables_bitwise(ref["sc"].read(node.name),
                                 ref_reads_port.read(node.name), node.name)


@pytest.mark.parametrize("rnd", [1, 2])
def test_scan_deltas_bitwise_equal_to_reference(rounds, rnd):
    """The SCAN nodes' Z-set delta generators (insert, update and delete
    mix) give the reference's rows round after round."""
    spec_kw = dict(ingest_frac=0.15, update_frac=0.15, delete_frac=0.1)
    rspec, pspec = rmv.UpdateSpec(**spec_kw), pmv.UpdateSpec(**spec_kw)
    for rn, pn in zip(rounds["ref"]["wl"].nodes, rounds["port"]["wl"].nodes):
        if rn.delta_fn is None:
            continue
        RT.assert_tables_bitwise(rn.delta_fn(rnd, rspec),
                                 table_to_numpy(pn.delta_fn(rnd, pspec)),
                                 f"{rn.name} round {rnd}")


def test_node_fns_bitwise_on_reference_inputs(rounds):
    """Each node's compute fn, fed the reference's own parent tables, gives
    the reference's output — node by node, not only end to end."""
    ref, port = rounds["ref"], rounds["port"]
    for rn, pn in zip(ref["wl"].nodes, port["wl"].nodes):
        inputs = [ref["sc"].read(ref["wl"].nodes[p].name) for p in rn.parents]
        want = rn.fn(inputs)
        got = pn.fn([table_from_numpy(t, "cpu") for t in inputs])
        RT.assert_tables_bitwise(want, table_to_numpy(got), rn.name)
    assert np.isfinite(port["serial_report"].elapsed)
