"""The port's operator IR (``repro_torch.mv.ir``) against the JAX package's.

The same seeded workloads are realized in both packages (the port's tables
on the CPU, the plain versions of its kernels). Lifted IRs must agree field
by field (op, parents, params, partition, ``param_src``, ``lifted``, size
and schemas as numpy dtype strings) flat and P=4 partitioned; the closure
walk must read the port's own closures; inferred schemas must match executed
tables; and IR-compiled execution must be bitwise the closure execution and
the reference's stores, across the reference tests' seed x update-kind x
worker matrix. Tolerance 0 everywhere.
"""
import dataclasses as dc

import numpy as np
import pytest
import torch

import repro.core as rc
import repro.mv as rmv
from repro.core.altopt import serial_plan as r_serial_plan
from repro.mv import ir as rir
from repro.mv import tableops as RT
from repro.mv.partition import partition_workload as r_partition_workload
import repro_torch.core as pc
import repro_torch.mv as pmv
from repro_torch.convert import table_to_numpy
from repro_torch.core.altopt import serial_plan
from repro_torch.mv import ir as mvir
from repro_torch.mv import tableops as T
from repro_torch.mv.partition import partition_workload
from repro_torch.mv.workloads import PROJECT_KEEP_FRAC, filter_threshold

CM_KW = dict(disk_read_bw=50e6, disk_write_bw=50e6, mem_read_bw=1e12,
             mem_write_bw=1e12, disk_latency=0.0)
RCM, PCM = rc.CostModel(**CM_KW), pc.CostModel(**CM_KW)
SPEC_KW = {
    "insert": dict(ingest_frac=0.3, n_rounds=2),
    "mixed": dict(ingest_frac=0.25, update_frac=0.2, delete_frac=0.1, n_rounds=2),
    "delete": dict(ingest_frac=0.2, delete_frac=0.3, n_rounds=2),
}


def build(tmp_path, n_nodes=10, seed=3, bytes_per_root=1 << 13):
    """The same calibrated workload in both packages: (reference, port)."""
    ref = rmv.calibrate_sizes(
        rmv.realize_workload(rmv.generate_workload(n_nodes=n_nodes, seed=seed),
                             bytes_per_root=bytes_per_root),
        rmv.DiskStore(tmp_path / "calib_ref"))
    port = pmv.calibrate_sizes(
        pmv.realize_workload(pmv.generate_workload(n_nodes=n_nodes, seed=seed),
                             bytes_per_root=bytes_per_root, device="cpu"),
        pmv.DiskStore(tmp_path / "calib_port", device="cpu"))
    return ref, port


def assert_same_ir(ref_ir, port_ir):
    assert (ref_ir.name, ref_ir.n_partitions, ref_ir.n) == \
        (port_ir.name, port_ir.n_partitions, port_ir.n)
    for a, b in zip(ref_ir.nodes, port_ir.nodes):
        assert dc.asdict(a) == dc.asdict(b), a.name


def assert_same_store(ref_store, port_store, names):
    assert ref_store.manifest() == port_store.manifest()
    for name in names:
        RT.assert_tables_bitwise(ref_store.read(name),
                                 table_to_numpy(port_store.read(name)), name)


# ---------------------------------------------------------------------------
# lifting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [3, 7])
@pytest.mark.parametrize("P", [1, 4])
def test_lifted_and_typed_ir_matches_reference(tmp_path, seed, P):
    ref, port = build(tmp_path, n_nodes=8 if P > 1 else 10, seed=seed)
    if P > 1:
        ref, _ = r_partition_workload(ref, P)
        port, _ = partition_workload(port, P)
    lifted = mvir.lift_workload(port)
    assert_same_ir(rir.lift_workload(ref), lifted)
    typed = mvir.infer_schemas(lifted, device="cpu")
    assert_same_ir(rir.infer_schemas(rir.lift_workload(ref)), typed)
    assert all(n.lifted and n.schema is not None for n in typed.nodes)


def test_lift_recovers_ops_params_and_structure(tmp_path):
    _, wl = build(tmp_path, seed=3)
    ir = mvir.lift_workload(wl)
    assert ir.n == len(wl.nodes)
    for i, (node, orig) in enumerate(zip(ir.nodes, wl.nodes)):
        assert (node.name, node.op, node.parents) == (orig.name, orig.op, tuple(orig.parents))
        assert node.lifted, f"{orig.name} ({orig.op}) not lifted"
        assert node.param_src == i
        if orig.op == "FILTER":
            assert node.param("threshold") == filter_threshold(i)
        if orig.op == "PROJECT":
            assert node.param("keep_frac") == PROJECT_KEEP_FRAC
    for node in ir.nodes:
        if node.op in ("JOIN", "UNION") and len(node.parents) < 2:
            assert node.effective_op == "MAP"


def test_closure_walk_reads_the_ports_closures(tmp_path):
    """``make_fn`` captures ``i`` and ``op``; a scan's ``delta_fn`` reaches
    ``initial_load`` and its ``rows`` / ``n_cols`` / ``kmod``; a partitioned
    scan's ``_scan_fn(router, p)`` yields the router's original closure and
    ``p`` — the same values the reference's walk reads from its own."""
    ref, port = build(tmp_path, n_nodes=8, seed=1)
    for i, (rn, pn) in enumerate(zip(ref.nodes, port.nodes)):
        cv = mvir._cells(pn.fn)
        assert (cv["i"], cv["op"]) == (i, pn.op)
        if pn.op == "SCAN":
            layout = mvir._scan_layout(pn.delta_fn)
            assert layout == rir._scan_layout(rn.delta_fn)
            assert layout["rows"] == 256 and layout["n_cols"] == 4
    P = 4
    pwl, _ = partition_workload(port, P)
    for idx, node in enumerate(pwl.nodes):
        base, p = mvir._unwrap_partition(node.fn)
        assert p == (idx % P if node.op == "SCAN" else None)
        assert mvir._cells(base)["i"] == idx // P
    assert mvir._cells(lambda inputs: inputs) == {}


def test_lift_partitioned_records_partition_ids(tmp_path):
    _, wl = build(tmp_path, n_nodes=8, seed=1)
    pwl, _ = partition_workload(wl, 4)
    ir = mvir.lift_workload(pwl)
    assert ir.n_partitions == 4
    assert all(n.lifted for n in ir.nodes)
    assert [n.partition for n in ir.nodes] == [i % 4 for i in range(ir.n)]


def test_unrealized_and_opaque_nodes_lift_as_reference():
    """A modeled-only workload (no closures) and a node with a foreign
    closure: lifted / opaque exactly as the reference decides."""
    ref = rmv.generate_workload(n_nodes=9, seed=2)
    port = pmv.generate_workload(n_nodes=9, seed=2)
    assert_same_ir(rir.lift_workload(ref), mvir.lift_workload(port))
    assert all(n.lifted == (n.op != "SCAN") for n in mvir.lift_workload(port).nodes)

    def foreign(mv, wl):
        return mv.Workload(name="foreign", nodes=[
            dc.replace(n, fn=(lambda inputs: inputs[0]) if n.parents else None)
            for n in wl.nodes])

    ir = mvir.lift_workload(foreign(pmv, port))
    assert_same_ir(rir.lift_workload(foreign(rmv, ref)), ir)
    assert not any(n.lifted for n in ir.nodes)


# ---------------------------------------------------------------------------
# schemas
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.int64, np.int32, np.float32, np.float64,
                                   np.bool_, np.uint8])
def test_schema_keeps_numpy_dtype_strings(dtype):
    table = {"key": np.arange(3, dtype=np.int64), "v": np.zeros(3, dtype=dtype),
             "weight": np.ones(3, dtype=np.int64)}
    want = rir.Schema.from_table(table)
    got = mvir.Schema.from_table({k: torch.from_numpy(v) for k, v in table.items()})
    assert got.columns == want.columns and "weight" not in got.names()
    assert got.to_dtypes() == {"key": torch.int64,
                               "v": torch.from_numpy(np.zeros(0, dtype)).dtype}
    empty = got.empty_table("cpu")
    assert all(v.shape == (0,) and v.device.type == "cpu" for v in empty.values())
    assert mvir.Schema.from_table(empty) == got
    assert mvir.scan_table_schema(4).columns == rir.scan_table_schema(4).columns
    assert mvir.scan_table_schema(1, with_rid=False).columns == \
        rir.scan_table_schema(1, with_rid=False).columns


@pytest.mark.parametrize("P", [1, 4])
def test_inferred_schemas_match_executed_tables(tmp_path, P):
    _, wl = build(tmp_path, n_nodes=8, seed=5)
    if P > 1:
        wl, _ = partition_workload(wl, P)
    ir = mvir.infer_schemas(mvir.lift_workload(wl), device="cpu")
    store = pmv.DiskStore(tmp_path / f"exec{P}", device="cpu")
    pmv.Controller(wl, store, budget_bytes=0.0).run(serial_plan(wl.to_graph()))
    for node in ir.nodes:
        assert node.schema == mvir.Schema.from_table(store.read(node.name)), node.name


def test_scan_schema_override_and_default_width():
    ref = rmv.generate_workload(n_nodes=7, seed=4)
    port = pmv.generate_workload(n_nodes=7, seed=4)
    override = {0: (("key", "<i8"), ("c0", "<f8"))}
    got = mvir.infer_schemas(mvir.lift_workload(port), default_n_cols=3, device="cpu",
                             scan_schemas={k: mvir.Schema(v) for k, v in override.items()})
    want = rir.infer_schemas(rir.lift_workload(ref), default_n_cols=3,
                             scan_schemas={k: rir.Schema(v) for k, v in override.items()})
    assert_same_ir(want, got)


# ---------------------------------------------------------------------------
# round trip: IR-compiled closures are bitwise the originals and the reference
# ---------------------------------------------------------------------------

def roundtrip(tmp_path, ref, port, spec_kw, k=1):
    """The IR twin of ``port`` against ``port`` itself and against the
    reference's IR twin: every stored MV bitwise."""
    budget = sum(n.size for n in port.nodes) * 0.4
    irwl = mvir.to_workload(mvir.infer_schemas(mvir.lift_workload(port), device="cpu"), port)
    assert irwl.name == port.name + "_ir"
    rirwl = rir.to_workload(rir.infer_schemas(rir.lift_workload(ref)), ref)
    stores = {}
    for tag, w in (("orig", port), ("ir", irwl)):
        stores[tag] = pmv.DiskStore(tmp_path / tag, device="cpu")
        pmv.run_scenario(w, stores[tag], budget,
                         pmv.UpdateSpec(mode="incremental", **spec_kw), PCM,
                         n_compute_workers=k)
    pmv.verify_scenario_equivalence(port, stores["orig"], stores["ir"])
    ref_store = rmv.DiskStore(tmp_path / "ref_ir")
    rmv.run_scenario(rirwl, ref_store, budget,
                     rmv.UpdateSpec(mode="incremental", **spec_kw), RCM,
                     n_compute_workers=k)
    assert_same_store(ref_store, stores["ir"], [n.name for n in port.nodes])


@pytest.mark.parametrize("seed,kind,k", [
    (3, "insert", 1),
    (3, "mixed", 2),
    (7, "insert", 2),
    (7, "mixed", 1),
    (11, "delete", 1),
])
def test_ir_roundtrip_bitwise_scenario_matrix(tmp_path, seed, kind, k):
    ref, port = build(tmp_path, seed=seed)
    roundtrip(tmp_path, ref, port, SPEC_KW[kind], k=k)


def test_ir_roundtrip_bitwise_partitioned(tmp_path):
    ref, port = build(tmp_path, n_nodes=8, seed=2)
    ref, _ = r_partition_workload(ref, 4)
    port, _ = partition_workload(port, 4)
    roundtrip(tmp_path, ref, port, SPEC_KW["insert"], k=2)


def test_compile_node_matches_closure_on_one_table(tmp_path):
    """Compiled fn, the original closure and the reference's compiled fn give
    bitwise-identical tables on real input."""
    ref, wl = build(tmp_path, seed=4)
    ir = mvir.infer_schemas(mvir.lift_workload(wl), device="cpu")
    r_ir = rir.infer_schemas(rir.lift_workload(ref))
    store = pmv.DiskStore(tmp_path / "exec", device="cpu")
    pmv.Controller(wl, store, budget_bytes=0.0).run(serial_plan(wl.to_graph()))
    rstore = rmv.DiskStore(tmp_path / "exec_ref")
    rmv.Controller(ref, rstore, budget_bytes=0.0).run(r_serial_plan(ref.to_graph()))
    checked = 0
    for node, r_node, orig in zip(ir.nodes, r_ir.nodes, wl.nodes):
        if node.op == "SCAN" or not node.lifted or orig.fn is None:
            continue
        inputs = [store.read(wl.nodes[p].name) for p in node.parents]
        got = mvir.compile_node(node)(inputs)
        T.assert_tables_bitwise(got, orig.fn(inputs), node.name)
        r_inputs = [rstore.read(wl.nodes[p].name) for p in node.parents]
        RT.assert_tables_bitwise(rir.compile_node(r_node)(r_inputs),
                                 table_to_numpy(got), node.name)
        checked += 1
    assert checked > 0


def test_compile_node_drops_a_relift_claim_that_params_contradict():
    node = mvir.OpNode("f", "FILTER", (0,), params=(("col", "c0"), ("threshold", 9.0)))
    assert mvir._cells(mvir.compile_node(node, param_index=3))["i"] is None
    ok = dc.replace(node, params=(("col", "c0"), ("threshold", filter_threshold(3))))
    assert mvir._cells(mvir.compile_node(ok, param_index=3))["i"] == 3
    with pytest.raises(ValueError, match="delta_fn"):
        mvir.compile_node(mvir.OpNode("s", "SCAN", ()))
    with pytest.raises(ValueError, match="shape mismatch"):
        mvir.to_workload(mvir.ViewIR(()), pmv.generate_workload(n_nodes=3, seed=0))
