"""The port's MQO shared-subexpression merge (``repro_torch.mv.mqo``)
against the JAX package's.

The same seeded shared-prefix workload is realized in both packages (the
port's on the CPU). Fingerprints must be equal string for string, the merge's
``rep_of``, ``keep``, ``shared``, ``classes`` and ``name_map`` equal, and the
merged scenario's stores bitwise the unshared run's and the reference's
merged run's, across the reference tests' seed x update-kind x worker
matrix, each shared class executing once per round. Tolerance 0.
"""
from __future__ import annotations

import dataclasses as dc
from collections import Counter

import pytest

import repro.core as rc
import repro.mv as rmv
from repro.mv import ir as rir
from repro.mv import mqo as rmqo
from repro.mv import tableops as RT
from repro.mv.partition import partition_workload as r_partition_workload
import repro_torch.core as pc
import repro_torch.mv as pmv
from repro_torch.convert import table_to_numpy
from repro_torch.mv import ir as mvir
from repro_torch.mv.mqo import (
    merge_workload,
    node_fingerprints,
    shared_prefix_workload,
    verify_merged_equivalence,
)
from repro_torch.mv.partition import partition_workload

CM_KW = dict(disk_read_bw=50e6, disk_write_bw=50e6, mem_read_bw=1e12,
             mem_write_bw=1e12, disk_latency=0.0)
RCM, PCM = rc.CostModel(**CM_KW), pc.CostModel(**CM_KW)
SPEC_KW = {
    "insert": dict(ingest_frac=0.25, n_rounds=2),
    "mixed": dict(ingest_frac=0.2, update_frac=0.15, delete_frac=0.1, n_rounds=2),
}
MERGE_FIELDS = ("fingerprints", "rep_of", "keep", "name_map", "shared", "classes")


def build(tmp_path, n_views=3, seed=3, bytes_per_root=1 << 13):
    """The same calibrated shared-prefix workload in both packages."""
    ref = rmv.calibrate_sizes(
        rmv.realize_workload(rmqo.shared_prefix_workload(n_views=n_views),
                             bytes_per_root=bytes_per_root, seed=seed),
        rmv.DiskStore(tmp_path / "calib_ref"))
    port = pmv.calibrate_sizes(
        pmv.realize_workload(shared_prefix_workload(n_views=n_views),
                             bytes_per_root=bytes_per_root, seed=seed, device="cpu"),
        pmv.DiskStore(tmp_path / "calib_port", device="cpu"))
    return ref, port


def assert_same_merge(ref_m, port_m):
    for field in MERGE_FIELDS:
        assert getattr(ref_m, field) == getattr(port_m, field), field
    assert ref_m.workload.name == port_m.workload.name
    assert [(n.name, n.parents, n.op, n.size) for n in ref_m.workload.nodes] == \
        [(n.name, n.parents, n.op, n.size) for n in port_m.workload.nodes]
    for a, b in zip(ref_m.ir.nodes, port_m.ir.nodes):
        assert dc.asdict(a) == dc.asdict(b), a.name
    assert ref_m.workload.meta["mqo"] == port_m.workload.meta["mqo"]


# ---------------------------------------------------------------------------
# the workload and the merge: what must and must not merge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_views", [2, 3, 4])
def test_shared_prefix_workload_matches_reference(n_views):
    ref = rmqo.shared_prefix_workload(n_views=n_views)
    port = shared_prefix_workload(n_views=n_views)
    assert (ref.name, ref.meta) == (port.name, port.meta)
    assert [dc.astuple(n) for n in ref.nodes] == [dc.astuple(n) for n in port.nodes]


@pytest.mark.parametrize("n_views", [1, 5])
def test_shared_prefix_workload_refuses_other_view_counts(n_views):
    with pytest.raises(ValueError, match="n_views"):
        shared_prefix_workload(n_views=n_views)


@pytest.mark.parametrize("n_views", [2, 3, 4])
def test_merge_matches_reference(tmp_path, n_views):
    ref, port = build(tmp_path, n_views=n_views)
    assert_same_merge(rmqo.merge_workload(ref), merge_workload(port, device="cpu"))


def test_shared_prefix_merges_expected_classes(tmp_path):
    _, wl = build(tmp_path)
    merged = merge_workload(wl, device="cpu")
    assert wl.n == 23 and merged.workload.n == 19
    assert merged.n_merged_away == 4
    assert merged.shared == ("v0_filter", "v0_join")
    assert merged.classes["v0_filter"] == (2, 9, 16)
    assert merged.classes["v0_join"] == (3, 10, 17)
    assert merged.name_map["v2_filter"] == "v0_filter"
    assert merged.name_map["v1_join"] == "v0_join"
    for i, n in enumerate(merged.workload.nodes):
        assert all(p < i for p in n.parents)


def test_opaque_closures_never_merge(tmp_path):
    """A hand-written closure the lifter cannot classify fingerprints
    opaque-unique, in both packages alike."""
    ref, wl = build(tmp_path)

    def opaque(inputs):
        return inputs[0]

    def with_opaque(w):
        return dc.replace(w, nodes=[
            dc.replace(n, fn=opaque) if n.name in ("v0_filter", "v1_filter") else n
            for n in w.nodes])

    wl2, ref2 = with_opaque(wl), with_opaque(ref)
    ir = mvir.infer_schemas(mvir.lift_workload(wl2), device="cpu")
    assert not ir.nodes[2].lifted and not ir.nodes[9].lifted
    fps = node_fingerprints(ir)
    assert fps[2] != fps[9]
    assert fps == rmqo.node_fingerprints(rir.infer_schemas(rir.lift_workload(ref2)))
    merged = merge_workload(wl2, ir, device="cpu")
    assert merged.n_merged_away == 0 and not merged.shared
    assert_same_merge(rmqo.merge_workload(ref2), merged)


def test_param_differing_filters_never_merge():
    nodes = [("scan", (), "SCAN", 1e6, 0.0, 1e6), ("f1", (0,), "FILTER", 7e5, 1e-4, 0.0),
             ("f2", (0,), "FILTER", 7e5, 1e-4, 0.0)]

    def workload(mv):
        return mv.Workload(name="param_diff", nodes=[
            mv.MVNode(n, p, op, size, comp, base_read=br)
            for n, p, op, size, comp, br in nodes])

    ir = mvir.infer_schemas(mvir.lift_workload(workload(pmv)), device="cpu")
    assert ir.nodes[1].param("threshold") != ir.nodes[2].param("threshold")
    fps = node_fingerprints(ir)
    assert fps[1] != fps[2]
    assert fps == rmqo.node_fingerprints(
        rir.infer_schemas(rir.lift_workload(workload(rmv))))
    assert merge_workload(workload(pmv), ir, device="cpu").n_merged_away == 0


def test_fingerprints_stable_and_partition_aware(tmp_path):
    """Deterministic across lifts; a P=4 expansion merges only within a
    partition; equal to the reference's string for string."""
    ref, wl = build(tmp_path)
    fp1 = node_fingerprints(mvir.infer_schemas(mvir.lift_workload(wl), device="cpu"))
    fp2 = node_fingerprints(mvir.infer_schemas(mvir.lift_workload(wl), device="cpu"))
    assert fp1 == fp2
    pwl, _ = partition_workload(wl, 4)
    rpwl, _ = r_partition_workload(ref, 4)
    pir = mvir.infer_schemas(mvir.lift_workload(pwl), device="cpu")
    fps = node_fingerprints(pir)
    assert fps == rmqo.node_fingerprints(rir.infer_schemas(rir.lift_workload(rpwl)))
    names = [n.name for n in pwl.nodes]
    v0f = [i for i, n in enumerate(names) if n.startswith("v0_filter")]
    assert len(v0f) == 4 and len({fps[i] for i in v0f}) == 4
    pm = merge_workload(pwl, pir, device="cpu")
    for rep, members in pm.classes.items():
        if len(members) >= 2:
            assert len({names[m].rsplit("@", 1)[-1] for m in members}) == 1, rep
    assert sum(len(v) > 1 for v in pm.classes.values()) == 8
    assert_same_merge(rmqo.merge_workload(rpwl), pm)


def test_merged_workload_relifts_fully(tmp_path):
    ref, wl = build(tmp_path)
    merged = merge_workload(wl, device="cpu")
    re_ir = mvir.lift_workload(merged.workload)
    assert all(n.lifted for n in re_ir.nodes)
    want = rir.lift_workload(rmqo.merge_workload(ref).workload)
    for a, b in zip(want.nodes, re_ir.nodes):
        assert dc.asdict(a) == dc.asdict(b), a.name


def test_merge_refuses_a_mismatched_ir(tmp_path):
    _, wl = build(tmp_path)
    ir = mvir.infer_schemas(mvir.lift_workload(wl), device="cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        merge_workload(wl, dc.replace(ir, nodes=ir.nodes[:-1]), device="cpu")


# ---------------------------------------------------------------------------
# bitwise parity + once-per-round execution
# ---------------------------------------------------------------------------

def run_pair(tmp_path, wl, merged, spec_kw, k=1, budget_frac=0.5):
    budget = sum(n.size for n in merged.workload.nodes) * budget_frac
    spec = pmv.UpdateSpec(mode="incremental", **spec_kw)
    store_u = pmv.DiskStore(tmp_path / "unshared", device="cpu")
    store_m = pmv.DiskStore(tmp_path / "merged", device="cpu")
    rep_u = pmv.run_scenario(wl, store_u, budget, spec, PCM, n_compute_workers=k)
    rep_m = pmv.run_scenario(merged.workload, store_m, budget, spec, PCM,
                             n_compute_workers=k)
    return rep_u, rep_m, store_u, store_m, budget


@pytest.mark.parametrize("seed,kind,k", [
    (3, "insert", 1),
    (3, "mixed", 2),
    (5, "insert", 2),
    (5, "mixed", 1),
    (7, "mixed", 1),
])
def test_merged_bitwise_parity_matrix(tmp_path, seed, kind, k):
    """Every original view's stored bytes under the shared DAG equal the
    unshared run's, and the merged store equals the reference's merged
    store entry for entry."""
    ref, wl = build(tmp_path, seed=seed)
    merged = merge_workload(wl, device="cpu")
    _, rep_m, store_u, store_m, budget = run_pair(tmp_path, wl, merged, SPEC_KW[kind], k=k)
    verify_merged_equivalence(merged, store_m, store_u)
    r_merged = rmqo.merge_workload(ref)
    r_store = rmv.DiskStore(tmp_path / "ref_merged")
    r_rep = rmv.run_scenario(r_merged.workload, r_store, budget,
                             rmv.UpdateSpec(mode="incremental", **SPEC_KW[kind]), RCM,
                             n_compute_workers=k)
    assert r_store.manifest() == store_m.manifest()
    for node in merged.workload.nodes:
        RT.assert_tables_bitwise(r_store.read(node.name),
                                 table_to_numpy(store_m.read(node.name)), node.name)
    for a, b in zip(r_rep.rounds, rep_m.rounds):
        assert (a.statuses, a.plan.order, a.plan.flagged, a.scores) == \
            (b.statuses, b.plan.order, b.plan.flagged, b.scores)


def test_shared_subtree_executes_once_per_round(tmp_path):
    _, wl = build(tmp_path)
    merged = merge_workload(wl, device="cpu")
    rep_u, rep_m, _, _, budget = run_pair(tmp_path, wl, merged, SPEC_KW["mixed"])
    for r in rep_m.rounds:
        counts = Counter(r.run.executed)
        assert max(counts.values()) == 1
        for rep in merged.shared:
            assert counts[rep] == 1, (r.round_idx, rep)
        assert r.run.peak_catalog_bytes <= budget
    for r in rep_u.rounds:
        counts = Counter(r.run.executed)
        for rep, members in merged.classes.items():
            if len(members) >= 2:
                names = [wl.nodes[m].name for m in members]
                assert sum(counts[n] for n in names) == len(members)


def test_verify_merged_equivalence_names_a_divergent_view(tmp_path):
    _, wl = build(tmp_path)
    merged = merge_workload(wl, device="cpu")
    _, _, store_u, store_m, _ = run_pair(tmp_path, wl, merged, SPEC_KW["insert"])
    table = store_u.read("v2_join")
    table["c0"] = table["c0"].clone()
    table["c0"][0] += 1.0
    store_u.write("v2_join", table)
    with pytest.raises(AssertionError, match="v2_join->v0_join"):
        verify_merged_equivalence(merged, store_m, store_u)
