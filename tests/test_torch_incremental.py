"""Incremental (multi-round, full-vs-incremental) refresh in the port against
the JAX package, bitwise.

Both packages realize the same workload from the same seed — the port on
CPU tensors, which take the plain versions of its CUDA kernels — and run the
same scenario: every ``RoundReport`` field that does not depend on wall
time must agree, and every stored MV must be bitwise equal (tolerance 0).
The simulator's scenarios run on both packages' cost models and must give
the same plans and the same simulated seconds.
"""
import numpy as np
import pytest

import repro.core as rc
import repro.mv as rmv
from repro.mv import tableops as RT
import repro_torch.core as pc
import repro_torch.mv as pmv
from repro_torch.convert import table_to_numpy
from repro_torch.mv import incremental as PI

CM_KW = dict(disk_read_bw=50e6, disk_write_bw=50e6, mem_read_bw=1e12,
             mem_write_bw=1e12, disk_latency=0.0)
RCM, PCM = rc.CostModel(**CM_KW), pc.CostModel(**CM_KW)
KINDS = {
    "insert": dict(ingest_frac=0.25, n_rounds=2),
    "mixed": dict(ingest_frac=0.15, update_frac=0.15, delete_frac=0.1,
                  n_rounds=3),
    "churn": dict(ingest_frac=0.05, update_frac=0.3, delete_frac=0.2,
                  n_rounds=2),
}


def realize(mv, seed, **kw):
    return mv.realize_workload(mv.generate_workload(10, seed=seed),
                               bytes_per_root=1 << 13, **kw)


def run_both(tmp_path, seed, spec_kw, k=1, consolidate_ratio=None,
             via_controller=False):
    out = {}
    for pkg, mv, cm, dk in (("ref", rmv, RCM, {}),
                            ("port", pmv, PCM, {"device": "cpu"})):
        wl = realize(mv, seed, **dk)
        budget = sum(n.size for n in wl.nodes) * 0.4
        store = mv.DiskStore(tmp_path / pkg, **dk)
        spec = mv.UpdateSpec(**spec_kw)
        if via_controller:
            rep = mv.Controller(wl, store, budget, n_compute_workers=k) \
                .run_scenario(spec, cm)
        else:
            rep = mv.run_scenario(wl, store, budget, spec, cm,
                                  n_compute_workers=k,
                                  consolidate_ratio=consolidate_ratio)
        out[pkg] = dict(wl=wl, store=store, rep=rep, budget=budget)
    return out


def assert_same_rounds(out):
    ref, port = out["ref"]["rep"], out["port"]["rep"]
    assert ref.workload == port.workload
    assert len(ref.rounds) == len(port.rounds) == ref.spec.n_rounds + 1
    for a, b in zip(ref.rounds, port.rounds):
        ctx = f"round {a.round_idx}"
        for field in ("round_idx", "mode", "statuses", "join_fallbacks", "sizes",
                      "fallback_stats", "forced_full", "scores",
                      "consolidations"):
            assert getattr(a, field) == getattr(b, field), (ctx, field)
        for field in ("order", "flagged", "score", "n_workers"):
            assert getattr(a.plan, field) == getattr(b.plan, field), (ctx, field)
        for field in ("skipped", "catalog_hits", "disk_reads",
                      "overflow_fallbacks", "n_workers"):
            assert getattr(a.run, field) == getattr(b.run, field), (ctx, field)
        if a.run.n_workers == 1:
            assert a.run.peak_catalog_bytes == b.run.peak_catalog_bytes, ctx
            assert a.entry_stats == b.entry_stats, ctx
        assert b.run.peak_catalog_bytes <= out["port"]["budget"], ctx
    rs, ps = out["ref"]["store"], out["port"]["store"]
    assert rs.manifest() == ps.manifest()
    for node in out["port"]["wl"].nodes:
        assert rs.parts(node.name) == ps.parts(node.name), node.name
        RT.assert_tables_bitwise(rs.read(node.name),
                                 table_to_numpy(ps.read(node.name)), node.name)


@pytest.mark.parametrize("seed", [5, 2026])
@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("mode", ["full", "incremental", "adaptive"])
def test_scenario_rounds_and_stores_bitwise_vs_reference(tmp_path, seed, kind,
                                                         mode):
    out = run_both(tmp_path, seed, dict(mode=mode, **KINDS[kind]))
    assert_same_rounds(out)


@pytest.mark.parametrize("mode", ["incremental", "adaptive"])
@pytest.mark.parametrize("ratio", [0.05, 0.5])
def test_consolidation_policy_bitwise_vs_reference(tmp_path, mode, ratio):
    out = run_both(tmp_path, 9, dict(mode=mode, **KINDS["churn"]),
                   consolidate_ratio=ratio)
    assert_same_rounds(out)
    assert sum(r.consolidations for r in out["port"]["rep"].rounds) > 0 or \
        ratio == 0.5


def test_two_workers_bitwise_vs_reference(tmp_path):
    out = run_both(tmp_path, 11, dict(mode="incremental", **KINDS["mixed"]), k=2)
    assert_same_rounds(out)


def test_controller_run_scenario_bitwise_vs_reference(tmp_path):
    out = run_both(tmp_path, 5, dict(mode="incremental", **KINDS["mixed"]),
                   via_controller=True)
    assert_same_rounds(out)
    assert any(r.join_fallbacks for r in out["port"]["rep"].rounds)


def test_incremental_equals_full_recompute_in_the_port(tmp_path):
    wl = realize(pmv, 2026, device="cpu")
    budget = sum(n.size for n in wl.nodes) * 0.4
    stores = {}
    for mode in ("full", "incremental", "adaptive"):
        stores[mode] = pmv.DiskStore(tmp_path / mode, device="cpu")
        rep = pmv.run_scenario(wl, stores[mode], budget,
                               pmv.UpdateSpec(mode=mode, **KINDS["mixed"]), PCM)
        assert rep.build_seconds > 0 and rep.refresh_seconds > 0
    pmv.verify_scenario_equivalence(wl, stores["incremental"], stores["full"])
    pmv.verify_scenario_equivalence(wl, stores["adaptive"], stores["full"])


def differing_columns(wl, store_a, store_b):
    """``{(mv, column)}`` where two stores' tables differ bitwise (numpy
    tables: the port's converted)."""
    out = set()
    for node in wl.nodes:
        a, b = (t if isinstance(next(iter(t.values())), np.ndarray) else table_to_numpy(t)
                for t in (s.read(node.name) for s in (store_a, store_b)))
        for col in sorted(set(a) | set(b)):
            if col not in a or col not in b or a[col].dtype != b[col].dtype or \
                    a[col].tobytes() != b[col].tobytes():
                out.add((node.name, col))
    return out


def test_seed_9292_incremental_store_bitwise_vs_reference(tmp_path):
    """The workload of the reference's ``test_incremental_bitwise_property``
    at the draw where its incremental and full-recompute stores differ
    (``seed=9292``: 10 MVs, 8 KiB per root, calibrated, 25% ingest, two
    rounds). The port's incremental store is bitwise the reference's, its
    full-recompute store too, and the two packages' incremental stores
    differ from their full recomputes in the same columns."""
    spec_kw = dict(ingest_frac=0.25, n_rounds=2)
    diffs = {}
    for pkg, mv, cm, dk in (("ref", rmv, RCM, {}), ("port", pmv, PCM, {"device": "cpu"})):
        wl = mv.realize_workload(mv.generate_workload(n_nodes=10, seed=9292),
                                 bytes_per_root=1 << 13, **dk)
        wl = mv.calibrate_sizes(wl, mv.DiskStore(tmp_path / pkg / "calib", **dk))
        budget = sum(n.size for n in wl.nodes) * 0.4
        stores = {}
        for mode in ("incremental", "full"):
            stores[mode] = mv.DiskStore(tmp_path / pkg / mode, **dk)
            mv.run_scenario(wl, stores[mode], budget, mv.UpdateSpec(mode=mode, **spec_kw), cm)
        diffs[pkg] = (wl, stores, differing_columns(wl, stores["incremental"], stores["full"]))
    wl, ref_stores, ref_diff = diffs["ref"]
    _, port_stores, port_diff = diffs["port"]
    for mode in ("incremental", "full"):
        assert differing_columns(wl, ref_stores[mode], port_stores[mode]) == set(), mode
    assert port_diff == ref_diff


def test_stale_store_is_refused(tmp_path):
    wl = realize(pmv, 5, device="cpu")
    store = pmv.DiskStore(tmp_path / "s", device="cpu")
    spec = pmv.UpdateSpec(mode="incremental", ingest_frac=0.1, n_rounds=1)
    pmv.run_scenario(wl, store, 1e9, spec, PCM)
    with pytest.raises(ValueError, match="store already holds"):
        pmv.run_scenario(wl, store, 1e9, spec, PCM)


def test_reference_reads_the_ports_multipart_store(tmp_path):
    """Parts with tombstones written by the port consolidate to the same
    live content when the reference reads them, and the other way round."""
    out = run_both(tmp_path, 5, dict(mode="incremental", **KINDS["churn"]))
    ref_reads_port = rmv.DiskStore(out["port"]["store"].root)
    port_reads_ref = pmv.DiskStore(out["ref"]["store"].root, device="cpu")
    for node in out["port"]["wl"].nodes:
        want = out["ref"]["store"].read(node.name)
        RT.assert_tables_bitwise(want, ref_reads_port.read(node.name), node.name)
        RT.assert_tables_bitwise(
            want, table_to_numpy(port_reads_ref.read(node.name)), node.name)


@pytest.mark.parametrize("observations", [
    [(10, 10), (10, 0), (0, 0), (4, 1)],
    [(0, 0), (3, 3), (100, 1), (100, 1), (100, 1), (7, 2)],
    [],
])
@pytest.mark.parametrize("alpha", [0.5, 0.2])
def test_fallback_rate_ewma_matches_reference(observations, alpha):
    from repro.mv.incremental import FallbackRateEwma as RefEwma

    ref, port = RefEwma(alpha), PI.FallbackRateEwma(alpha)
    assert ref.rate == port.rate == 1.0
    for affected, matched in observations:
        ref.observe(affected, matched)
        port.observe(affected, matched)
        assert ref.rate == port.rate


def test_round_view_matches_reference(tmp_path):
    out = run_both(tmp_path, 5, dict(mode="adaptive", **KINDS["mixed"]))
    from repro.mv.incremental import round_view as ref_round_view

    spec_kw = dict(mode="adaptive", **KINDS["mixed"])
    for r in range(3):
        rv, rs, rf = ref_round_view(out["ref"]["wl"], rmv.UpdateSpec(**spec_kw),
                                    RCM, r, store=out["ref"]["store"],
                                    fallback_rate=0.25)
        pv, ps, pf = PI.round_view(out["port"]["wl"], pmv.UpdateSpec(**spec_kw),
                                   PCM, r, store=out["port"]["store"],
                                   fallback_rate=0.25)
        assert (rs, rf) == (ps, pf)
        assert rv.to_graph(RCM).scores == pv.to_graph(PCM).scores


@pytest.mark.parametrize("method", ["sc", "serial"])
@pytest.mark.parametrize("mode", ["full", "incremental"])
@pytest.mark.parametrize("k", [1, 3])
def test_simulate_scenario_totals_match_reference(method, mode, k):
    spec_kw = dict(mode=mode, **KINDS["mixed"])
    rwl = rmv.generate_workload(14, seed=8)
    pwl = pmv.generate_workload(14, seed=8)
    budget = sum(n.size for n in rwl.nodes) * 0.2
    ref = rmv.simulate_scenario(rwl, rmv.UpdateSpec(**spec_kw), rc.PAPER_COST_MODEL,
                                budget, method=method, n_workers=k)
    got = pmv.simulate_scenario(pwl, pmv.UpdateSpec(**spec_kw), pc.PAPER_COST_MODEL,
                                budget, method=method, n_workers=k)
    assert (ref.build_seconds, ref.refresh_seconds, ref.total_seconds) == \
        (got.build_seconds, got.refresh_seconds, got.total_seconds)
    for a, b in zip(ref.rounds, got.rounds, strict=True):
        assert (a.round_idx, a.mode, a.sizes, a.end_to_end) == \
            (b.round_idx, b.mode, b.sizes, b.end_to_end)
        assert (a.plan.order, a.plan.flagged) == (b.plan.order, b.plan.flagged)
        assert a.sim.peak_catalog_bytes == b.sim.peak_catalog_bytes
    assert np.isfinite(got.total_seconds) and got.total_seconds > 0


def test_simulate_scenario_with_partitioned_solver_matches_reference():
    P = 4
    spec_kw = dict(mode="incremental", ingest_frac=0.1, n_rounds=2)
    rwl, _ = rmv.partition_workload(rmv.generate_workload(10, seed=3), P)
    pwl, _ = pmv.partition_workload(pmv.generate_workload(10, seed=3), P)
    budget = sum(n.size for n in rwl.nodes) * 0.2
    ref = rmv.simulate_scenario(
        rwl, rmv.UpdateSpec(**spec_kw), rc.PAPER_COST_MODEL, budget,
        solve_fn=rmv.hierarchical_round_solver(P, flat_threshold=0))
    got = pmv.simulate_scenario(
        pwl, pmv.UpdateSpec(**spec_kw), pc.PAPER_COST_MODEL, budget,
        solve_fn=pmv.hierarchical_round_solver(P, flat_threshold=0))
    assert ref.total_seconds == got.total_seconds
    for a, b in zip(ref.rounds, got.rounds, strict=True):
        assert (a.plan.order, a.plan.flagged) == (b.plan.order, b.plan.flagged)


def test_simulator_module_matches_reference():
    from repro.mv import simulator as RS
    from repro_torch.mv import simulator as PS

    rwl, pwl = rmv.generate_workload(12, seed=4), pmv.generate_workload(12, seed=4)
    budget = sum(n.size for n in rwl.nodes) * 0.3
    rplan = rc.solve(rwl.to_graph(), budget=budget)
    pplan = pc.solve(pwl.to_graph(), budget=budget)
    assert (rplan.order, rplan.flagged) == (pplan.order, pplan.flagged)
    for mode in ("sc", "serial", "lru"):
        a = RS.simulate(rwl, rplan, mode=mode, lru_budget=budget)
        b = PS.simulate(pwl, pplan, mode=mode, lru_budget=budget)
        assert (a.end_to_end, a.catalog_hits, a.peak_catalog_bytes) == \
            (b.end_to_end, b.catalog_hits, b.peak_catalog_bytes)
    assert RS.speedup(rwl, rplan) == PS.speedup(pwl, pplan)
