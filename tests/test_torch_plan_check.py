"""The plan-feasibility analyzer in the port (``analysis.plan_check``)
against the JAX package's, on the same graphs: the counterexample, its
witness and its message, the repair and its trail, the findings, and the
feasibility of the solvers' own plans (flat, hierarchical, and each host's
plan of a multi-host solve under that host's own budget). Mirrors
``tests/analysis/test_plan_check.py``; every result is compared exactly."""
import dataclasses

import pytest

import repro.analysis.plan_check as RPC
import repro.core.altopt as RA
from repro.mv import generate_workload as ref_generate_workload
from repro.mv import partition_workload as ref_partition_workload
from repro_torch.analysis.plan_check import (
    Counterexample,
    check_plan,
    find_counterexample,
    repair,
)
from repro_torch.core.altopt import (
    serial_plan,
    solve,
    solve_hierarchical,
    solve_multihost,
)
from repro_torch.mv import generate_workload, partition_workload


@pytest.fixture(scope="module")
def graphs():
    """The port's graph and the reference's, of the same workload."""
    return (generate_workload(n_nodes=24, seed=0).to_graph(),
            ref_generate_workload(n_nodes=24, seed=0).to_graph())


def same_cex(got, want):
    assert (got is None) == (want is None)
    if got is not None:
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_feasible_plans_have_no_counterexample(graphs):
    graph, ref = graphs
    plan = serial_plan(graph)
    assert plan.order == RA.serial_plan(ref).order
    assert find_counterexample(graph, plan.flagged, plan.order, budget=1.0) is None
    huge = sum(graph.sizes) * 10
    assert find_counterexample(graph, range(graph.n), plan.order, huge,
                               n_workers=4) is None
    assert RPC.find_counterexample(ref, range(ref.n), plan.order, huge,
                                   n_workers=4) is None


@pytest.mark.parametrize("k", [1, 2, 4])
def test_counterexample_witness_properties(graphs, k):
    graph, ref = graphs
    order = graph.topological_order()
    assert order == ref.topological_order()
    budget = max(graph.sizes) * 0.5
    flagged = set(range(graph.n))
    cex = find_counterexample(graph, flagged, order, budget, n_workers=k)
    assert isinstance(cex, Counterexample)
    same_cex(cex, RPC.find_counterexample(ref, flagged, order, budget, n_workers=k))
    assert cex.resident_bytes > budget
    wbytes = sum(graph.sizes[i] for i in cex.witness)
    assert wbytes > budget
    assert wbytes - min(graph.sizes[i] for i in cex.witness) <= budget + 1e-9
    assert set(cex.in_flight) <= set(cex.witness)
    assert cex.executing == order[cex.step]
    msg = cex.describe(graph)
    assert msg == RPC.find_counterexample(
        ref, flagged, order, budget, n_workers=k).describe(ref)
    assert "budget" in msg and str(cex.n_workers) in msg


def test_repair_restores_feasibility_with_trail(graphs):
    graph, ref = graphs
    order = graph.topological_order()
    budget = max(graph.sizes) * 0.5
    flagged = frozenset(range(graph.n))
    repaired, trail = repair(graph, flagged, order, budget, n_workers=2)
    want, want_trail = RPC.repair(ref, flagged, order, budget, n_workers=2)
    assert repaired == want
    assert [dataclasses.asdict(c) for c in trail] == [
        dataclasses.asdict(c) for c in want_trail]
    assert repaired < flagged
    assert trail and len(trail) == len(flagged) - len(repaired)
    assert find_counterexample(graph, repaired, order, budget, 2) is None


def test_repair_matches_legacy_shed_order(graphs):
    """Victim selection is the loop hierarchical_plan always ran: discard
    min score-density until feasible."""
    graph, _ = graphs
    order = graph.topological_order()
    budget = max(graph.sizes) * 0.5
    k = 2
    legacy = set(range(graph.n))
    while legacy and not graph.is_feasible(legacy, order, budget, k):
        legacy.discard(min(
            legacy,
            key=lambda i: graph.scores[i] / max(graph.sizes[i], 1e-12),
        ))
    repaired, _ = repair(graph, range(graph.n), order, budget, k)
    assert repaired == frozenset(legacy)


def test_check_plan_finding_shape(graphs):
    graph, ref = graphs
    order = graph.topological_order()
    budget = max(graph.sizes) * 0.5
    got = check_plan(graph, range(graph.n), order, budget,
                     path="plan:test", symbol="k1")
    want = RPC.check_plan(ref, range(ref.n), order, budget,
                          path="plan:test", symbol="k1")
    assert len(got) == 1 == len(want)
    f = got[0]
    assert (f.rule, f.level, f.path, f.symbol) == (
        "plan-infeasible", "error", "plan:test", "k1")
    assert (f.rule, f.level, f.path, f.symbol, f.message) == (
        want[0].rule, want[0].level, want[0].path, want[0].symbol,
        want[0].message)
    assert check_plan(graph, (), order, budget) == []


@pytest.mark.parametrize("k", [1, 4])
def test_flat_solver_output_is_feasible(graphs, k):
    graph, ref = graphs
    budget = 0.3 * sum(graph.sizes)
    plan = solve(graph, budget, n_workers=k)
    want = RA.solve(ref, budget, n_workers=k)
    assert (plan.order, plan.flagged) == (want.order, want.flagged)
    assert check_plan(graph, plan.flagged, plan.order, budget, k) == []


def test_hierarchical_solver_output_is_feasible(graphs):
    graph, ref = graphs
    P = 16
    budget = 0.3 * sum(graph.sizes)
    pplan = solve_hierarchical(graph, budget, P, n_workers=2)
    want = RA.solve_hierarchical(ref, budget, P, n_workers=2)
    assert (pplan.plan.order, pplan.plan.flagged) == (want.plan.order,
                                                      want.plan.flagged)
    expanded, _ = graph.expand_partitions(P, None)
    assert check_plan(expanded, pplan.plan.flagged, pplan.plan.order, budget,
                      pplan.plan.n_workers) == []


@pytest.mark.parametrize("n_hosts", [1, 2, 4])
def test_multihost_host_plans_feasible_under_own_budget(n_hosts):
    """Each host's plan of ``solve_multihost`` holds under that host's own
    budget: no interleaving of its k workers has a counterexample, and the
    plans equal the reference's."""
    P, k = 8, 2
    wl = generate_workload(n_nodes=12, seed=4)
    pwl, _ = partition_workload(wl, P)
    expanded = pwl.to_graph()
    rwl, _ = ref_partition_workload(ref_generate_workload(n_nodes=12, seed=4), P)
    total = sum(expanded.sizes)
    budgets = [0.25 * total / n_hosts * (1 + h) / n_hosts
               for h in range(n_hosts)]
    plan = solve_multihost(expanded, budgets, P, n_workers=k)
    want = RA.solve_multihost(rwl.to_graph(), budgets, P, n_workers=k)
    assert plan.placement == want.placement
    assert plan.host_nodes == want.host_nodes
    slices = list(expanded.host_slices(P, plan.placement))
    flagged_any = False
    for h, (_, keep) in enumerate(slices):
        sub = expanded.subgraph(keep)
        hp = plan.host_plans[h]
        assert (hp.order, hp.flagged) == (want.host_plans[h].order,
                                          want.host_plans[h].flagged)
        assert tuple(keep) == plan.host_nodes[h]
        assert find_counterexample(sub, hp.flagged, hp.order, budgets[h],
                                   n_workers=k) is None
        flagged_any |= bool(hp.flagged)
    assert flagged_any
