"""The port's planner against the JAX package's: the same graph must give
the same ``Plan`` — order, flags, score, peak and average memory, iteration
count — from ``solve``, ``serial_plan``, ``ma_dfs``, ``simplified_mkp`` and
``solve_hierarchical``, on the graph shapes ``tests/core`` uses: random
DAGs, the Fig. 7 instance, and generated §VI-H workloads."""
import dataclasses

import numpy as np
import pytest

import repro.core as rc
from repro.core.speedup import EFFECTIVE_NFS_COST_MODEL as RCM
from repro.mv import generate_workload as ref_generate
import repro_torch.core as pc
from repro_torch.convert import plan_from_reference
from repro_torch.core.speedup import EFFECTIVE_NFS_COST_MODEL as PCM
from repro_torch.mv import generate_workload as port_generate

PLAN_FIELDS = ("order", "flagged", "score", "peak_memory", "avg_memory",
               "iterations", "n_workers")


def assert_same_plan(ref, got, ctx=""):
    for f in PLAN_FIELDS:
        assert getattr(ref, f) == getattr(got, f), (ctx, f)


def as_port(g):
    return pc.MVGraph(g.n, g.edges, g.sizes, g.scores, g.names)


def random_dag(seed, max_n=12):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, max_n + 1))
    edges = tuple((i, j) for j in range(1, n) for i in range(j)
                  if rng.random() < 0.25)
    sizes = tuple(float(x) for x in rng.integers(1, 31, n))
    scores = tuple(float(x) for x in rng.integers(0, 31, n))
    return rc.MVGraph(n, edges, sizes, scores)


def fig7():
    sizes = (100.0, 100.0, 5.0, 5.0, 10.0)
    return rc.MVGraph(5, ((0, 2), (1, 3)), sizes, sizes)


def workload_graph(seed):
    return ref_generate(16, hw_ratio=1.6, max_outdegree=3, seed=seed).to_graph(RCM)


GRAPHS = {f"dag{s}": (lambda s=s: random_dag(s)) for s in range(6)}
GRAPHS["fig7"] = fig7
GRAPHS.update({f"wl{s}": (lambda s=s: workload_graph(s)) for s in (4, 1000)})


@pytest.mark.parametrize("seed", [0, 4, 1000, 1003])
def test_generated_workload_graphs_identical(seed):
    ref = ref_generate(12, seed=seed).to_graph(RCM)
    got = port_generate(12, seed=seed).to_graph(PCM)
    assert dataclasses.astuple(ref) == dataclasses.astuple(got)


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("frac", [0.2, 0.5])
@pytest.mark.parametrize("k", [1, 3])
def test_solve_same_plan(name, frac, k):
    g = GRAPHS[name]()
    budget = sum(g.sizes) * frac
    ref = rc.solve(g, budget, n_workers=k)
    got = pc.solve(as_port(g), budget, n_workers=k)
    assert_same_plan(ref, got, name)
    assert_same_plan(ref, plan_from_reference(ref), "convert")


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_serial_madfs_mkp_same(name):
    g = GRAPHS[name]()
    pg = as_port(g)
    assert_same_plan(rc.serial_plan(g), pc.serial_plan(pg), "serial")
    budget = sum(g.sizes) * 0.4
    order = g.topological_order()
    flagged = rc.simplified_mkp(g, budget, order)
    assert flagged == pc.simplified_mkp(pg, budget, order)
    assert rc.ma_dfs(g, flagged, budget) == pc.ma_dfs(pg, flagged, budget)
    assert rc.simplified_mkp(g, budget, order, n_workers=2) == \
        pc.simplified_mkp(pg, budget, order, n_workers=2)


@pytest.mark.parametrize("P", [1, 4])
@pytest.mark.parametrize("flat_threshold", [0, 10_000])
def test_solve_hierarchical_same_plan(P, flat_threshold):
    g = workload_graph(1001)
    budget = sum(g.sizes) * 0.1
    shares = rc.partition_shares(P, skew=1.1, seed=7)
    assert shares == pc.partition_shares(P, skew=1.1, seed=7)
    ref = rc.solve_hierarchical(g, budget, P, cost_model=RCM, shares=shares,
                                flat_threshold=flat_threshold)
    got = pc.solve_hierarchical(as_port(g), budget, P, cost_model=PCM,
                                shares=shares, flat_threshold=flat_threshold)
    assert (ref.n_partitions, ref.index) == (got.n_partitions, got.index)
    assert_same_plan(ref.plan, got.plan, f"P={P}")
