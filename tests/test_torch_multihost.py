"""Multi-host partitioned refresh in the port against the JAX package,
bitwise.

The same workload, realized from a seed, runs through the JAX package's
single-host ``run_partitioned_scenario`` (the oracle) and through the
port's ``run_multihost_scenario`` on CPU tensors (the plain versions of the
data-plane kernels). Every stored entry of the port's multi-host store must
equal the oracle's file for file (tolerance 0): the oracle store is read
through the port's ``DiskStore``, the two packages sharing one ``.npz``
format. Mirrors ``tests/mv/test_multihost.py``: the fault-free runs, the
placements and the acceptance matrix here; the fault schedules in
``test_torch_multihost_faults.py``.
"""
import tempfile

import pytest
import torch

import repro.core as rc
import repro.mv as rmv
import repro_torch.core as pc
import repro_torch.mv as pmv
from repro_torch.mv import multihost as mh

CM_KW = dict(disk_read_bw=50e6, disk_write_bw=50e6, mem_read_bw=1e12,
             mem_write_bw=1e12, disk_latency=0.0)
RCM, PCM = rc.CostModel(**CM_KW), pc.CostModel(**CM_KW)

P = 4
BUDGET = 1 << 22

SPECS = {
    "insert": dict(mode="incremental", n_rounds=2, ingest_frac=0.3),
    "update": dict(mode="incremental", n_rounds=2, ingest_frac=0.2,
                   update_frac=0.15),
    "delete": dict(mode="incremental", n_rounds=2, ingest_frac=0.2,
                   delete_frac=0.1),
    "adaptive": dict(mode="adaptive", n_rounds=2, ingest_frac=0.3,
                     update_frac=0.1),
}


def port_workload(seed=7):
    return pmv.realize_workload(pmv.generate_workload(n_nodes=10, seed=seed),
                                bytes_per_root=1 << 16, seed=seed,
                                key_skew=1.0, device="cpu")


_ref_cache: dict = {}


def reference_store(seed, spec_key):
    """The JAX package's fault-free single-host partitioned store (the
    bitwise oracle), read through the port's ``DiskStore``; cached per
    (seed, update kind) for the module."""
    key = (seed, spec_key)
    if key not in _ref_cache:
        root = tempfile.mkdtemp(prefix="mh-ref-")
        wl = rmv.realize_workload(rmv.generate_workload(n_nodes=10, seed=seed),
                                  bytes_per_root=1 << 16, seed=seed, key_skew=1.0)
        rmv.run_partitioned_scenario(wl, P, rmv.DiskStore(root), BUDGET,
                                     rmv.UpdateSpec(**SPECS[spec_key]), RCM)
        _ref_cache[key] = pmv.DiskStore(root, device="cpu")
    return _ref_cache[key]


def run_mh(seed, spec_key, n_hosts, **kw):
    store = pmv.DiskStore(tempfile.mkdtemp(prefix="mh-"), device="cpu")
    rep = pmv.run_multihost_scenario(
        port_workload(seed), P, store, [BUDGET / n_hosts] * n_hosts,
        pmv.UpdateSpec(**SPECS[spec_key]), PCM, round_timeout=60.0, **kw,
    )
    return rep, store


def assert_matches_reference(store, seed, spec_key):
    ref = reference_store(seed, spec_key)
    assert sorted(store.manifest()) == sorted(ref.manifest())
    pwl, _ = pmv.partition_workload(port_workload(seed), P)
    pmv.verify_scenario_equivalence(pwl, ref, store)


def assert_no_catalog_leak(rep):
    for rnd in rep.rounds:
        for hs in rnd.host_stats:
            if hs.alive:
                assert hs.used_bytes == 0.0, (
                    f"round {rnd.round_idx} host {hs.host}: "
                    f"{hs.used_bytes} bytes leaked in the catalog"
                )
            assert hs.peak_catalog_bytes <= rnd.plan.host_budgets[hs.host]


# ---------------------------------------------------------------------------
# fault-free: single- and multi-host bitwise equivalence
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_hosts", [1, 2, 4])
def test_fault_free_bitwise_thread(n_hosts):
    """No fault, so no host lost and nothing re-dispatched. Straggler
    speculation is off, as in the matrix cells: under CPU load from tests
    running beside it the detector flagged a live host thread and
    re-dispatched its partitions (speculation has its own tests in
    ``test_torch_multihost_faults.py``)."""
    rep, store = run_mh(7, "insert", n_hosts, backend="thread",
                        straggler=pmv.StragglerConfig(speculate=False))
    assert_matches_reference(store, 7, "insert")
    assert_no_catalog_leak(rep)
    assert not rep.redispatches and not rep.hosts_lost
    assert rep.n_hosts == n_hosts and len(rep.rounds) == 3
    assert rep.backend == "thread"
    # thread hosts count into this process's registry: nothing is shipped
    assert rep.launches == {}


def test_fault_free_bitwise_process():
    rep, store = run_mh(7, "update", 2, backend="process")
    assert_matches_reference(store, 7, "update")
    assert_no_catalog_leak(rep)
    assert not rep.hosts_lost
    assert rep.backend == "process"
    # a forked host ships its own counts: every data-plane kernel and
    # variant, all 0 on CPU tensors (the plain versions launch nothing)
    want = set(pmv.dataplane.launches) | set(pmv.dataplane.variant_launches)
    assert set(rep.launches) == want
    assert not any(rep.launches.values())


def test_bytes_placement_matches_hash_bitwise():
    """Placement moves partitions between hosts, never changes their bytes."""
    rep, store = run_mh(7, "insert", 2, backend="thread", placement="bytes")
    assert_matches_reference(store, 7, "insert")
    pwl, _ = pmv.partition_workload(port_workload(7), P)
    assert rep.placement == pmv.place_partitions(
        P, 2, bytes_per_partition=mh.partition_bytes(pwl, P), strategy="bytes")


def test_explicit_placement_and_no_opt_plans_bitwise():
    """An explicit partition -> host vector and the serial (no-opt) plans:
    still the oracle's bytes, and no catalog entry is ever admitted."""
    rep, store = run_mh(7, "delete", 2, backend="thread",
                        placement=(1, 1, 0, 1), optimize=False)
    assert_matches_reference(store, 7, "delete")
    assert rep.placement == (1, 1, 0, 1)
    assert all(hs.peak_catalog_bytes == 0.0 and hs.catalog_hits == 0
               for r in rep.rounds for hs in r.host_stats)


def test_placement_and_reports_match_reference():
    """The port's placement, partition bytes and per-round plans equal the
    JAX package's on the same workload (round 0, which both plan from the
    modeled sizes)."""
    from repro.core.altopt import solve_multihost as ref_solve
    from repro.mv.multihost import partition_bytes as ref_bytes

    rwl, _ = rmv.partition_workload(
        rmv.realize_workload(rmv.generate_workload(n_nodes=10, seed=11),
                             bytes_per_root=1 << 16, seed=11, key_skew=1.0), P)
    pwl, _ = pmv.partition_workload(port_workload(11), P)
    assert mh.partition_bytes(pwl, P) == ref_bytes(rwl, P)
    for H in (1, 2, 3):
        budgets = [BUDGET / H] * H
        want = ref_solve(rwl.to_graph(RCM), budgets, P)
        got = pc.solve_multihost(pwl.to_graph(PCM), budgets, P)
        assert got.placement == want.placement
        assert got.host_nodes == want.host_nodes
        for g, w in zip(got.host_plans, want.host_plans):
            assert g.order == w.order and g.flagged == w.flagged


# ---------------------------------------------------------------------------
# the process backend and CUDA
# ---------------------------------------------------------------------------

def test_process_pool_refuses_after_cuda_init(monkeypatch):
    """A coordinator that has initialised CUDA cannot fork hosts that use
    the card: a process pool on a card store raises instead of switching
    to threads; the thread backend still starts, and so does a process pool
    whose store lies on the CPU (its hosts never touch the card)."""
    pwl, pmap = pmv.partition_workload(port_workload(7), P)
    spec = pmv.partition.expand_update_spec(
        pmv.UpdateSpec(**SPECS["insert"]), pmap)
    root = tempfile.mkdtemp(prefix="mh-cuda-")
    on_card = pmv.DiskStore(root, device="cuda")   # no CUDA call: a device name
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="initialised CUDA"):
        pmv.HostPool(pwl, on_card, [BUDGET / 2] * 2, spec, backend="process")
    for backend, store in (("thread", on_card),
                           ("process", pmv.DiskStore(root, device="cpu"))):
        pool = pmv.HostPool(pwl, store, [BUDGET / 2] * 2, spec, backend=backend)
        assert pool.backend == backend
        pool.shutdown()


def test_workers_open_the_store_on_its_device():
    """A host opens its own store handle on the coordinator store's
    device, so its tables land where the coordinator's would."""
    pwl, pmap = pmv.partition_workload(port_workload(7), P)
    spec = pmv.partition.expand_update_spec(
        pmv.UpdateSpec(**SPECS["insert"]), pmap)
    store = pmv.DiskStore(tempfile.mkdtemp(prefix="mh-dev-"), device="cpu")
    pool = pmv.HostPool(pwl, store, [BUDGET], spec, backend="thread")
    try:
        assert pool.hosts[0]["worker"].store_args["device"] == torch.device("cpu")
    finally:
        pool.shutdown()


# ---------------------------------------------------------------------------
# placement unit behavior
# ---------------------------------------------------------------------------

def test_place_partitions_hash_and_bytes():
    from repro.mv.multihost import place_partitions as ref_place

    assert pmv.place_partitions(6, 2) == (0, 1, 0, 1, 0, 1)
    assert pmv.place_partitions(4, 1) == (0, 0, 0, 0)
    pl = pmv.place_partitions(4, 2, bytes_per_partition=[100, 90, 5, 5],
                              strategy="bytes")
    assert pl[0] != pl[1]
    loads = [0.0, 0.0]
    for p, h in enumerate(pl):
        loads[h] += [100, 90, 5, 5][p]
    assert abs(loads[0] - loads[1]) <= 10
    for args, kw in [((6, 2), {}), ((8, 3), {}),
                     ((4, 2), dict(bytes_per_partition=[100, 90, 5, 5],
                                   strategy="bytes")),
                     ((7, 3), dict(bytes_per_partition=[3, 9, 1, 9, 4, 4, 2],
                                   strategy="bytes"))]:
        assert pmv.place_partitions(*args, **kw) == ref_place(*args, **kw)
    with pytest.raises(ValueError, match="bytes_per_partition"):
        pmv.place_partitions(4, 2, strategy="bytes")
    with pytest.raises(ValueError, match="unknown placement"):
        pmv.place_partitions(4, 2, bytes_per_partition=[1, 1, 1, 1],
                             strategy="nope")
    with pytest.raises(ValueError, match="covers 3 partitions"):
        pmv.place_partitions(4, 2, bytes_per_partition=[1, 1, 1],
                             strategy="bytes")


def test_fault_plan_for_host():
    a = pmv.FaultAction("kill", host=1)
    b = pmv.FaultAction("delay", host=0, seconds=0.5)
    fp = pmv.FaultPlan((a, b))
    assert fp.for_host(1) == (a,)
    assert fp.for_host(0) == (b,)
    assert fp.for_host(3) == ()


def test_unknown_backend_and_stale_store_raise():
    pwl, _ = pmv.partition_workload(port_workload(7), P)
    store = pmv.DiskStore(tempfile.mkdtemp(prefix="mh-bad-"), device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        pmv.HostPool(pwl, store, [BUDGET], pmv.UpdateSpec(**SPECS["insert"]),
                     backend="nope")
    run_mh_store = pmv.DiskStore(tempfile.mkdtemp(prefix="mh-stale-"), device="cpu")
    spec = pmv.UpdateSpec(**dict(SPECS["insert"], n_rounds=0))
    pmv.run_multihost_scenario(port_workload(7), 1, run_mh_store, [BUDGET], spec,
                               PCM, backend="thread")
    with pytest.raises(ValueError, match="empty store"):
        pmv.run_multihost_scenario(port_workload(7), 1, run_mh_store, [BUDGET],
                                   spec, PCM, backend="thread")
