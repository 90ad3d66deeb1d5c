"""Fault schedules of multi-host refresh in the port, each store bitwise
equal to the JAX package's fault-free single-host partitioned store
(mirrors the chaos and accounting tests of ``tests/mv/test_multihost.py``):
a mid-round host kill and a preemption during write-behind on the thread
and the process backends, a straggler's speculative re-dispatch, the
re-dispatch spans, the loss of every host, and a dead host's catalog."""
import dataclasses
import tempfile

import pytest

from test_torch_multihost import (
    BUDGET,
    P,
    PCM,
    SPECS,
    assert_matches_reference,
    assert_no_catalog_leak,
    port_workload,
    run_mh,
)
import repro_torch.mv as pmv
from repro_torch.core.altopt import solve_multihost
from repro_torch.mv import multihost as mh
from repro_torch.mv.partition import expand_update_spec
from repro_torch.obs import trace as obs_trace


@pytest.mark.parametrize("backend", ["thread", "process"])
def test_kill_mid_round_recovers_bitwise(backend):
    fp = pmv.FaultPlan((pmv.FaultAction("kill", host=1, round_idx=1,
                                        after_tasks=1),))
    rep, store = run_mh(7, "update", 2, backend=backend, fault_plan=fp)
    assert_matches_reference(store, 7, "update")
    assert rep.hosts_lost == [1]
    assert any(r.reason == "dead" for r in rep.redispatches)
    assert all(r.from_host == 1 for r in rep.redispatches)
    assert_no_catalog_leak(rep)
    lost_round = next(r for r in rep.rounds if r.hosts_lost)
    for rnd in rep.rounds[lost_round.round_idx + 1:]:
        assert not rnd.host_stats[1].alive
        assert rnd.host_stats[1].executed == 0


@pytest.mark.parametrize("backend", ["thread", "process"])
def test_preempt_during_write_behind_recovers_bitwise(backend):
    fp = pmv.FaultPlan((pmv.FaultAction("preempt", host=0, round_idx=1,
                                        after_tasks=1),))
    rep, store = run_mh(7, "insert", 2, backend=backend, fault_plan=fp)
    assert_matches_reference(store, 7, "insert")
    assert rep.hosts_lost == [0]
    assert rep.redispatches
    assert {r.reason for r in rep.redispatches} <= {"preempted", "dead"}
    assert_no_catalog_leak(rep)


def test_straggler_delay_redispatches_and_stays_bitwise():
    """A host delayed past the straggler threshold is flagged mid-round and
    its pending partitions run speculatively on the survivors, without the
    host dying and without changing a byte."""
    fp = pmv.FaultPlan((pmv.FaultAction("delay", host=2, round_idx=1,
                                        after_tasks=0, seconds=0.4),))
    rep, store = run_mh(
        7, "insert", 4, backend="thread", fault_plan=fp,
        straggler=pmv.StragglerConfig(threshold=2.0, patience=2, interval=0.05),
    )
    assert_matches_reference(store, 7, "insert")
    assert not rep.hosts_lost
    assert any(r.reason == "straggler" for r in rep.redispatches)
    flagged = [e for rnd in rep.rounds for e in rnd.straggler_events]
    assert any(e.host == 2 for e in flagged)
    assert_no_catalog_leak(rep)


def test_flagged_then_recovered_host_gets_work_again(monkeypatch):
    """Straggler suspicion is per round: a host flagged in round 1 executes
    its own partitions again in round 2. Only round 1 speculates, with a
    1 s delay far past the threshold, so no timing jitter of the other
    rounds can flag a host; a suspicion carried into round 2 would leave
    host 2's partitions unissued and time the round out."""
    flagging = pmv.StragglerConfig(threshold=2.0, patience=2, interval=0.02)
    quiet = dataclasses.replace(flagging, speculate=False)
    run_round = mh.HostPool.run_round

    def one_round(self, round_idx, *args, **kw):
        self.cfg = flagging if round_idx == 1 else quiet
        return run_round(self, round_idx, *args, **kw)

    monkeypatch.setattr(mh.HostPool, "run_round", one_round)
    fp = pmv.FaultPlan((pmv.FaultAction("delay", host=2, round_idx=1,
                                        after_tasks=0, seconds=1.0),))
    rep, store = run_mh(7, "insert", 4, backend="thread", fault_plan=fp)
    assert_matches_reference(store, 7, "insert")
    r1, r2 = rep.rounds[1], rep.rounds[2]
    assert any(r.reason == "straggler" and r.from_host == 2
               for r in r1.redispatches)
    assert any(e.host == 2 for e in r1.straggler_events)
    assert not r2.redispatches
    assert r2.host_stats[2].executed > 0
    assert_no_catalog_leak(rep)


def test_redispatch_visible_in_trace_spans():
    fp = pmv.FaultPlan((pmv.FaultAction("kill", host=1, round_idx=1,
                                        after_tasks=0),))
    was = obs_trace.enabled()
    obs_trace.enable(True)
    obs_trace.clear()
    try:
        rep, store = run_mh(7, "insert", 2, backend="thread", fault_plan=fp)
        spans = obs_trace.drain()
    finally:
        obs_trace.enable(was)
    assert_matches_reference(store, 7, "insert")
    rd = [s for s in spans if s.cat == "redispatch"]
    assert len(rd) == len(rep.redispatches) > 0
    assert [s.name for s in rd] == [r.node for r in rep.redispatches]
    # re-dispatch events land on the receiving host's track
    assert [s.track for s in rd] == [f"host{r.to_host}" for r in rep.redispatches]
    assert all(s.worker == "coord" for s in rd)
    assert {s.name for s in spans if s.cat == "round"} == {"round0", "round1", "round2"}


def test_all_hosts_lost_raises():
    fp = pmv.FaultPlan((
        pmv.FaultAction("kill", host=0, round_idx=1, after_tasks=0),
        pmv.FaultAction("kill", host=1, round_idx=1, after_tasks=0),
    ))
    with pytest.raises(RuntimeError, match="no surviving host"):
        run_mh(7, "insert", 2, backend="thread", fault_plan=fp)


def test_dead_host_catalog_entries_are_dropped():
    """Partitions admitted by a host that dies mid-round are released
    before replay: the killed host's catalog is cleared and no survivor
    carries phantom ``used_bytes`` past round end."""
    pwl, pmap = pmv.partition_workload(port_workload(7), P)
    espec = expand_update_spec(pmv.UpdateSpec(**SPECS["insert"]), pmap)
    store = pmv.DiskStore(tempfile.mkdtemp(prefix="mh-leak-"), device="cpu")
    budgets = [BUDGET / 2] * 2
    fp = pmv.FaultPlan((pmv.FaultAction("kill", host=1, round_idx=0,
                                        after_tasks=2),))
    pool = pmv.HostPool(pwl, store, budgets, espec, backend="thread",
                        fault_plan=fp, round_timeout=60.0)
    try:
        plan = solve_multihost(pwl.to_graph(PCM), budgets, P)
        rep = pool.run_round(0, plan, sizes=[n.size for n in pwl.nodes])
        assert rep.hosts_lost == [1]
        assert rep.redispatches
        assert pool.host_catalog_used(1) == 0.0
        assert pool.host_catalog_used(0) == 0.0
        for hs in rep.host_stats:
            if hs.alive:
                assert hs.used_bytes == 0.0
        assert set(store.manifest()) == {n.name for n in pwl.nodes}
    finally:
        pool.shutdown()


def test_stuck_host_times_out_the_round():
    """A host that does not answer turns into a raised error after
    ``round_timeout``, not a hang (the process tests rely on it)."""
    fp = pmv.FaultPlan((pmv.FaultAction("delay", host=1, round_idx=0,
                                        after_tasks=0, seconds=8.0),))
    with pytest.raises(RuntimeError, match="timed out"):
        pmv.run_multihost_scenario(
            port_workload(7), P,
            pmv.DiskStore(tempfile.mkdtemp(prefix="mh-stuck-"), device="cpu"),
            [BUDGET / 2] * 2, pmv.UpdateSpec(**SPECS["insert"]), PCM,
            backend="thread", fault_plan=fp, round_timeout=2.0,
            straggler=pmv.StragglerConfig(speculate=False))
