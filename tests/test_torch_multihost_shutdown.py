"""The process backend of multi-host refresh cannot hang its caller.

A forked host that ignores SIGTERM (its drain handler only sets a flag) or
blocks it must be gone within a few seconds of ``HostPool.shutdown()``,
killed and joined, so that nothing is left for the interpreter's exit to
join. And a host that dies in the middle of sending a message, holding its
send lock with half the message in its pipe, must leave the round able to
finish on the other hosts, the store bitwise equal to the JAX package's
fault-free single-host store: each host sends on a pipe of its own, so no
lock or buffer of the dead host stands in another host's way.
"""
import multiprocessing as mp
import os
import signal
import struct
import tempfile
import threading
import time

import pytest

from test_torch_multihost import (
    BUDGET,
    P,
    SPECS,
    assert_matches_reference,
    assert_no_catalog_leak,
    port_workload,
    run_mh,
)
import repro_torch.mv as pmv
from repro_torch.mv import multihost as mh
from repro_torch.mv.partition import expand_update_spec

SHUTDOWN_LIMIT = mh.SHUTDOWN_GRACE + 3.0   # the grace, a second after SIGTERM, one after SIGKILL


def _stuck_loop(mask_sigterm):
    def loop(self, store, engine, writer):
        if mask_sigterm:
            signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGTERM})
        self._send(("ready", self.host))
        threading.Event().wait()   # never answers, never reads its control queue
    return loop


@pytest.mark.parametrize("mask_sigterm", [False, True], ids=["drain_flag", "masked"])
def test_shutdown_kills_a_host_that_ignores_sigterm(monkeypatch, mask_sigterm):
    monkeypatch.setattr(mh._HostWorker, "_loop", _stuck_loop(mask_sigterm))
    pwl, pmap = pmv.partition_workload(port_workload(7), P)
    espec = expand_update_spec(pmv.UpdateSpec(**SPECS["insert"]), pmap)
    store = pmv.DiskStore(tempfile.mkdtemp(prefix="mh-stuck-"), device="cpu")
    pool = pmv.HostPool(pwl, store, [BUDGET / 2] * 2, espec, backend="process")
    try:
        ready = {pool.resq.get(timeout=60)[1] for _ in range(2)}
        assert ready == {0, 1}   # both installed their SIGTERM handling, then blocked
    finally:
        t0 = time.monotonic()
        pool.shutdown()
        took = time.monotonic() - t0
    assert took < SHUTDOWN_LIMIT, f"shutdown took {took:.1f}s"
    for host in pool.hosts:
        assert not host["proc"].is_alive()
        assert host["proc"].exitcode == -signal.SIGKILL  # SIGTERM did not end it
    live = {p.pid for p in mp.active_children()}
    assert not live & {host["proc"].pid for host in pool.hosts}


def _die_mid_send(self):
    """Die holding the send lock, a message header and a few of its bytes
    already in the pipe (a writer cut off mid-message)."""
    if self.backend != "process":
        raise AssertionError("this fault needs a forked host")
    self._send_lock.acquire()
    os.write(self.resq.fileno(), struct.pack("!i", 1 << 16) + b"partial")
    os._exit(13)


def test_host_dying_mid_send_leaves_the_round_able_to_finish(monkeypatch):
    monkeypatch.setattr(mh._HostWorker, "_die", _die_mid_send)
    fp = pmv.FaultPlan((pmv.FaultAction("kill", host=1, round_idx=1, after_tasks=1),))
    t0 = time.monotonic()
    rep, store = run_mh(7, "update", 3, backend="process", fault_plan=fp,
                        straggler=pmv.StragglerConfig(speculate=False))
    took = time.monotonic() - t0
    assert_matches_reference(store, 7, "update")
    assert rep.hosts_lost == [1]
    assert {(r.from_host, r.reason) for r in rep.redispatches} == {(1, "dead")}
    assert_no_catalog_leak(rep)
    assert took < 50.0, f"the scenario took {took:.1f}s (rounds time out at 60s)"
