"""The acceptance matrix of multi-host refresh in the port: seeds x hosts x
update kinds, with a mid-round host kill wherever a host is to spare, each
store bitwise equal to the JAX package's fault-free single-host partitioned
store (the sizes of ``tests/mv/test_multihost.py``: 64 KiB per root, Zipf
1.0 keys, P = 4, the budget split over the hosts). The insert and update
kinds here; delete and adaptive in ``test_torch_multihost_matrix_retract.py``."""
import pytest

from test_torch_multihost import (
    assert_matches_reference,
    assert_no_catalog_leak,
    run_mh,
)
import repro_torch.mv as pmv


@pytest.mark.parametrize("seed", [7, 11, 23])
@pytest.mark.parametrize("n_hosts", [1, 2, 4])
@pytest.mark.parametrize("spec_key", ["insert", "update"])
def test_acceptance_matrix_bitwise(seed, n_hosts, spec_key):
    check_matrix_cell(seed, n_hosts, spec_key)


def check_matrix_cell(seed, n_hosts, spec_key):
    fp = None
    if n_hosts > 1:
        fp = pmv.FaultPlan((
            pmv.FaultAction("kill", host=n_hosts - 1, round_idx=1,
                            after_tasks=1),
        ))
    # Speculation off: under CPU load the straggler detector can flag a
    # live host and re-dispatch its tasks, which this cell's assertion that
    # every re-dispatch comes from the killed host does not allow.
    # Speculation keeps its own tests in test_torch_multihost_faults.py.
    rep, store = run_mh(seed, spec_key, n_hosts, backend="thread",
                        fault_plan=fp,
                        straggler=pmv.StragglerConfig(speculate=False))
    assert_matches_reference(store, seed, spec_key)
    assert_no_catalog_leak(rep)
    if n_hosts > 1:
        assert rep.hosts_lost == [n_hosts - 1]
        assert rep.redispatches
        assert all(r.from_host == n_hosts - 1 for r in rep.redispatches)
    else:
        assert not rep.hosts_lost and not rep.redispatches
