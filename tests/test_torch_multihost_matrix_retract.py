"""The acceptance matrix of multi-host refresh in the port, its delete and
adaptive update kinds: seeds x hosts, with a mid-round host kill wherever a
host is to spare, each store bitwise equal to the JAX package's fault-free
single-host partitioned store (see ``test_torch_multihost_matrix.py``)."""
import pytest

from test_torch_multihost_matrix import check_matrix_cell


@pytest.mark.parametrize("seed", [7, 11, 23])
@pytest.mark.parametrize("n_hosts", [1, 2, 4])
@pytest.mark.parametrize("spec_key", ["adaptive", "delete"])
def test_acceptance_matrix_bitwise(seed, n_hosts, spec_key):
    check_matrix_cell(seed, n_hosts, spec_key)
