"""The port's collectives over a 2 x 2 mesh of gloo ranks on the CPU,
against numpy, and ``compressed_psum`` bitwise against the JAX package's.

Four ranks (``test_torch_mesh_ranks.run_ranks``) run every collective of
``sharding.collectives`` over ``data``, ``model`` and both axes on inputs
made from the rank's number, and the autograd pieces (``copy_to``,
``reduce_from``, ``gather_from``); each result is held against numpy.
``compressed_psum`` runs on rows made with numpy from a seed, and the
reference's runs as ``jax.vmap(lambda v: compressed_psum(v, "i"),
axis_name="i")`` over the same rows, stacked, on one CPU device: the port's
result is bitwise the reference's.
"""
import jax
import numpy as np
import pytest
import torch

from repro.sharding.compression import compressed_psum as ref_psum
from test_torch_mesh_ranks import run_ranks

WORLD = 4
TIMEOUT = 120
AXES = {"data": lambda r: [r % 2, r % 2 + 2], "model": lambda r: [r - r % 2, r - r % 2 + 1],
        "both": lambda r: [0, 1, 2, 3]}


def x_of(r):
    return np.arange(12, dtype=np.float32).reshape(4, 3) * (r + 1)


@pytest.fixture(scope="module")
def rows():
    rng = np.random.default_rng(7)
    return (rng.standard_normal((WORLD, 64)) * np.array([[0.5], [3.0], [1e-3], [40.0]])
            ).astype(np.float32)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, rows):
    root = tmp_path_factory.mktemp("collectives")
    np.savez(root / "psum.npz", x=rows)
    return run_ranks("collectives", WORLD, root, TIMEOUT)


@pytest.fixture(scope="module")
def grads(tmp_path_factory):
    return run_ranks("autograd", WORLD, tmp_path_factory.mktemp("autograd"), TIMEOUT)


def test_coords_are_row_major(ranks):
    assert [r["coords"] for r in ranks] == [{"data": r // 2, "model": r % 2}
                                            for r in range(WORLD)]


@pytest.mark.parametrize("axis", list(AXES))
def test_all_reduce_sum_max_and_ints(ranks, axis):
    for r, got in enumerate(ranks):
        group = AXES[axis](r)
        np.testing.assert_array_equal(got[f"sum_{axis}"].numpy(), sum(x_of(q) for q in group))
        np.testing.assert_array_equal(got[f"max_{axis}"].numpy(),
                                      np.max([x_of(q) - 5 * q for q in group], axis=0))
        np.testing.assert_array_equal(got[f"int_{axis}"].numpy(),
                                      sum(np.arange(4, dtype=np.int32) + q for q in group))
        assert got[f"int_{axis}"].dtype == torch.int32


@pytest.mark.parametrize("axis", list(AXES))
def test_half_sums_run_in_f32_and_cast_once(ranks, axis):
    for r, got in enumerate(ranks):
        parts = [torch.from_numpy(x_of(q)).to(torch.bfloat16) / 3 for q in AXES[axis](r)]
        want = sum(p.float() for p in parts).to(torch.bfloat16)
        assert got[f"bf16_{axis}"].dtype == torch.bfloat16
        assert torch.equal(got[f"bf16_{axis}"], want)


@pytest.mark.parametrize("axis", list(AXES))
def test_all_gather_along_either_dim(ranks, axis):
    for r, got in enumerate(ranks):
        parts = [x_of(q) for q in AXES[axis](r)]
        np.testing.assert_array_equal(got[f"gather0_{axis}"].numpy(), np.concatenate(parts, 0))
        np.testing.assert_array_equal(got[f"gather1_{axis}"].numpy(), np.concatenate(parts, 1))


@pytest.mark.parametrize("axis", list(AXES))
def test_reduce_scatter_gives_each_rank_its_part_of_the_sum(ranks, axis):
    for r, got in enumerate(ranks):
        group = AXES[axis](r)
        total = sum(x_of(q) for q in group)
        part = np.split(total, len(group), axis=0)[group.index(r)]
        np.testing.assert_array_equal(got[f"scatter0_{axis}"].numpy(), part)


@pytest.mark.parametrize("axis", list(AXES))
def test_all_to_all_exchanges_parts(ranks, axis):
    for r, got in enumerate(ranks):
        group = AXES[axis](r)
        i = group.index(r)
        want = np.concatenate([np.split(x_of(q), len(group), axis=0)[i] for q in group], 0)
        np.testing.assert_array_equal(got[f"a2a_{axis}"].numpy(), want)


@pytest.mark.parametrize("axis", ["model", "both"])
def test_compressed_psum_is_bitwise_the_reference(ranks, rows, axis):
    fn = jax.vmap(lambda v: ref_psum(v, "i"), axis_name="i")
    for r, got in enumerate(ranks):
        group = AXES[axis](r)
        want = np.asarray(fn(rows[group]))[group.index(r)]
        res = got[f"psum_{axis}"].numpy()
        assert res.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(res.view(np.int32), want.view(np.int32))


def test_counts_by_kind(ranks):
    for got in ranks:
        c = got["counts"]
        assert c["calls"] == {"all_reduce": 3 * 4 + 2 * 2, "all_gather": 6,
                              "reduce_scatter": 3, "all_to_all": 3}
        assert c["bytes"]["all_gather"] == 6 * 48 and c["bytes"]["all_to_all"] == 3 * 48
        # f32 and the bf16 sum's f32 copy (48 B each), int32 (16 B); the psums' two
        assert c["bytes"]["all_reduce"] == 3 * (48 * 3 + 16) + 2 * (4 + 256)
        assert c["host_staged_bytes"] == 0   # CPU tensors stay on the host


def test_copy_to_and_reduce_from_gradients(grads):
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    for r, got in enumerate(grads):
        group = AXES["model"](r)
        np.testing.assert_array_equal(got["y"].numpy(),
                                      np.full((2, 3), sum((q + 1) ** 2 for q in group)))
        np.testing.assert_array_equal(got["gx"].numpy(), a * sum(q + 1 for q in group))


def test_gather_from_reduce_scatters_its_gradient(grads):
    for r, got in enumerate(grads):
        group = AXES["data"](r)
        np.testing.assert_array_equal(
            got["full"].numpy(),
            np.concatenate([np.arange(6.).reshape(3, 2) + 10 * q for q in group], 0))
        np.testing.assert_array_equal(got["gw"].numpy(),
                                      np.full((3, 2), sum(q + 1 for q in group)))
