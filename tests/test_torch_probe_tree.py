"""The join probe's search tree, modelled in plain PyTorch on the CPU.

``csrc/dataplane.cu``'s ``probe_sorted`` builds a static B+-tree over the
sorted-unique index for each call: leaves are runs of ``TREE_KEYS`` keys of
the index itself, internal nodes hold ``TREE_KEYS`` separators (the first
key of children 1..8, INT64_MAX where a child does not exist) over
``TREE_FAN`` children, and a probe descends by counting the separators
below it. This file holds a PyTorch model of that build and descent, with
the kernel's geometry (``dataplane.probe_tree_levels``), node width and
padding, bitwise against the port's plain version and the JAX package's
``probe_sorted`` on its numpy path and in Pallas interpret mode. The card
runs the kernel itself against the plain version in
``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro.mv import dataplane as rdp
from repro_torch.mv import dataplane as dp

B, FAN = dp.TREE_KEYS, dp.TREE_FAN
I64MAX = np.iinfo(np.int64).max
I64MIN = np.iinfo(np.int64).min

# Index sizes: one leaf and its edges, and the edges of every leaf count
# that fills a level (FAN^k leaves, B * FAN^k keys), then one more.
SIZES = sorted({1, 2, B - 1, B, B + 1, 4097,
                *(FAN**k + d for k in (1, 2, 3) for d in (-1, 0, 1)),
                *(B * FAN**k + d for k in (1, 2, 3) for d in (-1, 0, 1))})


def build_levels(uniq: torch.Tensor) -> list[torch.Tensor]:
    """The kernel's separator build: per internal level, root first, a
    (nodes, B) tensor whose key k of node q is the first key of child
    q*FAN + k + 1, that is ``uniq[(q*FAN + k + 1) * span]`` with ``span =
    B * FAN^(levels-1-d)`` keys under one child, and INT64_MAX past L."""
    L = len(uniq)
    counts = dp.probe_tree_levels(L)
    levels = []
    for d, nodes in enumerate(counts):
        span = B * FAN ** (len(counts) - 1 - d)
        first = (torch.arange(nodes)[:, None] * FAN + torch.arange(B) + 1) * span
        levels.append(torch.where(first < L, uniq[first.clamp(max=L - 1)], I64MAX))
    return levels


def descend(uniq: torch.Tensor, levels: list[torch.Tensor],
            probe: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's descent: the child is the count of a node's separators
    below the probe; at leaf j the lower bound is B*j plus the count of its
    keys below the probe (INT64_MAX past L); the hit test compares with the
    leaf's keys, or with the next leaf's first key when all B are below."""
    L = len(uniq)
    q = torch.zeros(len(probe), dtype=torch.int64)
    for keys in levels:
        q = q * FAN + (keys[q] < probe[:, None]).sum(1)
    first = q[:, None] * B + torch.arange(B)
    leaf = torch.where(first < L, uniq[first.clamp(max=L - 1)], I64MAX)
    c = (leaf < probe[:, None]).sum(1)
    lb = q * B + c
    inside = lb < L
    hit = inside & (leaf == probe[:, None]).any(1)
    hit = torch.where((c == B) & inside, uniq[lb.clamp(max=L - 1)] == probe, hit)
    return hit, torch.where(inside, lb, L - 1)


def make_index(L: int, kind: str, seed: int) -> np.ndarray:
    """L sorted unique int64 keys with gaps of 1-3 (so key +- 1 is often a
    key too); ``extremes`` puts INT64_MIN first and INT64_MAX last."""
    rng = np.random.default_rng(seed)
    keys = -2 * L + np.cumsum(rng.integers(1, 4, L)).astype(np.int64)
    if kind == "extremes":
        keys[0] = I64MIN
        keys[-1] = I64MAX
    return keys


def make_probes(keys: np.ndarray) -> np.ndarray:
    """INT64_MIN, INT64_MAX, every key, and every key +- 1 (wrapping at the
    ends, as numpy does)."""
    with np.errstate(over="ignore"):
        return np.concatenate([[I64MIN, I64MAX], keys, keys - 1, keys + 1])


def assert_same(ref, got, ctx):
    for r, g in zip(ref, got, strict=True):
        r, g = np.asarray(r), g.numpy()
        assert r.dtype == g.dtype and r.shape == g.shape, ctx
        assert r.tobytes() == g.tobytes(), ctx


# an index of one key cannot hold both extremes
CASES = [(L, kind) for L in SIZES for kind in ("gaps", "extremes")
         if not (kind == "extremes" and L < 2)]


@pytest.mark.parametrize("L,kind", CASES)
def test_tree_model_matches_plain_and_reference(L, kind):
    keys = make_index(L, kind, L)
    probe = make_probes(keys)
    uniq, p = torch.from_numpy(keys), torch.from_numpy(probe)
    got = descend(uniq, build_levels(uniq), p)
    assert_same(dp._probe_plain(uniq, p), got, f"plain L={L}")
    assert_same(dp.probe_sorted(uniq, p), got, f"wrapper L={L}")
    for impl in ("numpy", "interpret"):
        with rdp.use_impl(impl):
            ref = rdp.probe_sorted(keys, probe)
        assert_same(ref, got, f"{impl} L={L}")


@pytest.mark.parametrize("L", SIZES)
def test_tree_levels_cover_the_index(L):
    """Each level holds ceil(nodes below / FAN) nodes up to one root, so the
    root's children span every leaf; every separator is a key of the index
    (or a pad), sorted along each level, and pads only trail."""
    counts = dp.probe_tree_levels(L)
    leaves = -(-L // B)
    assert (counts == []) == (leaves == 1)
    below = leaves
    for nodes in reversed(counts):
        assert nodes == -(-below // FAN)
        below = nodes
    assert not counts or counts[0] == 1
    keys = make_index(L, "gaps", L)
    for level in build_levels(torch.from_numpy(keys)):
        flat = level.reshape(-1)
        real = flat[flat != I64MAX]
        assert torch.all(real[1:] > real[:-1])
        assert np.isin(real.numpy(), keys).all()
        assert torch.all(flat[len(real):] == I64MAX)


def test_tree_model_on_random_probes_into_a_large_index():
    """The main path's case, shrunk: uniform probes, many of them misses,
    into 50,000 keys spread over the whole int64 range."""
    rng = np.random.default_rng(7)
    keys = np.unique(rng.integers(I64MIN, I64MAX, 50_000, dtype=np.int64,
                                  endpoint=True))
    probe = np.concatenate([rng.choice(keys, 20_000),
                            rng.integers(I64MIN, I64MAX, 20_000, dtype=np.int64,
                                         endpoint=True)])
    uniq, p = torch.from_numpy(keys), torch.from_numpy(probe)
    got = descend(uniq, build_levels(uniq), p)
    assert_same(rdp.probe_sorted(keys, probe, impl="numpy"), got, "numpy")
    assert_same(dp._probe_plain(uniq, p), got, "plain")
    assert 0.4 < float(got[0].float().mean()) < 0.6
