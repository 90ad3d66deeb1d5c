"""The port's data-plane primitives against the JAX package's, bitwise.

Every primitive of ``repro_torch.mv.dataplane`` gets the same numpy inputs
(made from a seed) as ``repro.mv.dataplane`` and must return the same dtype,
shape and bytes. The reference runs on its numpy path and, for the
primitives that reach a Pallas kernel, also in Pallas interpret mode — the
way ``tests/mv/test_dataplane.py`` runs it. The port runs on CPU tensors,
which take the plain PyTorch versions of its CUDA kernels.
"""
import numpy as np
import pytest
import torch

from repro.mv import dataplane as rdp
from repro.mv import tableops as RT
from repro_torch.mv import dataplane as dp

KERNEL_IMPLS = ["numpy", "interpret"]
SEEDS = [3, 11, 2026]
I64MAX = np.iinfo(np.int64).max
I64MIN = np.iinfo(np.int64).min


def tt(a):
    return torch.from_numpy(np.array(a, copy=True))


def assert_bitwise(ref, got, ctx=""):
    ref = ref if isinstance(ref, tuple) else (ref,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(ref) == len(got), ctx
    for i, (r, g) in enumerate(zip(ref, got)):
        r, g = np.asarray(r), g.numpy()
        assert r.dtype == g.dtype, (ctx, i, r.dtype, g.dtype)
        assert r.shape == g.shape, (ctx, i, r.shape, g.shape)
        assert r.tobytes() == g.tobytes(), (ctx, i, "bytes differ")


def ref_call(impl, fn, *args, **kw):
    with rdp.use_impl(impl):
        return fn(*args, **kw)


@pytest.fixture(params=SEEDS)
def base(request):
    return RT.make_base_table(3000, 4, seed=request.param, rid_base=0)


@pytest.mark.parametrize("impl", KERNEL_IMPLS)
def test_hash_partition_primitives_bitwise(base, impl):
    keys = base["key"]
    ref = ref_call(impl, lambda: (rdp.hash64(keys), rdp.partition_ids(keys, 13),
                                  *rdp.partition_index(keys, 13)))
    got = (dp.hash64(tt(keys)), dp.partition_ids(tt(keys), 13),
           *dp.partition_index(tt(keys), 13))
    assert_bitwise(ref, got, f"hash/{impl}")


@pytest.mark.parametrize("P", [1, 2, 7, (1 << 20) + 7, (1 << 31) - 1])
def test_partition_ids_full_int64_range(P):
    """Negative keys and the largest P: the int64 emulation of uint64
    shifts and ``% P`` must match numpy's uint64 arithmetic everywhere."""
    rng = np.random.default_rng(P % 1000)
    keys = rng.integers(I64MIN, I64MAX, 5000, dtype=np.int64, endpoint=True)
    keys[:4] = [0, -1, I64MAX, I64MIN]
    assert_bitwise(rdp.hash64(keys, impl="numpy"), dp.hash64(tt(keys)), "hash")
    assert_bitwise(rdp.partition_ids(keys, P, impl="numpy"),
                   dp.partition_ids(tt(keys), P), f"pid P={P}")


def zipf_keys(n, a, seed):
    """Zipf(a)-skewed int64 keys: most rows share a few hot keys."""
    return np.random.default_rng(seed).zipf(a, n).astype(np.int64)


@pytest.mark.parametrize("impl", KERNEL_IMPLS)
@pytest.mark.parametrize("P", [8, 4096, 100_003])
@pytest.mark.parametrize("skew", [0.0, 1.3])
def test_pid_hist_pids_counts_and_order_bitwise(impl, P, skew):
    """``pid_hist``'s per-row pids and histogram, and ``partition_index``'s
    grouping, against the reference's fused Pallas kernel (interpret) and
    its numpy path, on uniform and Zipf-skewed keys."""
    rng = np.random.default_rng(P)
    keys = zipf_keys(6000, skew, P) if skew else \
        rng.integers(I64MIN, I64MAX, 6000, dtype=np.int64, endpoint=True)
    keys[:4] = [0, -1, I64MAX, I64MIN]
    ref_order, ref_counts = ref_call(impl, rdp.partition_index, keys, P)
    ref_pid = ref_call(impl, rdp.partition_ids, keys, P)
    pid, counts = dp.pid_hist(tt(keys), P)
    assert_bitwise((ref_pid, ref_counts), (pid, counts), f"pid_hist/{impl}")
    assert_bitwise((ref_order, ref_counts), dp.partition_index(tt(keys), P),
                   f"index/{impl}")
    if skew:
        assert int(counts.max()) > 2 * 6000 / min(P, 6000)


@pytest.mark.parametrize("P", [(1 << 31) - 1, (1 << 31) - 2, (1 << 30) + 3,
                               100_003])
def test_partition_ids_near_2_31_on_zipf_keys(P):
    keys = zipf_keys(5000, 1.3, P % 97)
    keys[:2] = [I64MAX, I64MIN]
    assert_bitwise(rdp.partition_ids(keys, P, impl="numpy"),
                   dp.partition_ids(tt(keys), P), f"pid P={P}")


def test_partition_count_out_of_range_raises():
    keys = tt(np.arange(10, dtype=np.int64))
    for fn in (dp.partition_ids, dp.partition_index, dp.pid_hist):
        with pytest.raises(ValueError, match="2\\^31"):
            fn(keys, 1 << 31)
    with pytest.raises(ValueError, match="> 1"):
        dp.pid_hist(keys, 1)
    assert dp.partition_ids(keys, 0).tolist() == [0] * 10
    assert dp.partition_index(keys, 1)[1].tolist() == [10]


# The reference's Pallas compare casts the threshold to an integer column's
# own dtype (cmp_kernel_factory), where its numpy path compares in float64;
# the two disagree for a fractional negative threshold. The numpy path is
# the contract, so int64 columns are held against it alone.
FILTER_CASES = [(dt, impl) for dt in (np.float32, np.float64, np.int64)
                for impl in KERNEL_IMPLS
                if not (dt is np.int64 and impl == "interpret")]


@pytest.mark.parametrize("dtype,impl", FILTER_CASES)
@pytest.mark.parametrize("thr", [0.5, 0.1, -0.3])
def test_filter_compare_dtype_pinning(impl, dtype, thr):
    rng = np.random.default_rng(5)
    col = (rng.standard_normal(2000) * 3).astype(dtype)
    col[:3] = np.asarray([thr, 0, -1]).astype(dtype)
    ref = ref_call(impl, rdp.filter_mask, col, thr)
    assert_bitwise(ref, dp.filter_mask(tt(col), thr), f"filter {dtype}/{impl}")


def test_filter_special_values():
    col = np.asarray([np.nan, np.inf, -np.inf, -0.0, 0.0, 1e-45, 0.1],
                     np.float32)
    for thr in (0.0, 0.1, -np.inf):
        assert_bitwise(rdp.filter_mask(col, thr, impl="numpy"),
                       dp.filter_mask(tt(col), thr), f"thr={thr}")


MAP_CASES = {
    # name: (a dtype, b dtype or None, reference impls that keep numpy's
    # result dtype for this combination)
    "f32_f32": (np.float32, np.float32, KERNEL_IMPLS),
    "f64_f64": (np.float64, np.float64, KERNEL_IMPLS),
    "f32_one": (np.float32, None, KERNEL_IMPLS),
    "f64_one": (np.float64, None, KERNEL_IMPLS),
    "f32_f64": (np.float32, np.float64, ["numpy"]),
    "f64_f32": (np.float64, np.float32, ["numpy"]),
    "f64_i64": (np.float64, np.int64, ["numpy"]),
    "i64_one": (np.int64, None, ["numpy"]),
}


@pytest.mark.parametrize("case", sorted(MAP_CASES))
def test_map_derived_every_dtype_combination(case):
    adt, bdt, impls = MAP_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    a = (rng.standard_normal(2500) * 50).astype(adt)
    b = None if bdt is None else (rng.standard_normal(2500) * 50).astype(bdt)
    got = dp.map_derived(tt(a), None if b is None else tt(b))
    for impl in impls:
        ref = ref_call(impl, rdp.map_derived, a, b)
        assert_bitwise(ref, got, f"map {case}/{impl}")


def test_map_derived_special_values():
    sp = [0.0, -0.0, 1e-40, -1e-40, 3e38, -3e38, np.inf, -np.inf, np.nan, 1.0]
    for dt in (np.float32, np.float64):
        a = np.asarray(sp, dt)
        b = np.asarray(sp[::-1], dt)
        assert_bitwise(rdp.map_derived(a, b, impl="numpy"),
                       dp.map_derived(tt(a), tt(b)), f"two {dt}")
        assert_bitwise(rdp.map_derived(a, None, impl="numpy"),
                       dp.map_derived(tt(a), None), f"one {dt}")


def test_map_derived_int64_min_wraps_like_numpy():
    """An int64 column's softsign takes |x| in wrapping int64 as np.abs
    does: at INT64_MIN |x| = INT64_MIN and the softsign is 1.0 (the card's
    kernel takes the int64 column as it is, for this)."""
    x = np.asarray([I64MIN, I64MIN + 1, I64MAX, -1, 0, 7], np.int64)
    a32 = np.asarray([1.5, -2.0, 0.0, 3e38, -0.0, 1.0], np.float32)
    with np.errstate(over="ignore"):
        cases = [(x, None), (a32, x), (a32.astype(np.float64), x), (x, x),
                 (x, a32)]
        for a, b in cases:
            ref = rdp.map_derived(a, b, impl="numpy")
            assert_bitwise(ref, dp.map_derived(tt(a), None if b is None else tt(b)),
                           f"{a.dtype} {None if b is None else b.dtype}")
    assert dp.map_derived(tt(x), None)[0].item() == 1.0


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("weighted", [False, True])
def test_fixed_point_encode_nan_inf_and_out_of_range(dtype, weighted):
    """Where rint(v * 2^16) is NaN or lies outside [-2^63, 2^63), numpy's
    int64 conversion (x86) gives INT64_MIN; -2^47 * 2^16 = -2^63 is in
    range and 2^47 * 2^16 = 2^63 is not."""
    v = np.asarray([np.nan, np.inf, -np.inf, 2.0**47, -2.0**47, 1.5e14,
                    -1.5e14, 3e38, 1.0], np.float64)
    if dtype is np.float64:
        v = np.concatenate([v, [1e300, -1e300, 2.0**47 - 2.0**-17]])
    v = v.astype(dtype)
    w = np.arange(-3, len(v) - 3, dtype=np.int64) if weighted else None
    with np.errstate(invalid="ignore", over="ignore"):
        ref = rdp.fixed_point_encode(v, w, impl="numpy")
    got = dp.fixed_point_encode(tt(v), None if w is None else tt(w))
    assert_bitwise(ref, got, f"encode {dtype}/{weighted}")
    if not weighted:
        assert got[:3].tolist() == [I64MIN] * 3 and got[4].item() == I64MIN


@pytest.mark.parametrize("impl", KERNEL_IMPLS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("weighted", [False, True])
def test_fixed_point_encode_at_quantum_boundary(impl, dtype, weighted):
    """Values on the half-quantum rounding boundary (half to even) and |w|>1
    weights, including products that wrap mod 2^64."""
    half = 0.5 / RT.AGG_QUANTUM
    rng = np.random.default_rng(17)
    v = np.concatenate([
        np.asarray([half, -half, 3 * half, 1.0 + half, 2.5 * half * 2,
                    123.456, 0.0, -0.0, 1000.0]),
        rng.standard_normal(2000) * 10,
    ]).astype(dtype)
    w = None
    if weighted:
        w = rng.integers(-3, 4, len(v)).astype(np.int64)
        w[:9] = [7, -7, 5, 1000, -3, 1 << 45, -(1 << 50), I64MAX, I64MIN]
    ref = ref_call(impl, rdp.fixed_point_encode, v, w)
    got = dp.fixed_point_encode(tt(v), None if w is None else tt(w))
    assert_bitwise(ref, got, f"encode {dtype}/{weighted}/{impl}")


def test_fixed_point_encode_int_values():
    v = np.asarray([0, 1, -5, 1 << 30], np.int64)
    assert_bitwise(rdp.fixed_point_encode(v, impl="numpy"),
                   dp.fixed_point_encode(tt(v)), "int values")


@pytest.mark.parametrize("impl", KERNEL_IMPLS)
@pytest.mark.parametrize("stable", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_group_reduce_bitwise(impl, stable, weighted):
    rng = np.random.default_rng(7)
    keys = rng.integers(0, 50, size=4000).astype(np.int64)
    vals = rng.normal(size=4000).astype(np.float32)
    cnt = rng.integers(-5, 5, size=4000).astype(np.int64)
    w = rng.integers(-3, 4, size=4000).astype(np.int64) if weighted else None
    cols = {"s": (vals, "fixed"), "count": (cnt, "int")}
    ref = ref_call(impl, rdp.group_reduce, keys, cols, w, stable=stable)
    got = dp.group_reduce(tt(keys), {k: (tt(v), kind) for k, (v, kind) in
                                     cols.items()},
                          None if w is None else tt(w), stable=stable)
    assert_bitwise(ref[0], got[0], "uniq")
    assert set(ref[1]) == set(got[1])
    for name in ref[1]:
        assert_bitwise(ref[1][name], got[1][name], name)
    assert_bitwise(ref[2], got[2], "counts")


@pytest.mark.parametrize("impl", KERNEL_IMPLS)
def test_first_occurrence_and_probe_bitwise(base, impl):
    rng = np.random.default_rng(int(base["key"][0]))
    right = base["key"][:800]
    ref_u, ref_f = ref_call(impl, rdp.first_occurrence, right)
    got_u, got_f = dp.first_occurrence(tt(right))
    assert_bitwise((ref_u, ref_f), (got_u, got_f), f"first/{impl}")
    probe = np.concatenate([
        base["key"],
        np.asarray([I64MAX, I64MIN, -1, ref_u[0], ref_u[-1],
                    ref_u[-1] + 1], np.int64),
        rng.integers(-10, 10_000, 500).astype(np.int64),
    ])
    ref = ref_call(impl, rdp.probe_sorted, ref_u, probe)
    assert_bitwise(ref, dp.probe_sorted(got_u, tt(probe)), f"probe/{impl}")


@pytest.mark.parametrize("impl", KERNEL_IMPLS)
def test_probe_index_holding_int64_max(impl):
    """A sentinel-valued real key: probes equal to INT64_MAX hit it, and
    probes past every key clip to the last position."""
    uniq = np.asarray([-7, 0, 5, 9, I64MAX], np.int64)
    probe = np.asarray([I64MAX, I64MAX - 1, I64MIN, 5, 6, 10, -8], np.int64)
    for n in (len(uniq), len(uniq) - 1, 1):
        ref = ref_call(impl, rdp.probe_sorted, uniq[:n], probe)
        assert_bitwise(ref, dp.probe_sorted(tt(uniq[:n]), tt(probe)),
                       f"n={n}/{impl}")


def test_empty_inputs_every_primitive():
    e64, ef32 = np.empty(0, np.int64), np.empty(0, np.float32)
    keys = np.asarray([3, 1, 2], np.int64)
    cases = [
        (rdp.hash64(e64), dp.hash64(tt(e64))),
        (rdp.partition_ids(e64, 4), dp.partition_ids(tt(e64), 4)),
        (rdp.partition_index(e64, 4), dp.partition_index(tt(e64), 4)),
        (rdp.filter_mask(ef32, 0.0), dp.filter_mask(tt(ef32), 0.0)),
        (rdp.map_derived(ef32, ef32), dp.map_derived(tt(ef32), tt(ef32))),
        (rdp.map_derived(ef32, None), dp.map_derived(tt(ef32), None)),
        (rdp.fixed_point_encode(ef32, e64),
         dp.fixed_point_encode(tt(ef32), tt(e64))),
        (rdp.first_occurrence(e64), dp.first_occurrence(tt(e64))),
        (rdp.probe_sorted(e64, keys), dp.probe_sorted(tt(e64), tt(keys))),
        (rdp.probe_sorted(keys, e64), dp.probe_sorted(tt(keys), tt(e64))),
    ]
    for i, (ref, got) in enumerate(cases):
        assert_bitwise(ref, got, f"case {i}")
    ref = rdp.group_reduce(e64, {"s": (ef32, "fixed")}, e64)
    got = dp.group_reduce(tt(e64), {"s": (tt(ef32), "fixed")}, tt(e64))
    assert_bitwise((ref[0], ref[1]["s"], ref[2]), (got[0], got[1]["s"], got[2]))
