"""The port's table operators and Z-set delta rules against the JAX
package's, bitwise.

Tables are made with numpy from a seed, fed to ``repro.mv.tableops`` as they
are and to ``repro_torch.mv.tableops`` as CPU tensors; every output table
must carry the same columns, dtypes, shapes and bytes. Deltas cover the four
update kinds (insert, update, delete, mixed) with |w| > 1 weights.
"""
import numpy as np
import pytest
import torch

from repro.mv import tableops as RT
from repro_torch.convert import table_from_numpy, table_to_numpy
from repro_torch.mv import tableops as T

SEEDS = [3, 11, 2026]
KINDS = ["insert", "update", "delete", "mixed"]


def tt(table):
    return table_from_numpy(table, "cpu")


def assert_same(ref, got, ctx=""):
    RT.assert_tables_bitwise(dict(ref), table_to_numpy(got), ctx)


def make_delta(base, kind, seed, n=400, key_mod=None):
    """A Z-set delta of one update kind over ``base`` (numpy)."""
    rng = np.random.default_rng(seed)
    cols = list(base)
    idx = np.sort(rng.choice(RT.n_rows(base), min(n, RT.n_rows(base)),
                             replace=False))
    retr = {k: np.asarray(base[k])[idx].copy() for k in cols}
    retr["weight"] = -rng.choice(np.asarray([1, 1, 2], np.int64), len(idx))
    if kind == "delete":
        return retr
    if kind == "update":  # same rids, fresh keys and payloads
        upd = {k: np.asarray(base[k])[idx].copy() for k in cols}
        upd["key"] = rng.integers(0, key_mod or 1000, len(idx)).astype(np.int64)
        for k in cols:
            if k not in ("key", "rid"):
                upd[k] = rng.standard_normal(len(idx)).astype(upd[k].dtype)
        upd["weight"] = -retr["weight"]
        return RT.concat_tables([retr, upd])
    ins = RT.make_base_table(
        n, len([k for k in cols if k != "rid"]), seed=seed + 1,
        key_mod=key_mod, rid_base=RT.make_rid_base(1, 0),
    )
    ins = {k: ins.get(k, np.zeros(n, np.asarray(base[k]).dtype)) for k in cols}
    ins["weight"] = rng.choice(np.asarray([1, 1, 2, 3], np.int64), n)
    if kind == "insert":
        return ins
    return RT.concat_tables([retr, ins])


@pytest.fixture(params=SEEDS)
def tables(request):
    seed = request.param
    base = RT.make_base_table(3000, 4, seed=seed, rid_base=0)
    right = RT.make_base_table(800, 3, seed=seed + 50, rid_base=1 << 40)
    return dict(seed=seed, base=base, right=right)


def test_make_base_table_bitwise():
    probs = np.full(40, 1 / 40)
    for kw in (dict(), dict(key_mod=7, rid_base=5 << 32),
               dict(key_probs=probs, rid_base=0)):
        assert_same(RT.make_base_table(500, 4, seed=9, **kw),
                    T.make_base_table(500, 4, seed=9, device="cpu", **kw),
                    str(kw))


@pytest.mark.parametrize("kind", KINDS)
def test_row_ops_bitwise_across_update_kinds(tables, kind):
    delta = make_delta(tables["base"], kind, tables["seed"])
    for src in (tables["base"], delta):
        for thr in (0.1, -0.3):
            assert_same(RT.op_filter(src, "c0", thr),
                        T.op_filter(tt(src), "c0", thr), f"filter/{kind}")
        assert_same(RT.op_project(src, 0.6), T.op_project(tt(src), 0.6),
                    f"project/{kind}")
        assert_same(RT.op_map(src), T.op_map(tt(src)), f"map/{kind}")
        assert_same(RT.op_agg(src), T.op_agg(tt(src)), f"agg/{kind}")
        one_col = {k: src[k] for k in src if k in ("key", "rid", "c0", "weight")}
        assert_same(RT.op_map(one_col), T.op_map(tt(one_col)), f"map1/{kind}")


def test_ops_after_aggregate_mixed_dtypes(tables):
    """Operators over AGG output (f64 sums, an int64 count) and over a join
    of a narrow projection with an aggregate (f32 beside f64): numpy's
    promotion in MAP, int64 compares in FILTER."""
    base, right = tables["base"], tables["right"]
    agg = RT.op_agg(base)
    narrow = RT.op_project(base, 0.6)
    mixed = RT.op_join(narrow, agg)
    for name, src in (("agg", agg), ("mixed", mixed),
                      ("count", {"key": agg["key"], "count": agg["count"]}),
                      ("agg2", RT.op_agg(RT.op_join(right, agg)))):
        assert_same(RT.op_map(src), T.op_map(tt(src)), f"map/{name}")
        assert_same(RT.op_filter(src, "none", -0.3),
                    T.op_filter(tt(src), "none", -0.3), f"filter/{name}")
        assert_same(RT.op_agg(src), T.op_agg(tt(src)), f"agg/{name}")
    assert_same(mixed, T.op_join(T.op_project(tt(base), 0.6), T.op_agg(tt(base))),
                "join")


@pytest.mark.parametrize("kind", KINDS)
def test_apply_consolidate_concat_bitwise(tables, kind):
    base, seed = tables["base"], tables["seed"]
    delta = make_delta(base, kind, seed)
    assert_same(RT.apply_delta(base, delta), T.apply_delta(tt(base), tt(delta)),
                f"apply/{kind}")
    assert_same(RT.consolidate_zset(delta), T.consolidate_zset(tt(delta)),
                f"consolidate/{kind}")
    assert_same(RT.materialize_delta(delta), T.materialize_delta(tt(delta)),
                f"materialize/{kind}")
    d2 = make_delta(base, "mixed", seed + 1)
    assert_same(RT.concat_tables([delta, d2]),
                T.concat_tables([tt(delta), tt(d2)]), f"concat/{kind}")
    assert RT.table_sizes(delta) == T.table_sizes(tt(delta))
    assert RT.weighted_nbytes(delta) == T.weighted_nbytes(tt(delta))


def test_apply_delta_duplicate_rids_and_pure_append():
    base = RT.make_base_table(200, 3, seed=1, rid_base=0)
    dup = RT.concat_tables([base, RT.take_rows(base, np.arange(0, 200, 3))])
    dup = {k: v[np.argsort(dup["rid"], kind="stable")] for k, v in dup.items()}
    retr = RT.with_weight(RT.take_rows(base, np.arange(0, 60, 3)), -2)
    assert_same(RT.apply_delta(dup, retr), T.apply_delta(tt(dup), tt(retr)),
                "duplicate rids")
    app = RT.make_base_table(50, 3, seed=2, rid_base=RT.make_rid_base(1, 0))
    assert_same(RT.apply_delta(base, app), T.apply_delta(tt(base), tt(app)),
                "append")
    norid = {k: v for k, v in base.items() if k != "rid"}
    app2 = {k: v for k, v in RT.with_weight(app, 2).items() if k != "rid"}
    assert_same(RT.apply_delta(norid, app2), T.apply_delta(tt(norid), tt(app2)),
                "no rid")


@pytest.mark.parametrize("kind", KINDS)
def test_union_and_agg_merge_bitwise(tables, kind):
    base, seed = tables["base"], tables["seed"]
    delta = make_delta(base, kind, seed)
    other = make_delta(base, "mixed", seed + 3)
    assert_same(RT.op_union(delta, other), T.op_union(tt(delta), tt(other)),
                f"union/{kind}")
    assert_same(RT.op_union(base, RT.strip_weight(other)),
                T.op_union(tt(base), T.strip_weight(tt(other))), "union/plain")
    ref = RT.merge_agg(RT.op_agg(base), RT.op_agg(delta))
    got = T.merge_agg(T.op_agg(tt(base)), T.op_agg(tt(delta)))
    assert_same(ref, got, f"merge/{kind}")
    assert_same(RT.op_agg(RT.apply_delta(base, delta)),
                T.op_agg(T.apply_delta(tt(base), tt(delta))), f"agg(full)/{kind}")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("key_mod", [None, 1 << 20])
def test_join_and_zset_join_delta_bitwise(tables, kind, key_mod):
    """``key_mod=2^20`` gives right deltas keys the old right side never
    had, driving the partial fallback; a callable ``left_old`` is invoked
    only when the fallback needs it."""
    base, right, seed = tables["base"], tables["right"], tables["seed"]
    ld = make_delta(base, kind, seed)
    rd = make_delta(right, kind, seed + 7, n=120, key_mod=key_mod)
    assert_same(RT.op_join(base, right), T.op_join(tt(base), tt(right)), "join")
    ref_stats, got_stats, calls = {}, {}, []
    ref, ref_corr = RT.zset_join_delta(base, ld, right, rd, stats=ref_stats)

    def left_old():
        calls.append(1)
        return tt(base)

    got, got_corr = T.zset_join_delta(left_old, tt(ld), tt(right), tt(rd),
                                      stats=got_stats)
    assert got_corr == ref_corr and got_stats == ref_stats
    assert len(calls) == (1 if ref_stats["affected_keys"] else 0)
    assert_same(ref, got, f"join-delta/{kind}")
    assert RT.join_delta_is_appendable(right["key"], rd) == \
        T.join_delta_is_appendable(tt(right)["key"], tt(rd))


def test_empty_and_all_tombstone_inputs():
    empty = RT.empty_like({"key": np.int64, "rid": np.int64,
                           "c0": np.float32, "weight": np.int64})
    got_empty = T.empty_like(T.table_schema(tt(empty)), device="cpu")
    for name, fn in (("filter", lambda m, t: m.op_filter(t, "c0", 0.0)),
                     ("map", lambda m, t: m.op_map(t)),
                     ("agg", lambda m, t: m.op_agg(t))):
        assert_same(fn(RT, empty), fn(T, got_empty), f"empty {name}")
    base = RT.make_base_table(100, 3, seed=1, rid_base=0)
    ref, corr = RT.zset_join_delta(base, empty, base, empty)
    got, gcorr = T.zset_join_delta(tt(base), got_empty, tt(base), got_empty)
    assert corr == gcorr == 0
    assert_same(ref, got, "empty join delta")
    tomb = make_delta(RT.make_base_table(500, 4, seed=9, rid_base=0),
                      "delete", 9)
    for name, fn in (("filter", lambda m, t: m.op_filter(t, "c0", 0.0)),
                     ("map", lambda m, t: m.op_map(t)),
                     ("agg", lambda m, t: m.op_agg(t))):
        assert_same(fn(RT, tomb), fn(T, tt(tomb)), f"tombstone {name}")


def test_large_weights_at_quantum_boundary():
    half = 0.5 / RT.AGG_QUANTUM
    vals = np.asarray([half, -half, 3 * half, 1.0 + half, 123.456], np.float64)
    t = {"key": np.arange(5, dtype=np.int64), "v": vals,
         "weight": np.asarray([7, -7, 5, 1000, -3], np.int64)}
    t_neg = dict(t, weight=-t["weight"])
    assert_same(RT.op_agg(t), T.op_agg(tt(t)), "agg")
    merged = T.merge_agg(T.op_agg(tt(t)), T.op_agg(tt(t_neg)))
    assert_same(RT.merge_agg(RT.op_agg(t), RT.op_agg(t_neg)), merged, "merge")
    assert T.n_rows(merged) == 0


def test_live_rows_cache_weakref_eviction():
    d = T.with_weight(T.make_base_table(1000, 3, seed=2, rid_base=0,
                                        device="cpu"), 2)
    phys, weighted = T.table_sizes(d)
    assert (phys, weighted) == (T.table_nbytes(d), T.weighted_nbytes(d))
    key = id(d["weight"])
    assert key in T._LIVE_ROWS_CACHE
    del d
    assert key not in T._LIVE_ROWS_CACHE


def test_assert_tables_bitwise_sees_negative_zero():
    a = {"x": torch.tensor([0.0, 1.0])}
    b = {"x": torch.tensor([-0.0, 1.0])}
    T.assert_tables_bitwise(a, {"x": a["x"].clone()})
    with pytest.raises(AssertionError):
        T.assert_tables_bitwise(a, b)
