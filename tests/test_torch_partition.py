"""Hash-partitioned refresh in the port against the JAX package, bitwise.

Tables and Z-set deltas are made with numpy from a seed and handed to
``repro.mv.partition`` as they are and to ``repro_torch.mv.partition`` as
CPU tensors (the plain versions of the ``hash64`` and ``pid_hist``
kernels). The reference's split also runs with its Pallas ``pid_hist``
kernel in interpret mode. Scenarios run in both packages from the same
seeds: per-round plans, statuses, JOIN fallbacks and pruned partitions must
agree, and every stored entry must be bitwise equal (tolerance 0).
"""
import shutil
import tempfile
from pathlib import Path

import numpy as np
import pytest

import repro.core as rc
import repro.mv as rmv
from repro.mv import dataplane as rdp
from repro.mv import partition as RP
from repro.mv import tableops as RT
import repro_torch.core as pc
import repro_torch.mv as pmv
from repro_torch.convert import table_from_numpy, table_to_numpy
from repro_torch.mv import partition as PP
from repro_torch.mv import tableops as T

SEEDS = [3, 11, 2026]
KINDS = {
    "insert": dict(ingest_frac=0.25, n_rounds=2),
    "mixed": dict(ingest_frac=0.15, update_frac=0.15, delete_frac=0.1,
                  n_rounds=2),
}
CM_KW = dict(disk_read_bw=50e6, disk_write_bw=50e6, mem_read_bw=1e12,
             mem_write_bw=1e12, disk_latency=0.0)
RCM, PCM = rc.CostModel(**CM_KW), pc.CostModel(**CM_KW)


def tt(table):
    return table_from_numpy(table, "cpu")


def assert_same(ref, got, ctx=""):
    RT.assert_tables_bitwise(dict(ref), table_to_numpy(got), ctx)


def zset_delta(old, seed, n_ins=12, n_upd=10, n_del=8, key_mod=16):
    """A Z-set delta over ``old`` (numpy): retract+reinsert pairs for
    updates (same rid, fresh key and values), bare retractions for deletes,
    fresh rows for inserts — the shape ``realize_workload`` deltas take."""
    rng = np.random.default_rng(seed)
    n_old = RT.n_rows(old)
    perm = rng.permutation(n_old)
    del_idx, upd_idx = np.sort(perm[:n_del]), np.sort(perm[n_del:n_del + n_upd])
    retract = np.sort(np.concatenate([del_idx, upd_idx]))
    upd = {k: np.asarray(v)[upd_idx].copy() for k, v in old.items()}
    upd["key"] = rng.integers(0, key_mod, n_upd).astype(np.int64)
    for k in upd:
        if k not in ("key", "rid"):
            upd[k] = rng.standard_normal(n_upd).astype(np.float32)
    ins = RT.make_base_table(n_ins, len(old) - 1, seed=seed + 1, key_mod=key_mod,
                             rid_base=RT.make_rid_base(1, 0))
    parts = [RT.with_weight(RT.take_rows(old, retract), -1),
             RT.with_weight(upd, +1), RT.with_weight(ins, +1)]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


@pytest.fixture(params=SEEDS)
def base(request):
    return RT.make_base_table(600, 4, seed=request.param, key_mod=40,
                              rid_base=RT.make_rid_base(0, 0))


# ---------------------------------------------------------------------------
# hashing, splitting, reassembly
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["numpy", "interpret"])
@pytest.mark.parametrize("P", [1, 2, 8, 13])
def test_partition_table_and_partition_of_bitwise(base, impl, P):
    """The split of every column, partition by partition, and each row's
    partition id; the reference under ``impl`` (its Pallas ``pid_hist``
    kernel in interpret mode, or numpy)."""
    with rdp.use_impl(impl):
        ref_parts = RP.partition_table(base, P)
        ref_pid = RP.partition_of(base["key"], P)
    got_parts = PP.partition_table(tt(base), P)
    assert len(got_parts) == len(ref_parts) == P
    for p, (r, g) in enumerate(zip(ref_parts, got_parts)):
        assert_same(r, g, f"P={P} partition {p}")
    got_pid = PP.partition_of(tt(base)["key"], P)
    assert np.asarray(ref_pid).tobytes() == got_pid.numpy().tobytes()
    assert_same(RP.concat_partitions(ref_parts), PP.concat_partitions(got_parts))


@pytest.mark.parametrize("P", [2, 8])
def test_partitions_are_views_of_one_grouped_tensor(base, P):
    parts = PP.partition_table(tt(base), P)
    storages = {p["key"].untyped_storage().data_ptr() for p in parts}
    assert len(storages) == 1


def test_canonical_order_rid_key_and_neither(base):
    agg = RT.op_agg(base)
    shuffled = RT.take_rows(agg, np.random.default_rng(1).permutation(RT.n_rows(agg)))
    no_meta = {"c0": np.asarray(base["c0"])}
    for table in (base, RT.take_rows(base, np.arange(RT.n_rows(base))[::-1].copy()),
                  shuffled, no_meta):
        assert_same(RP.canonical_order(table), PP.canonical_order(tt(table)))


def test_concat_partitions_of_uneven_and_empty_parts(base):
    parts = [RT.take_rows(base, np.arange(0, 600, 3)),
             RT.take_rows(base, np.arange(0, 0)),
             RT.take_rows(base, np.arange(1, 600, 3)),
             RT.take_rows(base, np.arange(2, 600, 3))]
    assert_same(RP.concat_partitions(parts),
                PP.concat_partitions([tt(p) for p in parts]))
    with pytest.raises(ValueError):
        PP.concat_partitions([])


@pytest.mark.parametrize("P", [1, 2, 8])
def test_dirty_partitions_bitwise(base, P):
    delta = zset_delta(base, int(base["key"][0]))
    assert RP.dirty_partitions(delta, P) == PP.dirty_partitions(tt(delta), P)
    empty = {k: v[:0] for k, v in delta.items()}
    assert RP.dirty_partitions(empty, P) == PP.dirty_partitions(tt(empty), P) == []


@pytest.mark.parametrize("P", [2, 8])
def test_zset_delta_routing_and_routed_apply_match_reference(base, P):
    """The routed pieces of a Z-set delta (retractions on their victim's
    partition), the dirty set, and per-partition ``apply_delta`` reassembled
    in canonical order — each as the reference computes it."""
    seed = int(base["rid"][0] + base["key"][1])
    delta = zset_delta(base, seed + 5)
    ref_old, ref_delta = RP.partition_table(base, P), RP.partition_table(delta, P)
    got_old = PP.partition_table(tt(base), P)
    got_delta = PP.partition_table(tt(delta), P)
    for p in range(P):
        assert_same(ref_old[p], got_old[p], f"old {p}")
        assert_same(ref_delta[p], got_delta[p], f"delta {p}")
    assert RP.dirty_partitions(delta, P) == PP.dirty_partitions(tt(delta), P)
    ref = RP.concat_partitions(
        [RT.apply_delta(o, d) for o, d in zip(ref_old, ref_delta)])
    got = PP.concat_partitions(
        [T.apply_delta(o, d) for o, d in zip(got_old, got_delta)])
    assert_same(ref, got, "routed apply")
    assert_same(RT.apply_delta(base, delta), got, "routed apply vs whole")


# ---------------------------------------------------------------------------
# workload expansion
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("P", [1, 4])
@pytest.mark.parametrize("skew", [0.0, 1.0])
def test_partition_workload_and_update_spec_expansion(P, skew):
    shares = None if skew == 0.0 else rc.partition_shares(P, skew=skew, seed=2)
    ref, rmap = RP.partition_workload(rmv.generate_workload(12, seed=4), P, shares)
    got, gmap = PP.partition_workload(pmv.generate_workload(12, seed=4), P, shares)
    assert ref.name == got.name and ref.meta == got.meta
    assert (rmap.base_names, rmap.n_partitions) == (gmap.base_names, gmap.n_partitions)
    for a, b in zip(ref.nodes, got.nodes):
        assert (a.name, a.parents, a.op, a.size, a.compute, a.base_read) == \
            (b.name, b.parents, b.op, b.size, b.compute, b.base_read)
    for v in range(len(rmap.base_names)):
        assert rmap.partition_names(v) == gmap.partition_names(v)
    spec_kw = dict(ingest=(0, 2), ingest_frac=0.2)
    assert RP.expand_update_spec(rmv.UpdateSpec(**spec_kw), rmap).ingest == \
        PP.expand_update_spec(pmv.UpdateSpec(**spec_kw), gmap).ingest


def test_scan_router_shares_one_split_across_partitions():
    wl = pmv.realize_workload(pmv.generate_workload(6, seed=2),
                              bytes_per_root=1 << 12, device="cpu")
    pwl, pmap = PP.partition_workload(wl, 4)
    scan = next(v for v, n in enumerate(wl.nodes) if not n.parents)
    spec = pmv.UpdateSpec(ingest_frac=0.2)
    first = pwl.nodes[pmap.expanded_index(scan, 0)].delta_fn(1, spec)
    again = pwl.nodes[pmap.expanded_index(scan, 0)].delta_fn(1, spec)
    assert first is again  # memoized for the round, not recomputed
    whole = wl.nodes[scan].delta_fn(1, spec)
    parts = [pwl.nodes[pmap.expanded_index(scan, p)].delta_fn(1, spec)
             for p in range(4)]
    T.assert_tables_bitwise(PP.concat_partitions(parts),
                            PP.canonical_order(whole), "router")


# ---------------------------------------------------------------------------
# scenarios: the reference's acceptance matrix, package against package
# ---------------------------------------------------------------------------

def run_both(tmp, gen_seed, kind, P, k, planner="auto", **real_kw):
    out = {}
    for pkg, mv, cm, dk in (("ref", rmv, RCM, {}),
                            ("port", pmv, PCM, {"device": "cpu"})):
        wl = mv.realize_workload(mv.generate_workload(8, seed=gen_seed),
                                 bytes_per_root=1 << 12, **real_kw, **dk)
        budget = sum(n.size for n in wl.nodes) * 0.4
        store = mv.DiskStore(tmp / f"{pkg}_{kind}_p{P}k{k}", **dk)
        rep = mv.run_partitioned_scenario(
            wl, P, store, budget, mv.UpdateSpec(mode="incremental", **KINDS[kind]),
            cm, n_compute_workers=k, planner=planner)
        out[pkg] = dict(wl=wl, store=store, rep=rep, budget=budget)
    return out


def assert_same_scenario(out):
    ref, port = out["ref"], out["port"]
    assert len(ref["rep"].rounds) == len(port["rep"].rounds)
    for a, b in zip(ref["rep"].rounds, port["rep"].rounds):
        ctx = f"round {a.round_idx}"
        assert a.plan.order == b.plan.order, ctx
        assert a.plan.flagged == b.plan.flagged, ctx
        assert a.statuses == b.statuses, ctx
        assert a.join_fallbacks == b.join_fallbacks, ctx
        assert a.run.skipped == b.run.skipped, ctx
        if a.run.n_workers == 1:  # with k > 1 the peak depends on timing
            assert a.run.peak_catalog_bytes == b.run.peak_catalog_bytes, ctx
        assert b.run.peak_catalog_bytes <= port["budget"], ctx
    assert ref["store"].manifest() == port["store"].manifest()
    for name in ref["store"].manifest():
        assert_same(ref["store"].read(name), port["store"].read(name), name)


@pytest.fixture
def tmp():
    path = Path(tempfile.mkdtemp(prefix="torch_part_"))
    yield path
    shutil.rmtree(path, ignore_errors=True)


@pytest.mark.parametrize("seed", [3])
@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("P", [1, 2, 8])
@pytest.mark.parametrize("k", [1, 2])
def test_scenario_matrix_bitwise_vs_reference(tmp, seed, kind, P, k):
    out = run_both(tmp, seed, kind, P, k)
    assert_same_scenario(out)
    # and the port's partitioned store reassembles to its own unpartitioned
    # full recompute
    port = out["port"]
    full = pmv.DiskStore(tmp / "full", device="cpu")
    pmv.run_scenario(port["wl"], full, port["budget"],
                     pmv.UpdateSpec(mode="full", **KINDS[kind]), PCM)
    if P == 1:
        pmv.verify_scenario_equivalence(port["wl"], port["store"], full)
    else:
        pmv.verify_partitioned_equivalence(port["wl"], port["store"], P, full)


@pytest.mark.parametrize("planner", ["flat", "hierarchical"])
def test_planners_and_skewed_keys_bitwise_vs_reference(tmp, planner):
    out = run_both(tmp, 7, "mixed", 8, 2, planner=planner, key_skew=1.2, seed=7)
    assert_same_scenario(out)
    assert any("@p" in out["port"]["rep"].workload.nodes[v].name
               for r in out["port"]["rep"].rounds for v in r.plan.flagged)


def test_clean_partitions_pruned_as_in_reference(tmp):
    out = {}
    for pkg, mv, cm, dk in (("ref", rmv, RCM, {}),
                            ("port", pmv, PCM, {"device": "cpu"})):
        wl = mv.realize_workload(mv.generate_workload(6, seed=13),
                                 bytes_per_root=1 << 12, key_mod=12, **dk)
        budget = sum(n.size for n in wl.nodes) * 0.5
        spec = mv.UpdateSpec(mode="incremental", ingest_frac=0.02, n_rounds=2)
        out[pkg] = mv.run_partitioned_scenario(
            wl, 8, mv.DiskStore(tmp / pkg, **dk), budget, spec, cm)
    skipped = [r.run.skipped for r in out["port"].rounds]
    assert skipped == [r.run.skipped for r in out["ref"].rounds]
    assert any("@p" in name for names in skipped[1:] for name in names)


def test_each_package_reads_the_others_partitioned_store(tmp):
    out = run_both(tmp, 11, "mixed", 8, 1)
    ref_store = rmv.DiskStore(out["port"]["store"].root)
    port_store = pmv.DiskStore(out["ref"]["store"].root, device="cpu")
    for node in out["port"]["wl"].nodes:
        want = out["ref"]["store"].read_partitioned(node.name)
        assert_same(want, port_store.read_partitioned(node.name), node.name)
        RT.assert_tables_bitwise(want, ref_store.read_partitioned(node.name),
                                 node.name)
        assert_same(want, out["port"]["store"].read_partitioned(node.name))
