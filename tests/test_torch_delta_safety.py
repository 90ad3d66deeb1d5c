"""The port's static checks over the operator IR (``repro_torch.analysis``:
``delta_safety``, ``mqo_check`` and the MQO fixtures) against the JAX
package's.

Each hand-built IR is built in both packages from the same nodes; realized
workloads come from the same seeds (the port's on the CPU). Findings must be
equal as (rule, level, path, node, message), in order, and the rule
coverage of ``tests/analysis/test_delta_safety.py`` holds in the port.
"""
import dataclasses as dc

import numpy as np
import pytest

import repro.mv as rmv
from repro.analysis import delta_safety as RD
from repro.analysis import fixtures as RF
from repro.analysis import mqo_check as RQ
from repro.mv import ir as rir
from repro.mv import mqo as rmqo
import repro_torch.mv as pmv
from repro_torch.analysis import delta_safety as D
from repro_torch.analysis import fixtures as F
from repro_torch.analysis import gating
from repro_torch.analysis import mqo_check as Q
from repro_torch.mv import ir as mvir
from repro_torch.mv.tableops import AGG_QUANTUM

SCAN4 = (("key", "<i8"), ("rid", "<i8"), ("c0", "<f4"), ("c1", "<f4"), ("c2", "<f4"))
RIDLESS = (("key", "<i8"), ("c0", "<f4"))


def rows(findings):
    return [(f.rule, f.level, f.path, f.symbol, f.message) for f in findings]


def rules(findings):
    return {f.rule for f in findings}


def both(nodes, **ir_kw):
    """The same IR in both packages: ``nodes`` are (name, op, parents,
    schema columns or None, size, lifted)."""
    out = []
    for ir_mod in (rir, mvir):
        out.append(ir_mod.ViewIR(tuple(
            ir_mod.OpNode(name=n, op=op, parents=tuple(p),
                          schema=None if s is None else ir_mod.Schema(s),
                          size=size, lifted=lifted)
            for n, op, p, s, size, lifted in nodes), **ir_kw))
    return out


def check_both(nodes, **kw):
    ref_ir, port_ir = both(nodes)
    got = D.check_ir(port_ir, **kw)
    assert rows(got) == rows(RD.check_ir(ref_ir, **kw))
    return got


def test_every_engine_op_has_the_references_delta_rule():
    assert D.DELTA_RULES == RD.DELTA_RULES
    assert set(D.DELTA_RULES) == {"SCAN", "FILTER", "PROJECT", "MAP", "JOIN",
                                  "UNION", "AGG"}


def test_unknown_op_is_weight_closure_error():
    got = check_both([("src", "SCAN", (), SCAN4, 1e4, True),
                      ("w", "WINDOW", (0,), SCAN4, 1e4, True)])
    assert any(f.rule == "weight-closure" and f.level == "error" and f.symbol == "w"
               for f in got)


def test_unlifted_node_is_opaque_view_warning():
    got = check_both([("src", "SCAN", (), SCAN4, 1e4, True),
                      ("m", "MAP", (0,), SCAN4, 1e4, False)])
    assert "opaque-view" in rules(got)


def test_rid_stability_infos():
    nodes = [("a", "SCAN", (), SCAN4, 1e4, True), ("b", "SCAN", (), RIDLESS, 1e4, True),
             ("j", "JOIN", (1, 0), RIDLESS, 1e4, True),
             ("u", "UNION", (0, 1), SCAN4, 1e4, True)]
    got = check_both(nodes, retractions=True)
    assert {"join-ridless-left", "union-ridless-input", "ridless-retraction"} <= rules(got)
    assert not gating([f for f in got if f.rule != "opaque-view"])


@pytest.mark.parametrize("retractions", [False, True])
def test_ridless_retraction_needs_retracting_mix(retractions):
    got = check_both([("a", "SCAN", (), SCAN4, 1e4, True),
                      ("p", "PROJECT", (0,), RIDLESS, 1e4, True)],
                     retractions=retractions)
    assert ("ridless-retraction" in rules(got)) == retractions


def test_agg_overflow_warning_then_error():
    n_rows = 1e6
    nodes = [("src", "SCAN", (), SCAN4, n_rows * 28, True),
             ("agg", "AGG", (0,), RIDLESS, 1e4, True)]
    ref_ir, port_ir = both(nodes)
    assert np.isclose(D.est_rows(port_ir.nodes[0]), n_rows)
    assert D.est_rows(port_ir.nodes[0]) == RD.est_rows(ref_ir.nodes[0])
    assert "agg-overflow" not in rules(check_both(nodes, value_scale=64.0))
    warn_scale = (2.0 ** 62) / (n_rows * AGG_QUANTUM) * 1.5
    warn = [f for f in check_both(nodes, value_scale=warn_scale) if f.rule == "agg-overflow"]
    assert [f.level for f in warn] == ["warning"]
    err = [f for f in check_both(nodes, value_scale=warn_scale * 2)
           if f.rule == "agg-overflow"]
    assert [f.level for f in err] == ["error"]


@pytest.mark.parametrize("ingest,fires", [({0}, False), ({1}, True), (None, True)])
def test_join_fallback_reachability_requires_dirty_probe_side(ingest, fires):
    got = check_both([("a", "SCAN", (), SCAN4, 1e4, True),
                      ("b", "SCAN", (), SCAN4, 1e4, True),
                      ("j", "JOIN", (0, 1), SCAN4, 1e4, True)],
                     ingest=None if ingest is None else frozenset(ingest))
    assert ("join-fallback-reachable" in rules(got)) == fires


def test_agg_downstream_full_only_with_consumers():
    nodes = [("src", "SCAN", (), SCAN4, 1e4, True), ("agg", "AGG", (0,), RIDLESS, 1e4, True),
             ("m", "MAP", (1,), RIDLESS, 1e4, True)]
    got = check_both(nodes)
    assert [f.symbol for f in got if f.rule == "agg-downstream-full"] == ["agg"]
    assert "agg-downstream-full" not in rules(check_both(nodes[:2]))


def test_untyped_ir_skips_schema_passes():
    got = check_both([("a", "SCAN", (), None, 1e4, True), ("m", "MAP", (0,), None, 1e4, True)])
    assert got == []


@pytest.mark.parametrize("seed", [3, 11])
@pytest.mark.parametrize("mix", ["none", "insert", "retracting"])
def test_realized_workload_findings_match_reference(tmp_path, seed, mix):
    ref = rmv.calibrate_sizes(
        rmv.realize_workload(rmv.generate_workload(n_nodes=10, seed=seed),
                             bytes_per_root=1 << 13),
        rmv.DiskStore(tmp_path / "ref"))
    port = pmv.calibrate_sizes(
        pmv.realize_workload(pmv.generate_workload(n_nodes=10, seed=seed),
                             bytes_per_root=1 << 13, device="cpu"),
        pmv.DiskStore(tmp_path / "port", device="cpu"))
    spec_kw = {"none": None, "insert": dict(ingest_frac=0.2),
               "retracting": dict(ingest_frac=0.2, update_frac=0.1, delete_frac=0.05)}[mix]
    r_spec = None if spec_kw is None else rmv.UpdateSpec(**spec_kw)
    p_spec = None if spec_kw is None else pmv.UpdateSpec(**spec_kw)
    r_ir, r_found = RD.analyze_workload(ref, spec=r_spec)
    ir, found = D.analyze_workload(port, spec=p_spec, device="cpu")
    assert ir.n == len(port.nodes)
    assert rows(found) == rows(r_found)
    assert [n.schema.columns for n in ir.nodes] == [n.schema.columns for n in r_ir.nodes]
    assert not gating(found)
    assert all(f.path == f"ir:{port.name}" for f in found)


# ---------------------------------------------------------------------------
# MQO merge soundness
# ---------------------------------------------------------------------------

def test_forged_threshold_merge_fires_unsound_merge():
    forged = F.forged_threshold_merge(device="cpu")
    ref = RF.forged_threshold_merge()
    for field in ("fingerprints", "rep_of", "keep", "name_map", "shared", "classes"):
        assert getattr(forged, field) == getattr(ref, field), field
    got = Q.check_merged(forged, device="cpu")
    assert rows(got) == rows(RQ.check_merged(ref))
    assert any(f.rule == "unsound-merge" and f.level == "error" for f in got)


def test_genuine_shared_prefix_merge_is_quiet():
    honest = F.genuine_shared_prefix_merge(device="cpu")
    assert honest.shared == RF.genuine_shared_prefix_merge().shared == (
        "v0_filter", "v0_join")
    assert Q.check_merged(honest, device="cpu") == []


@pytest.mark.parametrize("n_views", [2, 3, 4])
def test_check_merged_on_realized_merges_matches_reference(tmp_path, n_views):
    ref = rmqo.merge_workload(rmv.realize_workload(
        rmqo.shared_prefix_workload(n_views=n_views), bytes_per_root=1 << 13, seed=5))
    port = pmv.merge_workload(pmv.realize_workload(
        pmv.shared_prefix_workload(n_views=n_views), bytes_per_root=1 << 13, seed=5,
        device="cpu"), device="cpu")
    for retractions in (False, True):
        got = Q.check_merged(port, retractions=retractions, device="cpu")
        assert rows(got) == rows(RQ.check_merged(ref, retractions=retractions)) == []


def test_opaque_member_in_a_claimed_class_is_opaque_merge():
    """A merge whose claimed class holds an unliftable closure: both
    packages report ``opaque-merge`` (and the downstream unsound class)
    the same way."""
    def tamper(merged):
        def opaque(inputs):
            return inputs[0]

        nodes = [dc.replace(n, fn=opaque) if n.name == "v1_filter" else n
                 for n in merged.source.nodes]
        return dc.replace(merged, source=dc.replace(merged.source, nodes=nodes))

    ref = tamper(rmqo.merge_workload(rmv.realize_workload(
        rmqo.shared_prefix_workload(n_views=2), bytes_per_root=1 << 13)))
    port = tamper(pmv.merge_workload(pmv.realize_workload(
        pmv.shared_prefix_workload(n_views=2), bytes_per_root=1 << 13, device="cpu"),
        device="cpu"))
    got = Q.check_merged(port, device="cpu")
    assert rows(got) == rows(RQ.check_merged(ref))
    # the filter's class is opaque; the join's members then read different
    # inputs, so its class no longer holds either
    assert [(f.rule, f.symbol) for f in got] == [("opaque-merge", "v0_filter"),
                                                 ("unsound-merge", "v0_join")]
