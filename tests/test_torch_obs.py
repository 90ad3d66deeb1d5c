"""The port's observability layer (``repro_torch.obs``: trace, metrics,
audit, export) and ``tools/sc_trace_torch.py`` against the JAX package's.

The recorder's contracts of ``tests/obs/test_obs.py`` are held in the port
(its engine, simulator and scenarios emit the spans, on the CPU). Export
and audit run in both packages on the same span list and report: Chrome
documents, validation problems, summaries, real-vs-sim diffs, overlays and
audit rows must be equal. Scenarios traced in each package from the same
seed must agree on every audit field that timing does not decide.
"""
import dataclasses as dc
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import repro.core as rc
import repro.mv as rmv
from repro.obs import trace as rtr
from repro.obs.audit import audit_scenario as r_audit_scenario
from repro.obs import export as RE
import repro_torch.core as pc
import repro_torch.mv as pmv
from repro_torch.obs import METRICS, MetricsRegistry, trace as tr
from repro_torch.obs import export as E
from repro_torch.obs.audit import audit_scenario

ROOT = Path(__file__).resolve().parents[1]
TOOL = ROOT / "tools" / "sc_trace_torch.py"
CM_KW = dict(disk_read_bw=50e6, disk_write_bw=50e6, mem_read_bw=1e12,
             mem_write_bw=1e12, disk_latency=0.0)
RCM, PCM = rc.CostModel(**CM_KW), pc.CostModel(**CM_KW)
TIMING_FREE = ("mv", "partition", "round", "flagged", "predicted_s", "hits",
               "resident_bytes", "overflowed", "wasted")


@pytest.fixture(autouse=True)
def _clean_trace():
    """Every test starts and ends with tracing off and buffers empty, in
    both packages."""
    for t in (tr, rtr):
        t.enable(False)
        t.clear()
    METRICS.clear()
    yield
    for t in (tr, rtr):
        t.enable(False)
        t.clear()
    METRICS.clear()


def build(tmp_path, mv=pmv, n_nodes=10, seed=3, bytes_per_root=1 << 14):
    kw = {"device": "cpu"} if mv is pmv else {}
    wl = mv.realize_workload(mv.generate_workload(n_nodes=n_nodes, seed=seed),
                             bytes_per_root=bytes_per_root, **kw)
    return mv.calibrate_sizes(wl, mv.DiskStore(tmp_path / f"calib_{mv.__name__}", **kw))


def traced_scenario(tmp_path, mv=pmv, n_rounds=2, k=2, **spec_kw):
    """A traced incremental scenario in ``mv``: (workload, report, spans)."""
    kw = {"device": "cpu"} if mv is pmv else {}
    t = tr if mv is pmv else rtr
    wl = build(tmp_path, mv)
    spec = mv.UpdateSpec(mode="incremental", n_rounds=n_rounds,
                         **(spec_kw or dict(ingest_frac=0.2)))
    budget = sum(n.size for n in wl.nodes) * 0.5
    t.enable(True)
    rep = mv.run_scenario(wl, mv.DiskStore(tmp_path / f"run_{mv.__name__}", **kw),
                          budget, spec, PCM if mv is pmv else RCM, n_compute_workers=k)
    spans = t.drain()
    t.enable(False)
    return wl, spec, budget, rep, spans


def to_ref(spans):
    return [rtr.Span(*s) for s in spans]


# ---------------------------------------------------------------------------
# recorder basics
# ---------------------------------------------------------------------------

def test_disabled_fast_path_is_allocation_free_and_silent():
    assert not tr.enabled()
    a = tr.span("compute", "mv1")
    b = tr.span("io.read", "mv2", 123.0)
    assert a is b
    with a as ctx:
        ctx.set(nbytes=5.0)
    tr.record("compute", "mv1", 0.0, 1.0)
    tr.instant("admit", "mv1", 10.0)
    tr.counter("catalog.bytes", 42.0)
    assert tr.drain() == []


def test_enabled_recording_round_context_and_entry_parsing():
    tr.enable(True)
    tr.set_round(7)
    tr.record("compute", "mv3@p2", 1.0, 0.5, nbytes=64.0, worker="w0")
    with tr.span("io.read", "mv1") as sp:
        sp.set(nbytes=32.0)
    spans = tr.drain()
    assert len(spans) == 2
    s = spans[0]
    assert (s.cat, s.name, s.mv, s.partition) == ("compute", "mv3@p2", "mv3", 2)
    assert s.round == 7 and s.worker == "w0" and s.track == "real"
    assert spans[1].nbytes == 32.0 and spans[1].dur >= 0.0
    assert tr.split_entry("mv10") == ("mv10", -1)
    assert tr.split_entry("mv1@p15") == ("mv1", 15)
    assert tr.drain() == []
    assert tr.Span._fields == rtr.Span._fields


def test_sim_offset_accumulates_and_resets_on_clear():
    tr.set_sim_offset(12.5)
    assert tr.sim_offset() == 12.5
    tr.clear()
    assert tr.sim_offset() == 0.0


def test_metrics_registry_counters_gauges_histograms(tmp_path):
    m = MetricsRegistry()
    m.inc("bytes_read", 100.0, entry="mv1")
    m.inc("bytes_read", 50.0, entry="mv1")
    m.inc("bytes_read", 10.0, entry="mv2")
    m.gauge("catalog_used_bytes", 77.0)
    m.observe("round_wall_s", 0.5)
    m.observe("round_wall_s", 2.0)
    assert m.counter_family("bytes_read") == {"mv1": 150.0, "mv2": 10.0}
    snap = m.snapshot()
    assert snap["gauges"]["catalog_used_bytes"][""] == 77.0
    h = snap["histograms"]["round_wall_s"][""]
    assert h["count"] == 2 and h["min"] == 0.5 and h["max"] == 2.0
    p = m.export_json(tmp_path / "metrics.json")
    assert json.loads(p.read_text())["counters"]["bytes_read"]["mv1"] == 150.0


# ---------------------------------------------------------------------------
# engine integration: spans, timeline, entry stats
# ---------------------------------------------------------------------------

def solved_run(tmp_path):
    wl = build(tmp_path)
    g = wl.to_graph(PCM)
    budget = sum(g.sizes) * 0.4
    plan = pc.solve(g, budget=budget, n_workers=2)
    assert plan.flagged
    tr.enable(True)
    rep = pmv.Controller(wl, pmv.DiskStore(tmp_path / "run", device="cpu"), budget,
                         n_compute_workers=2).run(plan)
    return wl, plan, rep, tr.drain()


def test_traced_run_emits_spans_and_wall_clock_timeline(tmp_path):
    wl, _, rep, spans = solved_run(tmp_path)
    cats = {s.cat for s in spans}
    assert {"task", "compute", "round", "write.behind", "admit", "release",
            "counter", "io.write"} <= cats
    assert len(rep.timeline) == len(rep.executed)
    assert {n for n, _, _ in rep.timeline} == set(rep.executed)
    done = {name: end for name, _, end in rep.timeline}
    by_name = {n.name: n for n in wl.nodes}
    for name, start, end in rep.timeline:
        assert 0.0 <= start <= end
        for p in by_name[name].parents:
            assert start >= done[wl.nodes[p].name] - 1e-9
    assert rep.entry_stats
    assert sum(es["hits"] for es in rep.entry_stats.values()) == rep.catalog_hits
    assert {s.round for s in spans} == {0}
    frame = [s for s in spans if s.cat == "round"]
    assert len(frame) == 1
    lo, hi = frame[0].ts, frame[0].ts + frame[0].dur
    for s in spans:
        if s.cat != "counter":
            assert lo - 1e-6 <= s.ts and s.ts + s.dur <= hi + 1e-6


def test_sim_track_shares_schema_and_overlays_real(tmp_path):
    wl, plan, rep, real_spans = solved_run(tmp_path)
    tr.enable(True)
    sim = pmv.simulate(wl, plan, PCM, mode="sc", n_workers=2)
    sim_spans = tr.drain()
    assert {s.track for s in real_spans} == {"real"}
    assert {s.track for s in sim_spans} == {"sim"}
    for cat in ("task", "compute", "round"):
        assert any(s.cat == cat for s in sim_spans), cat
    assert {s.name for s in real_spans if s.cat == "task"} == \
        {s.name for s in sim_spans if s.cat == "task"} == {n.name for n in wl.nodes}
    rows = E.overlay_timelines(rep.timeline, sim.timeline)
    assert len(rows) == len(wl.nodes)
    assert all(r["real_dur"] is not None and r["sim_dur"] is not None for r in rows)
    assert rows == RE.overlay_timelines(rep.timeline, sim.timeline)
    d = E.diff_tracks(real_spans + sim_spans)
    assert d and all(r["real_s"] is not None and r["sim_s"] is not None for r in d)
    agg = E.summarize(real_spans + sim_spans)
    assert agg["real/task"]["count"] == agg["sim/task"]["count"]


def test_traced_and_untraced_runs_are_bitwise_identical(tmp_path):
    wl = build(tmp_path)
    spec = pmv.UpdateSpec(mode="incremental", n_rounds=2, ingest_frac=0.2,
                          update_frac=0.05)
    budget = sum(n.size for n in wl.nodes) * 0.5
    stores = {}
    for on in (False, True):
        tr.enable(on)
        stores[on] = pmv.DiskStore(tmp_path / f"on{on}", device="cpu")
        pmv.run_scenario(wl, stores[on], budget, spec, PCM, n_compute_workers=2)
        assert bool(tr.drain()) == on
    pmv.verify_scenario_equivalence(wl, stores[True], stores[False])


def test_traced_scenario_metrics_fold_per_entry(tmp_path):
    _, _, _, rep, _ = traced_scenario(tmp_path, n_rounds=1)
    snap = METRICS.snapshot()
    total_hits = sum(sum(es["hits"] for es in r.run.entry_stats.values())
                     for r in rep.rounds)
    assert sum(snap["counters"].get("catalog_hits", {}).values()) == total_hits
    assert sum(snap["counters"]["bytes_written"].values()) > 0
    assert snap["histograms"]["round_wall_s"][""]["count"] == len(rep.rounds)


# ---------------------------------------------------------------------------
# export + validation, against the reference on the same spans
# ---------------------------------------------------------------------------

def test_export_matches_reference_on_the_same_spans(tmp_path):
    wl, spec, budget, _, real_spans = traced_scenario(tmp_path)
    tr.enable(True)
    pmv.simulate_scenario(wl, spec, PCM, budget, n_workers=2)
    sim_spans = tr.drain()
    spans = real_spans + sim_spans
    doc = E.to_chrome_trace(spans)
    assert doc == RE.to_chrome_trace(to_ref(spans))
    assert E.validate_chrome_trace(doc) == RE.validate_chrome_trace(doc) == []
    assert E.summarize(spans) == RE.summarize(to_ref(spans))
    for cat in ("task", "compute"):
        assert E.diff_tracks(spans, cat) == RE.diff_tracks(to_ref(spans), cat)
    path = E.write_chrome_trace(tmp_path / "out" / "trace.json", spans)
    assert json.loads(path.read_text()) == json.loads(json.dumps(doc))
    sim_frames = sorted(
        (e["ts"], e["ts"] + e["dur"]) for e in doc["traceEvents"]
        if e.get("cat") == "round" and e["pid"] == 2)
    for (_, a_hi), (b_lo, _) in zip(sim_frames, sim_frames[1:]):
        assert b_lo >= a_hi - 1e-6


@pytest.mark.parametrize("doc", [
    {},
    {"traceEvents": []},
    {"traceEvents": [
        {"name": "x", "ph": "X", "pid": 1, "tid": 1, "ts": -5.0, "dur": -1.0},
        {"ph": "i", "pid": 1, "tid": 1, "ts": 0.0}]},
    {"traceEvents": [
        {"name": "round", "cat": "round", "ph": "X", "pid": 1, "tid": 1, "ts": 0.0,
         "dur": 10.0, "args": {"round": 0}},
        {"name": "t", "cat": "task", "ph": "X", "pid": 1, "tid": 1, "ts": 5.0,
         "dur": 20.0, "args": {"round": 0}},
        {"name": "u", "cat": "task", "ph": "i", "pid": 1, "tid": 1, "ts": 1.0,
         "args": {"round": 3}}]},
], ids=["no_events", "empty", "negative_and_missing", "outside_frame"])
def test_broken_documents_fail_validation_as_in_reference(doc):
    got = E.validate_chrome_trace(doc)
    assert got and got == RE.validate_chrome_trace(doc)


# ---------------------------------------------------------------------------
# predicted-vs-realized audit
# ---------------------------------------------------------------------------

def test_audit_joins_plans_against_trace(tmp_path):
    wl, _, _, rep, spans = traced_scenario(tmp_path)
    assert any(r.plan.flagged for r in rep.rounds)
    assert all(len(r.scores) == len(wl.nodes) for r in rep.rounds)
    audit = audit_scenario(wl, rep, spans, PCM)
    assert audit.rows
    names = [n.name for n in wl.nodes]
    audited = {(r.entry, r.round) for r in audit.rows}
    for rr in rep.rounds:
        for v in rr.plan.flagged:
            assert (names[v], rr.round_idx) in audited
    for row in audit.rows:
        assert row.realized_s == pytest.approx(row.realized_read_s + row.realized_write_s)
        assert row.drift_s == pytest.approx(row.realized_s - row.predicted_s)
        assert row.hits >= 0 and row.hold_s >= 0.0
        if row.flagged:
            assert row.predicted_s == rep.rounds[row.round].scores[names.index(row.entry)]
        else:
            assert row.predicted_s == 0.0
        if row.wasted:
            assert row.flagged and row.hits == 0
    rollup = audit.by_mv_partition()
    assert sum(a["drift_s"] for a in rollup.values()) == pytest.approx(audit.drift_s)
    d = audit.to_dict()
    assert d["schema"] == "sc-audit/v1" and len(d["rows"]) == len(audit.rows)
    assert "drift(s)" in audit.table()
    p = audit.save_json(tmp_path / "drift.json")
    assert json.loads(p.read_text())["totals"]["drift_s"] == pytest.approx(audit.drift_s)


def test_audit_matches_reference_on_the_same_report_and_spans(tmp_path):
    wl, _, _, rep, spans = traced_scenario(tmp_path)
    got = audit_scenario(wl, rep, spans, PCM)
    want = r_audit_scenario(wl, rep, to_ref(spans), RCM)
    assert [dc.asdict(r) for r in got.rows] == [dc.asdict(r) for r in want.rows]
    assert got.to_dict() == want.to_dict()
    assert got.table() == want.table()
    names = [n.name for n in wl.nodes]
    assert audit_scenario(names, rep, spans, PCM).to_dict() == got.to_dict()


@pytest.mark.parametrize("spec_kw", [dict(ingest_frac=0.2),
                                     dict(ingest_frac=0.15, update_frac=0.1,
                                          delete_frac=0.05)],
                         ids=["insert", "mixed"])
def test_audit_rows_match_reference_scenario(tmp_path, spec_kw):
    """The same scenario traced in each package (one worker): the rows'
    keys, predicted seconds, hits, resident bytes and waste / overflow
    flags are the plan's and the catalog's, not the clock's."""
    out = {}
    for mv, audit in ((pmv, audit_scenario), (rmv, r_audit_scenario)):
        wl, _, _, rep, spans = traced_scenario(tmp_path, mv, k=1, **spec_kw)
        out[mv] = audit(wl, rep, spans, PCM if mv is pmv else RCM)
    got, want = ([tuple(getattr(r, f) for f in TIMING_FREE) for r in out[mv].rows]
                 for mv in (pmv, rmv))
    assert got == want and got
    assert out[pmv].predicted_s == out[rmv].predicted_s


# ---------------------------------------------------------------------------
# tools/sc_trace_torch.py
# ---------------------------------------------------------------------------

def load_tool(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_sc_trace_torch_demo_on_cpu_exits_0(tmp_path):
    out = tmp_path / "trace"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, str(TOOL), "demo", "--device", "cpu", "--out", str(out),
         "--rounds", "2"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "bitwise on/off: identical stored MVs" in res.stdout
    assert "trace validation: ok" in res.stdout
    for name in ("trace.json", "spans.json", "metrics.json", "drift.json", "diff.json"):
        assert (out / name).is_file(), name
    assert json.loads((out / "drift.json").read_text())["schema"] == "sc-audit/v1"
    res = subprocess.run([sys.executable, str(TOOL), "validate", str(out / "trace.json")],
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "ok" in res.stdout


def test_sc_trace_torch_subcommands_match_reference(tmp_path, capsys):
    port_tool = load_tool(TOOL, "sc_trace_torch")
    ref_tool = load_tool(ROOT / "tools" / "sc_trace.py", "sc_trace")
    wl, spec, budget, _, real_spans = traced_scenario(tmp_path)
    tr.enable(True)
    pmv.simulate_scenario(wl, spec, PCM, budget, n_workers=2)
    spans_path = tmp_path / "spans.json"
    spans_path.write_text(json.dumps([s._asdict() for s in real_spans + tr.drain()]))
    for cmd in ("summary", "diff"):
        assert port_tool.main([cmd, str(spans_path)]) == 0
        got = capsys.readouterr().out
        assert ref_tool.main([cmd, str(spans_path)]) == 0
        assert got == capsys.readouterr().out and got
    broken = tmp_path / "broken.json"
    broken.write_text(json.dumps({"traceEvents": [
        {"name": "x", "ph": "X", "pid": 1, "tid": 1, "ts": -5.0, "dur": -1.0}]}))
    assert port_tool.main(["validate", str(broken)]) == 1
    got = capsys.readouterr().out
    assert ref_tool.main(["validate", str(broken)]) == 1
    assert got == capsys.readouterr().out and "problem" in got
