"""``tools/sc_lint_torch.py``, the port's sc-lint tool, on the CPU: its
passes are the reference tool's with ``ptx`` in place of ``jaxpr``, its
workload passes give the reference's findings, the gate is clean against
its baseline, and a fixture made to stop firing fails it."""
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import native
from repro_torch.analysis import fixtures as F

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def tool():
    return load(REPO / "tools" / "sc_lint_torch.py", "sc_lint_torch")


@pytest.fixture(scope="module")
def ref_tool():
    return load(REPO / "tools" / "sc_lint.py", "sc_lint_reference")


def test_ci_on_cpu_exits_zero_with_six_passes(tmp_path):
    report = tmp_path / "report.json"
    res = subprocess.run(
        [sys.executable, str(REPO / "tools" / "sc_lint_torch.py"), "--ci",
         "--device", "cpu", "--report", str(report)],
        env=dict(os.environ, PYTHONPATH=str(REPO / "src")), cwd=tmp_path,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    assert "OK: no new gating findings" in res.stdout
    doc = json.loads(report.read_text())
    assert list(doc["counts"]) == ["source", "ptx", "delta-safety", "plan", "mqo",
                                   "fixtures"]
    assert doc["new_fingerprints"] == [] and doc["stale_baseline_entries"] == []
    assert "device cpu" in doc["environment"]
    ptx = [f for f in doc["findings"] if f["path"] == "src/repro_torch/csrc/dataplane.cu"]
    if native.nvcc_path() is None:
        assert doc["counts"]["ptx"] == 1
        assert [(f["rule"], f["level"]) for f in ptx] == [("lint-skipped", "info")]
    else:
        assert not any(f["rule"] == "lint-skipped" for f in ptx)


def test_passes_are_the_references_with_ptx_for_jaxpr(tool, ref_tool):
    want = ["ptx" if name == "jaxpr" else name for name, _ in ref_tool.PASSES]
    assert [name for name, _ in tool.PASSES] == want


@pytest.mark.parametrize("name", ["delta-safety", "plan", "mqo"])
def test_workload_passes_match_reference(tool, ref_tool, name):
    got = dict(tool.PASSES)[name](CPU)
    want = dict(ref_tool.PASSES)[name]()
    assert [(f.rule, f.level, f.path, f.symbol, f.message) for f in got] == \
        [(f.rule, f.level, f.path, f.symbol, f.message) for f in want]


def test_fixtures_pass_is_quiet(tool):
    assert tool._fixture_findings(CPU) == []


def test_passes_record_what_they_read(tool, monkeypatch):
    """The ptx and fixtures passes record the per-kernel counts and the MAP
    fixtures' rules (what chip_smoke's lint phase checks on the card)."""
    monkeypatch.setattr(native, "nvcc_path", lambda: None)
    record = {}
    assert tool._ptx_findings(CPU, record)[0].rule == "lint-skipped"
    assert tool._fixture_findings(CPU, record) == []
    assert record == {"ptx": {}, "fixtures": {"committed": {
        "legacy_fused_map": ["fma-contraction", "transcendental-kernel"],
        "shipped_map": []}}}


@pytest.mark.parametrize("attr, broken, symbol", [
    ("LEGACY_FILTER_MASK_SRC", F.SHIPPED_FILTER_MASK_SRC, "LEGACY_FILTER_MASK_SRC"),
    ("SHIPPED_FILTER_MASK_SRC", F.LEGACY_FILTER_MASK_SRC, "SHIPPED_FILTER_MASK_SRC"),
    ("LEGACY_FUSED_MAP_PTX", F.SHIPPED_MAP_PTX, "legacy_fused_map"),
    ("SHIPPED_MAP_PTX", F.LEGACY_FUSED_MAP_PTX, "shipped_map"),
    ("forged_threshold_merge", F.genuine_shared_prefix_merge, "forged_threshold_merge"),
], ids=["legacy_filter_mask", "shipped_filter_mask", "legacy_map_ptx", "shipped_map_ptx",
        "forged_merge"])
def test_fixture_that_stops_firing_regresses(tool, monkeypatch, attr, broken, symbol):
    monkeypatch.setattr(F, attr, broken)
    got = tool._fixture_findings(CPU)
    assert got and {(f.rule, f.level, f.symbol) for f in got} == \
        {("fixture-regression", "error", symbol)}


def test_fixture_regression_fails_the_gate(tool, monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(F, "LEGACY_FUSED_MAP_PTX", F.SHIPPED_MAP_PTX)
    report = tmp_path / "report.json"
    assert tool.main(["--ci", "--device", "cpu", "--report", str(report)]) == 1
    assert "FAIL: 2 new gating finding(s)" in capsys.readouterr().out
    doc = json.loads(report.read_text())
    assert doc["new_fingerprints"] == [
        "fixture-regression:repro_torch/analysis/fixtures.py:legacy_fused_map"] * 2


def test_update_baseline_writes_the_port_comment(tool, tmp_path):
    baseline = tmp_path / "baseline.json"
    assert tool.main(["--update-baseline", "--device", "cpu",
                      "--baseline", str(baseline)]) == 0
    doc = json.loads(baseline.read_text())
    assert doc == json.loads((REPO / "tools" / "sc_lint_torch_baseline.json").read_text())
    assert "sc_lint_torch.py --update-baseline" in doc["comment"]


def test_default_device_is_the_card(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main(["--ci"])
