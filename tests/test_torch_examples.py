"""The port's examples (``examples/*_torch.py``) on the CPU: each runs at
its ``SC_SMOKE=1`` size with ``--device cpu`` in its own interpreter and
exits 0 (their own asserts hold: bitwise-equal stores, a falling loss),
launches no CUDA kernel (the plain versions run), and says what the
reference example says where the result is deterministic: quickstart's S/C
plan summary is the reference's, and the partitioned store is bitwise the
unpartitioned reference."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "mv_refresh_pipeline", "incremental_refresh",
            "update_delete_refresh", "partitioned_refresh", "traced_refresh",
            "train_lm")
TIMEOUT = 300  # seconds for one example (under 15 s each on a laptop CPU)


def run(script: Path, cwd: Path, *args: str) -> str:
    env = dict(os.environ, SC_SMOKE="1", PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, str(script), *args], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=TIMEOUT)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return res.stdout


def plan_summary(out: str) -> str:
    block = out.split("=== S/C plan ===\n", 1)[1]
    return block.split("\n\nserial:", 1)[0]


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_on_cpu(name, tmp_path):
    out = run(REPO / "examples" / f"{name}_torch.py", tmp_path, "--device", "cpu")
    last = out.strip().splitlines()[-1]
    assert last.startswith("launches ")
    launches = json.loads(last.removeprefix("launches "))
    assert launches and not any(launches.values())  # the CPU runs the plain versions
    if name == "quickstart":
        ref = run(REPO / "examples" / "quickstart.py", tmp_path)
        assert plan_summary(out) == plan_summary(ref)
    elif name == "partitioned_refresh":
        assert "partitioned == unpartitioned recompute: bitwise OK" in out
    elif name == "traced_refresh":
        trace = json.loads((tmp_path / "results" / "trace_example_torch" /
                            "trace.json").read_text())
        assert trace["traceEvents"]
    elif name == "train_lm":
        first, final = out.split("loss: ", 1)[1].split("\n")[0].split(" -> ")
        assert float(final) < float(first)
