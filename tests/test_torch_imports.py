"""The port stands alone: it imports neither JAX (nor jaxlib, nor
``ml_dtypes``, which the card's machine lacks) nor the JAX package (nor do
the sharding tests' rank programs, ``test_torch_mesh_ranks.py``), its
entry points default to the card and refuse to run without one, and on CPU
tensors it never reaches a CUDA kernel."""
import ast
import importlib.util
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import convert
from repro_torch import configs as tcfg
from repro_torch import data as tdata
from repro_torch.launch import train as launch_train
from repro_torch.train.loop import LoopConfig, run_training
from repro_torch import models as tm
from repro_torch.serve import greedy_generate
from repro_torch.analysis import delta_safety, fixtures, mqo_check
from repro_torch.mv import dataplane as dp
from repro_torch.mv import ir as mvir
from repro_torch.mv import mqo
from repro_torch.mv import tableops as T
from repro_torch.mv import workloads as W
from repro_torch.mv.partition import partition_table
from repro_torch.mv.storage import DiskStore
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.sharding.layout import init_sharded_params

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
BANNED = ("jax", "jaxlib", "ml_dtypes", "repro")
_SMALL = tcfg.get_config("stablelm-12b").reduced()
_MAMBA = tcfg.get_config("mamba2-2.7b").reduced()


def _small_cpu_model():
    return tm.init_params(_SMALL, torch.Generator(), device="cpu")


def _sc_trace_torch():
    spec = importlib.util.spec_from_file_location(
        "sc_trace_torch", ROOT / "tools" / "sc_trace_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages([str(PKG)], prefix="repro_torch.")
    )


def test_importing_every_module_loads_neither_jax_nor_repro():
    mods = port_modules()
    assert "repro_torch.mv.dataplane" in mods and len(mods) >= 20
    assert {"repro_torch.train.loop", "repro_torch.train.step", "repro_torch.core.planner",
            "repro_torch.checkpoint.ckpt", "repro_torch.data.pipeline",
            "repro_torch.runtime.ft", "repro_torch.launch.train",
            "repro_torch.kernels.ssd_scan", "repro_torch.mv.multihost",
            "repro_torch.sharding.strategy", "repro_torch.sharding.context",
            "repro_torch.sharding.collectives", "repro_torch.sharding.layout",
            "repro_torch.sharding.compression", "repro_torch.launch.mesh"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        f"bad = sorted(k for k in sys.modules if k.split('.')[0] in {BANNED!r})\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(ROOT)) for p in PKG.rglob("*.py"))
    + ["chip_smoke.py", "tools/sc_trace_torch.py", "tools/sc_lint_torch.py",
       "tests/test_torch_mesh_ranks.py"]
    + sorted(str(p.relative_to(ROOT)) for p in (ROOT / "examples").glob("*_torch.py")),
)
def test_no_jax_or_repro_import_in_source(path):
    roots = _imported_roots(ROOT / path)
    assert not roots & set(BANNED), (path, roots)


@pytest.mark.parametrize("entry", [
    lambda tmp: W.realize_workload(W.generate_workload(4, seed=1)),
    lambda tmp: T.make_base_table(10, 3, seed=0),
    lambda tmp: T.empty_like({"key": torch.int64}),
    lambda tmp: DiskStore(tmp / "store"),
    lambda tmp: convert.table_from_numpy({"key": np.arange(3)}),
    lambda tmp: tm.init_params(_SMALL, torch.Generator()),
    lambda tmp: tm.make_cache(_SMALL, 1, 4),
    lambda tmp: tm.init_params(_MAMBA, torch.Generator()),
    lambda tmp: tm.make_cache(_MAMBA, 1, 4),
    lambda tmp: greedy_generate(_SMALL, _small_cpu_model(),
                                torch.zeros(1, 2, dtype=torch.int64), 2),
    lambda tmp: convert.params_from_reference(_SMALL, {}),
    lambda tmp: convert.train_state_from_reference(_SMALL, {}),
    lambda tmp: tdata.materialize_dataset(tdata.DataConfig(n_shards=1), tmp / "d"),
    lambda tmp: tdata.build_pipeline_workload(tdata.DataConfig(n_shards=1)),
    lambda tmp: tdata.BatchIterator(tmp / "d", tdata.DataConfig(n_shards=1), 2),
    lambda tmp: run_training(_SMALL, LoopConfig(steps=1, ckpt_dir=str(tmp / "ck"),
                                                data_dir=str(tmp / "d"))),
    lambda tmp: launch_train.main(["--reduced", "--steps", "1",
                                   "--ckpt-dir", str(tmp / "ck"),
                                   "--data-dir", str(tmp / "d")]),
    lambda tmp: mvir.infer_schemas(mvir.lift_workload(W.generate_workload(4, seed=1))),
    lambda tmp: mvir.scan_table_schema(4).empty_table(),
    lambda tmp: mqo.merge_workload(mqo.shared_prefix_workload(2)),
    lambda tmp: delta_safety.analyze_workload(W.generate_workload(4, seed=1)),
    lambda tmp: mqo_check.check_merged(fixtures.forged_threshold_merge(device="cpu")),
    lambda tmp: fixtures.forged_threshold_merge(),
    lambda tmp: fixtures.genuine_shared_prefix_merge(),
    lambda tmp: _sc_trace_torch().main(["demo", "--out", str(tmp / "d")]),
    lambda tmp: init_sharded_params(_SMALL, torch.Generator(), make_production_mesh()),
], ids=["realize_workload", "make_base_table", "empty_like", "DiskStore",
        "table_from_numpy", "init_params", "make_cache", "init_params_mamba2",
        "make_cache_mamba2", "greedy_generate",
        "params_from_reference", "train_state_from_reference",
        "materialize_dataset", "build_pipeline_workload", "BatchIterator",
        "run_training", "launch.train", "infer_schemas", "Schema.empty_table",
        "merge_workload", "analyze_workload", "check_merged",
        "forged_threshold_merge", "genuine_shared_prefix_merge",
        "sc_trace_torch.demo", "init_sharded_params"])
def test_entry_points_default_to_cuda_and_raise_without_it(entry, tmp_path,
                                                           monkeypatch):
    # the port asks for a card without initialising CUDA: NVML's count
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry(tmp_path)
    assert not (tmp_path / "d").exists() and not (tmp_path / "ck").exists()


def test_cpu_tensors_never_launch_a_kernel():
    dp.reset_launches()
    base = T.make_base_table(2000, 4, seed=3, rid_base=0, device="cpu")
    right = T.make_base_table(500, 3, seed=4, rid_base=1 << 40, device="cpu")
    joined = T.op_join(T.op_map(base), right)
    T.op_agg(T.op_filter(joined, "c0", 0.1))
    T.merge_agg(T.op_agg(base), T.op_agg(T.with_weight(base, -1)))
    partition_table(base, 8)
    dp.hash64(base["key"])
    assert set(dp.launches) == set(dp.KERNELS)
    assert all(v == 0 for v in dp.launches.values()), dp.launches
    assert all(v == 0 for v in dp.variant_launches.values())


def test_wrappers_refuse_other_devices():
    meta = torch.empty(4, dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="device"):
        dp.filter_mask(meta, 0.0)
    with pytest.raises(ValueError, match="device"):
        dp.map_derived(meta, torch.zeros(4))


def test_package_has_a_version():
    assert repro_torch.__version__


def test_default_device_never_asks_the_cuda_runtime(monkeypatch):
    """``resolve_device(None)`` counts cards through NVML
    (``torch.cuda.device_count``) and never calls ``torch.cuda.is_available``,
    which initialises the CUDA runtime and leaves a process unable to fork
    hosts that use the card (the multi-host pool's process backend)."""
    from repro_torch.device import resolve_device

    def runtime_check():
        raise AssertionError("torch.cuda.is_available was called")

    monkeypatch.setattr(torch.cuda, "is_available", runtime_check)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert resolve_device(None) == torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert resolve_device(None) == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_native_locks_are_fresh_in_a_forked_child():
    """A lock of ``native`` held by a parent thread at a fork is a fresh,
    unlocked lock in the child (the multi-host pool forks its hosts)."""
    import multiprocessing as mp

    from repro_torch import native

    ctx = mp.get_context("fork")
    q = ctx.Queue()

    def child():
        q.put((native._lock.acquire(timeout=5), native._count_lock.acquire(timeout=5)))

    with native._lock, native._count_lock:
        proc = ctx.Process(target=child)
        proc.start()
        got = q.get(timeout=30)
        proc.join(30)
    assert got == (True, True) and proc.exitcode == 0
