"""The port's training loop, checkpointing, fault tolerance and data
pipeline on the CPU: mirrors of ``tests/train/test_loop.py``,
``tests/checkpoint/test_ckpt.py`` (all but elastic restore, which comes with
the sharding slice), ``tests/runtime/test_ft.py`` and
``tests/data/test_pipeline.py``, on ``device="cpu"``, plus the training CLI.
"""
import dataclasses
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import BatchIterator, DataConfig, build_pipeline_workload
from repro_torch.data import materialize_dataset
from repro_torch.kernels import ops
from repro_torch.runtime import PreemptionHandler, StragglerDetector
from repro_torch.train.loop import LoopConfig, run_training
from repro_torch.train.optimizer import AdamWConfig

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def one_thread():
    """The models here are tiny: one intra-op thread runs them fastest and
    keeps parallel test workers from oversubscribing the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# the training loop (tests/train/test_loop.py)
# ---------------------------------------------------------------------------

def tiny_cfg():
    return get_config("stablelm-3b").reduced(
        n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
        vocab_size=64, head_dim=16, microbatch_size=4,
    )


def dconf():
    return DataConfig(n_shards=2, docs_per_shard=16, doc_len=128,
                      vocab_size=64, seq_len=33)


def loop_cfg(tmp_path, tag, steps, **kw):
    return LoopConfig(steps=steps, batch_size=8, ckpt_dir=str(tmp_path / f"{tag}_ck"),
                      data_dir=str(tmp_path / f"{tag}_d"), **kw)


def test_loss_decreases(tmp_path):
    ops.reset_launches()
    res = run_training(tiny_cfg(), loop_cfg(tmp_path, "a", 30, ckpt_every=100), dconf(),
                       AdamWConfig(lr=5e-3, warmup_steps=5), device="cpu")
    losses = res["losses"]
    assert len(losses) == 30
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses
    assert all(np.isfinite(losses))
    assert ops.launches == dict.fromkeys(ops.KERNELS, 0)
    assert res["ckpt"].latest_step() == 30


def test_crash_resume_matches_uninterrupted(tmp_path):
    cfg, opt = tiny_cfg(), AdamWConfig(lr=1e-3, warmup_steps=2)
    full = run_training(cfg, loop_cfg(tmp_path, "full", 12, ckpt_every=6, seed=3),
                        dconf(), opt, device="cpu")
    # crash after 6 (simulated by running only 6 steps), then restart to 12
    run_training(cfg, loop_cfg(tmp_path, "crash", 6, ckpt_every=6, seed=3), dconf(),
                 opt, device="cpu")
    resumed = run_training(cfg, loop_cfg(tmp_path, "crash", 12, ckpt_every=6, seed=3),
                           dconf(), opt, device="cpu")
    assert resumed["resumed_from"] == 6
    assert resumed["losses"] == full["losses"][6:]
    a = dict(full["state"]["params"].named_parameters())
    b = dict(resumed["state"]["params"].named_parameters())
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for key in ("m", "v"):
        for k, t in full["state"]["opt"][key].items():
            assert torch.equal(t, resumed["state"]["opt"][key][k]), (key, k)


def test_planner_policy_runs(tmp_path):
    cfg = dataclasses.replace(tiny_cfg(), remat_policy="planner")
    res = run_training(cfg, loop_cfg(tmp_path, "p", 4, ckpt_every=100), dconf(),
                       device="cpu")
    assert all(np.isfinite(res["losses"]))


def test_compress_grads_waits_for_the_sharding_slice(tmp_path):
    """``compress_grads`` no longer waits: the loop trains with int8
    error-feedback compression (only ``compressed_psum`` waits for the
    sharding slice), checkpoints the errors and resumes from them."""
    cfg, opt = tiny_cfg(), AdamWConfig(lr=1e-3, warmup_steps=2)
    full = run_training(cfg, loop_cfg(tmp_path, "c", 4, ckpt_every=2, compress_grads=True),
                        dconf(), opt, device="cpu")
    assert all(np.isfinite(full["losses"])) and len(full["losses"]) == 4
    err = full["state"]["ef_error"]
    assert set(err) == set(full["state"]["opt"]["m"]) and any(e.any() for e in err.values())
    run_training(cfg, loop_cfg(tmp_path, "r", 2, ckpt_every=2, compress_grads=True), dconf(),
                 opt, device="cpu")
    resumed = run_training(cfg, loop_cfg(tmp_path, "r", 4, ckpt_every=2, compress_grads=True),
                           dconf(), opt, device="cpu")
    assert resumed["resumed_from"] == 2
    assert resumed["losses"] == full["losses"][2:]
    for k, e in err.items():
        assert torch.equal(e, resumed["state"]["ef_error"][k]), k


def test_train_cli_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced", "--device", "cpu",
         "--steps", "3", "--batch-size", "4", "--seq-len", "33",
         "--ckpt-dir", str(tmp_path / "ck"), "--data-dir", str(tmp_path / "d")],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "final loss" in res.stdout and "device=cpu" in res.stdout


# ---------------------------------------------------------------------------
# checkpointing (tests/checkpoint/test_ckpt.py)
# ---------------------------------------------------------------------------

def state_tree(x=1.0):
    return {
        "params": {"w": torch.full((4, 4), x), "b": torch.zeros(4)},
        "opt": {"m": {"w": torch.ones((4, 4)) * 2, "b": torch.ones(4)},
                "step": torch.tensor(7, dtype=torch.int32)},
    }


def leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    return [tree]


def test_save_restore_bitwise(tmp_path):
    mgr = CheckpointManager(tmp_path)
    s = state_tree(3.5)
    mgr.save(s, step=10, blocking=True)
    assert mgr.latest_step() == 10
    r = mgr.restore(state_tree(0.0))
    for a, b in zip(leaves(s), leaves(r)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_async_save_equals_blocking(tmp_path):
    m1, m2 = CheckpointManager(tmp_path / "a"), CheckpointManager(tmp_path / "b")
    s = state_tree(2.25)
    m1.save(s, 1, blocking=True)
    fut = m2.save(s, 1, blocking=False)
    m2.wait()
    assert fut.done()
    r1, r2 = m1.restore_flat(), m2.restore_flat()
    assert set(r1) == set(r2)
    for k in r1:
        assert torch.equal(r1[k], r2[k])


def test_snapshot_is_taken_at_save(tmp_path):
    """An in-place update after ``save`` returns must not reach the
    checkpoint (the optimizer updates parameters in place)."""
    mgr = CheckpointManager(tmp_path)
    s = state_tree(1.0)
    mgr.save(s, 1)
    s["params"]["w"].add_(5.0)
    mgr.wait()
    assert float(mgr.restore_flat()["params/w"].mean()) == 1.0


def test_crash_mid_write_never_corrupts_latest(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(state_tree(1.0), 1, blocking=True)
    tmp = tmp_path / "step_00000002.tmp"
    tmp.mkdir()
    (tmp / "garbage.npy").write_bytes(b"not a checkpoint")
    assert mgr.latest_step() == 1
    r = mgr.restore(state_tree(0.0))
    assert float(r["params"]["w"].mean()) == 1.0


def test_write_behind_overlaps_compute(tmp_path):
    mgr = CheckpointManager(tmp_path)
    big = {"w": torch.ones((2048, 2048))}  # 16MB
    t0 = time.perf_counter()
    mgr.save(big, 1, blocking=False)
    enqueue_time = time.perf_counter() - t0
    mgr.wait()
    assert enqueue_time < mgr.write_seconds + 0.5
    assert enqueue_time < 0.5, f"save() blocked for {enqueue_time:.2f}s"


def test_bf16_roundtrips_bitwise_in_the_reference_format(tmp_path):
    """bf16 is stored as its uint16 bits with logical dtype ``bfloat16``,
    the reference's format."""
    mgr = CheckpointManager(tmp_path)
    s = {"w": torch.linspace(-3, 7, 64, dtype=torch.bfloat16)}
    mgr.save(s, 1, blocking=True)
    stored = np.load(tmp_path / "step_00000001" / "w.npy")
    assert stored.dtype == np.uint16
    assert stored.tobytes() == s["w"].view(torch.int16).numpy().tobytes()
    r = mgr.restore({"w": torch.zeros(64, dtype=torch.bfloat16)})
    assert r["w"].dtype == torch.bfloat16
    assert torch.equal(r["w"].view(torch.int16), s["w"].view(torch.int16))


def test_gc_keeps_last_k(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for step in range(1, 6):
        mgr.save(state_tree(float(step)), step, blocking=True)
    found = sorted(p.name for p in tmp_path.iterdir() if p.name.startswith("step_"))
    assert found == ["step_00000004", "step_00000005"]


def test_module_leaves_are_its_named_parameters(tmp_path):
    model = torch.nn.Linear(3, 2)
    mgr = CheckpointManager(tmp_path)
    mgr.save({"params": model, "data": {"cursor": 4}}, 1, blocking=True)
    assert set(mgr.restore_flat()) == {"params/weight", "params/bias", "data/cursor"}
    fresh = torch.nn.Linear(3, 2)
    r = mgr.restore({"params": fresh, "data": {"cursor": 0}})
    assert r["params"] is fresh and r["data"] == {"cursor": 4}
    assert torch.equal(fresh.weight, model.weight)


# ---------------------------------------------------------------------------
# fault tolerance (tests/runtime/test_ft.py)
# ---------------------------------------------------------------------------

def test_preemption_install_uninstall_restores_handlers():
    sentinel_calls = []

    def sentinel(signum, frame):
        sentinel_calls.append(signum)

    prev = signal.signal(signal.SIGUSR1, sentinel)
    try:
        h = PreemptionHandler(signals=(signal.SIGUSR1,)).install()
        assert signal.getsignal(signal.SIGUSR1) == h._on_signal
        h.uninstall()
        assert signal.getsignal(signal.SIGUSR1) is sentinel
        assert not h._prev
        os.kill(os.getpid(), signal.SIGUSR1)
        assert sentinel_calls == [signal.SIGUSR1]
        assert not h.preempted
    finally:
        signal.signal(signal.SIGUSR1, prev)


def test_preemption_flag_on_signal():
    h = PreemptionHandler(signals=(signal.SIGUSR1,)).install()
    try:
        assert not h.preempted
        os.kill(os.getpid(), signal.SIGUSR1)
        assert h.preempted
    finally:
        h.uninstall()


def test_straggler_detector_flags_slow_host():
    det = StragglerDetector(n_hosts=4, threshold=2.0, patience=3)
    flagged_at = None
    for step in range(10):
        flagged = det.observe(step, [1.0, 1.0, 1.0, 5.0])
        if flagged and flagged_at is None:
            flagged_at = step
            assert flagged == [3]
    assert flagged_at is not None and flagged_at >= 2
    assert any(e.host == 3 for e in det.events)


def test_straggler_detector_ignores_uniform_slowness():
    det = StragglerDetector(n_hosts=4, threshold=2.0, patience=2)
    for step in range(10):
        assert det.observe(step, [3.0, 3.1, 2.9, 3.0]) == []


def test_straggler_recovery_resets_strikes():
    det = StragglerDetector(n_hosts=2, threshold=2.0, patience=3, ewma=1.0)
    det.observe(0, [1.0, 5.0])
    det.observe(1, [1.0, 5.0])
    det.observe(2, [1.0, 1.0])
    assert det.observe(3, [1.0, 1.0]) == []
    assert not det.events


def test_straggler_flag_rearms_after_reporting():
    det = StragglerDetector(n_hosts=4, threshold=2.0, patience=2, ewma=1.0)
    flags = [det.observe(s, [1.0, 1.0, 1.0, 9.0]) for s in range(6)]
    flagged_steps = [s for s, f in enumerate(flags) if f == [3]]
    assert flagged_steps == [1, 3, 5]
    assert [e.step for e in det.events] == flagged_steps


def test_straggler_patience_exact_boundary():
    eager = StragglerDetector(n_hosts=3, threshold=2.0, patience=1, ewma=1.0)
    assert eager.observe(0, [1.0, 1.0, 9.0]) == [2]
    det = StragglerDetector(n_hosts=3, threshold=2.0, patience=3, ewma=1.0)
    for step, slow in enumerate([9.0, 9.0, 1.0, 9.0, 9.0]):
        assert det.observe(step, [1.0, 1.0, slow]) == []
    assert det.observe(5, [1.0, 1.0, 9.0]) == [2]
    ev = det.events[-1]
    assert (ev.step, ev.host) == (5, 2) and ev.duration > 2.0 * ev.median
    with pytest.raises(ValueError, match="hosts"):
        det.observe(6, [1.0])


# ---------------------------------------------------------------------------
# the data pipeline (tests/data/test_pipeline.py)
# ---------------------------------------------------------------------------

def test_pipeline_workload_structure():
    wl = build_pipeline_workload(DataConfig(n_shards=3), device="cpu")
    assert wl.n == 3 * 4 + 1
    g = wl.to_graph()
    assert g.is_topological(g.topological_order())


def test_materialize_is_sc_scheduled_and_complete(tmp_path):
    dcfg = DataConfig(n_shards=3, catalog_budget_bytes=1 << 20)
    out = materialize_dataset(dcfg, tmp_path, device="cpu")
    assert out["plan"].flagged, "expected some nodes kept in memory"
    assert out["report"].peak_catalog_bytes <= dcfg.catalog_budget_bytes
    manifest = out["store"].manifest()
    for node in out["workload"].nodes:
        assert node.name in manifest


def test_iterator_deterministic_and_resumable(tmp_path):
    dcfg = DataConfig(n_shards=2, seed=5)
    materialize_dataset(dcfg, tmp_path, device="cpu")
    a = BatchIterator(tmp_path, dcfg, batch_size=4, device="cpu")
    b = BatchIterator(tmp_path, dcfg, batch_size=4, device="cpu")
    for _ in range(5):
        assert torch.equal(a.next_batch()["tokens"], b.next_batch()["tokens"])
    snap = a.get_state()
    want = [a.next_batch()["tokens"] for _ in range(3)]
    c = BatchIterator(tmp_path, dcfg, batch_size=4, device="cpu")
    c.set_state(snap)
    for w in want:
        assert torch.equal(w, c.next_batch()["tokens"])


def test_epoch_rollover_reshuffles(tmp_path):
    dcfg = DataConfig(n_shards=1, docs_per_shard=8, doc_len=64, seq_len=16)
    materialize_dataset(dcfg, tmp_path, device="cpu")
    it = BatchIterator(tmp_path, dcfg, batch_size=8, device="cpu")
    first = it.next_batch()["tokens"].clone()
    for _ in range(len(it.all) // 8):
        it.next_batch()
    assert it.state["epoch"] >= 1
    assert it.next_batch()["tokens"].shape == first.shape


def test_labels_are_shifted_tokens(tmp_path):
    dcfg = DataConfig(n_shards=1, seq_len=32)
    materialize_dataset(dcfg, tmp_path, device="cpu")
    b = BatchIterator(tmp_path, dcfg, batch_size=2, device="cpu").next_batch()
    assert b["tokens"].shape == (2, 31) and b["tokens"].dtype == torch.int32
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])
