"""Training loop: S/C-scheduled data pipeline → train step → write-behind
checkpointing, with preemption handling, straggler monitoring and
crash-resume; the counterpart of ``repro.train.loop``.

The order is the reference's: materialize the dataset if it has no
manifest, plan remat, init or restore, loop with preemption and straggler
checks, save write-behind every ``ckpt_every`` steps and once at the end,
waiting on the last save. Everything runs on ``device`` (default: the
card; ``run_training`` raises without one unless given ``device="cpu"``).
"""
from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Callable

import torch

from ..checkpoint import CheckpointManager
from ..configs.base import ModelConfig, ShapeSpec
from ..core.planner import plan_remat
from ..data import BatchIterator, DataConfig, materialize_dataset
from ..device import resolve_device
from ..models import init_params
from ..runtime import PreemptionHandler, StragglerDetector
from .optimizer import AdamWConfig
from .step import init_train_state, make_train_step


@dataclasses.dataclass
class LoopConfig:
    steps: int = 20
    batch_size: int = 8
    ckpt_every: int = 5
    ckpt_dir: str = "ckpts"
    data_dir: str = "data"
    seed: int = 0
    compress_grads: bool = False
    log_every: int = 5  # the reference's field; unused there too


def run_training(
    cfg: ModelConfig,
    loop: LoopConfig,
    dcfg: DataConfig | None = None,
    opt: AdamWConfig = AdamWConfig(),
    on_step: Callable[[int, dict], None] | None = None,
    device: str | torch.device | None = None,
) -> dict:
    """Returns ``{"state", "losses", "step_seconds", "resumed_from",
    "straggler_events", "preempted", "ckpt"}``: ``step_seconds`` are the
    host-clock seconds of each step (batch, step, and the loss read back,
    which waits for the device); ``ckpt`` is the run's ``CheckpointManager``.
    The model is drawn from a generator on ``device`` seeded with
    ``loop.seed``."""
    dev = resolve_device(device)
    dcfg = dcfg or DataConfig(seq_len=min(cfg.d_model, 128) + 1)
    data_root = Path(loop.data_dir)
    if not (data_root / "MANIFEST.json").exists():
        materialize_dataset(dcfg, data_root, device=dev)  # S/C-scheduled refresh
    it = BatchIterator(data_root, dcfg, loop.batch_size, device=dev)

    save_names = ()
    if cfg.remat_policy == "planner":
        plan = plan_remat(
            cfg, ShapeSpec("local", dcfg.seq_len - 1, loop.batch_size, "train"), dp=1,
        )
        save_names = plan.save_names

    step_fn = make_train_step(
        cfg, opt, global_rows=loop.batch_size,
        save_names=save_names, compress_grads=loop.compress_grads,
    )

    ckpt = CheckpointManager(loop.ckpt_dir)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(loop.seed), dev)
    state = init_train_state(cfg, params, compress_grads=loop.compress_grads)
    start_step = 0
    resumed_from = None
    if ckpt.latest_step() is not None:
        restored = ckpt.restore({"train": state, "data": it.get_state()})
        state = restored["train"]
        it.set_state(restored["data"])
        start_step = int(state["opt"]["step"])
        resumed_from = start_step

    preempt = PreemptionHandler().install()
    straggle = StragglerDetector(n_hosts=1)
    losses: list[float] = []
    step_seconds: list[float] = []
    try:
        for step in range(start_step, loop.steps):
            t0 = time.perf_counter()
            batch = it.next_batch()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])  # waits for the step's device work
            losses.append(loss)
            step_seconds.append(time.perf_counter() - t0)
            straggle.observe(step, step_seconds[-1:])
            if on_step:
                on_step(step, metrics)
            if (step + 1) % loop.ckpt_every == 0 or preempt.preempted:
                ckpt.save({"train": state, "data": it.get_state()}, step + 1)
            if preempt.preempted:
                break
        ckpt.save({"train": state, "data": it.get_state()}, loop.steps,
                  blocking=False)
        ckpt.wait()
    finally:
        preempt.uninstall()
    return {
        "state": state,
        "losses": losses,
        "step_seconds": step_seconds,
        "resumed_from": resumed_from,
        "straggler_events": straggle.events,
        "preempted": preempt.preempted,
        "ckpt": ckpt,
    }
