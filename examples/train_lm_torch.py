"""End-to-end training example on the PyTorch port: train a GQA transformer
on the S/C-materialized data pipeline, with write-behind checkpointing and
crash-resume (the walkthrough of ``examples/train_lm.py`` on
``repro_torch``).

Full run (~100M params, 200 steps):
    PYTHONPATH=src python examples/train_lm_torch.py --full
Smoke run (~1M params, 40 steps; 12 under SC_SMOKE=1):
    PYTHONPATH=src python examples/train_lm_torch.py
    SC_SMOKE=1 PYTHONPATH=src python examples/train_lm_torch.py --device cpu

Everything runs on ``--device`` (default: the card, where the model is bf16
and RMSNorm and the flash-attention forward and backward run as the port's
CUDA kernels; ``cpu`` runs their plain versions). The last line gives the
kernels' launches.
"""
import argparse
import dataclasses
import json
import os
import tempfile

from repro_torch.configs import get_config
from repro_torch.data import DataConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.mv import dataplane
from repro_torch.train.loop import LoopConfig, run_training
from repro_torch.train.optimizer import AdamWConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="~100M params, 200 steps")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None,
                    help="where the model and batches live (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.out is None:
        # SC_SMOKE (the CI docs job) gets a fresh directory: resuming from a
        # previous run's checkpoints would leave zero steps to execute
        args.out = (
            tempfile.mkdtemp(prefix="sc_train_")
            if os.environ.get("SC_SMOKE")
            else "results/example_train_torch"
        )

    base = get_config("stablelm-3b")
    if args.full:
        # ~100M-parameter family member: 12 layers, d=768, 12 heads
        cfg = base.reduced(
            n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
            d_ff=2048, vocab_size=32000, microbatch_size=4,
        )
        steps, batch = 200, 8
        seq = 257
    else:
        cfg = base.reduced(n_layers=4, d_model=128, n_heads=4, n_kv_heads=4,
                           head_dim=32, d_ff=256, vocab_size=2048)
        steps, batch = (12 if os.environ.get("SC_SMOKE") else 40), 8
        seq = 129
    cfg = dataclasses.replace(cfg, remat_policy="planner")
    n_params = cfg.param_count()
    print(f"training {cfg.name}: {n_params/1e6:.1f}M params, {steps} steps")

    res = run_training(
        cfg,
        LoopConfig(steps=steps, batch_size=batch, ckpt_every=max(steps // 4, 1),
                   ckpt_dir=f"{args.out}/ckpts", data_dir=f"{args.out}/data"),
        DataConfig(n_shards=4, docs_per_shard=128, doc_len=1024,
                   vocab_size=cfg.vocab_size, seq_len=seq),
        AdamWConfig(lr=3e-3 if not args.full else 6e-4, warmup_steps=20),
        on_step=lambda s, m: (
            print(f"  step {s:4d} loss {float(m['loss']):.4f}", flush=True)
            if s % max(steps // 10, 1) == 0 else None
        ),
        device=dev,
    )
    print(f"loss: {res['losses'][0]:.4f} -> {res['losses'][-1]:.4f}")
    assert res["losses"][-1] < res["losses"][0], "loss must decrease"
    print("checkpoints written with write-behind persistence; rerun the same "
          "command to observe crash-resume from LATEST.")
    print("launches " + json.dumps({**dataplane.launches, **ops.launches,
                                    **ops.variant_launches}))


if __name__ == "__main__":
    main()
