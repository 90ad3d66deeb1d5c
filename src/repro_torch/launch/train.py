"""Training launcher: the S/C-scheduled data pipeline, the train step and
write-behind checkpointing on one device, with a reduced config for the
CPU.

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b \
        --reduced --steps 50 --batch-size 8 --device cpu

Without ``--device`` it runs on the card (and refuses to run without one).
"""
from __future__ import annotations

import argparse
import dataclasses

from ..configs import get_config
from ..data import DataConfig
from ..device import resolve_device
from ..train.loop import LoopConfig, run_training
from ..train.optimizer import AdamWConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced same-family config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=129)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="results/train/ckpts")
    ap.add_argument("--data-dir", default="results/train/data")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--remat", default=None,
                    choices=[None, "none", "block", "dots", "planner"])
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.remat:
        cfg = dataclasses.replace(cfg, remat_policy=args.remat)

    dcfg = DataConfig(seq_len=args.seq_len, vocab_size=min(cfg.vocab_size, 1000))
    loop = LoopConfig(
        steps=args.steps,
        batch_size=args.batch_size,
        ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir,
        data_dir=args.data_dir,
        compress_grads=args.compress_grads,
    )

    def on_step(step, metrics):
        if step % max(args.steps // 10, 1) == 0:
            print(f"step {step:5d}  loss {float(metrics['loss']):.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"lr {float(metrics['lr']):.2e}", flush=True)

    res = run_training(cfg, loop, dcfg, AdamWConfig(lr=args.lr, warmup_steps=10),
                       on_step=on_step, device=dev)
    print(f"\nfinal loss: {res['losses'][-1]:.4f}  "
          f"(first: {res['losses'][0]:.4f}; resumed_from={res['resumed_from']}; "
          f"device={dev})")
    if res["preempted"]:
        print("exited on preemption signal (checkpoint flushed)")


if __name__ == "__main__":
    main()
