"""Serving launcher: batched prefill + greedy decode on one device.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-12b \
        --reduced --batch 4 --prompt-len 16 --max-new 16 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \
        --reduced --device cpu

Without ``--device`` it runs on the card (and refuses to run without one). A
Mamba-2 prompt's length must be at most 64 or a multiple of 64 (the SSD
scan's chunk), as in the JAX package.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config
from ..device import resolve_device
from ..models import init_params
from ..serve.step import greedy_generate


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="stablelm-12b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    prompt = torch.from_numpy(np.random.default_rng(args.seed + 1).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len)))
    t0 = time.perf_counter()
    out = greedy_generate(cfg, params, prompt, args.max_new, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    toks = args.batch * args.max_new
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"new={args.max_new} device={dev}")
    print(f"generated {toks} tokens in {dt:.2f}s ({toks / dt:.1f} tok/s)")
    print("sample:", out[0, :12].tolist())


if __name__ == "__main__":
    main()
