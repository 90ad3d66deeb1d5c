"""Batched serving example on the PyTorch port: prefill a prompt batch, then
greedy-decode with the KV / SSD-state cache, for an audio model (EnCodec
tokens) and a hybrid Jamba-family model whose cache mixes KV tensors and
Mamba-2 states and whose feed-forwards mix dense MLPs and MoE layers (the
walkthrough of ``examples/serve_lm.py`` on ``repro_torch``).

    PYTHONPATH=src python examples/serve_lm_torch.py
    SC_SMOKE=1 PYTHONPATH=src python examples/serve_lm_torch.py --device cpu

Everything runs on ``--device`` (default: the card, where the reduced models
are bf16 and RMSNorm and the SSD scan of a prefill run as the port's CUDA
kernels; ``cpu`` runs their plain versions). The last line gives the
kernels' launches.
"""
import argparse
import json
import os
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import init_params
from repro_torch.serve.step import greedy_generate

ARCHS = ("musicgen-large", "jamba-v0.1-52b")
BATCH, PROMPT = 4, 12


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="where the models and caches live (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    max_new = 4 if os.environ.get("SC_SMOKE") else 12  # CI-sized variant

    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        prompt = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (BATCH, PROMPT)))
        t0 = time.perf_counter()
        out = greedy_generate(cfg, params, prompt, max_new, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        assert out.shape == (BATCH, max_new)
        assert bool(((out >= 0) & (out < cfg.vocab_size)).all()), "token out of range"
        print(f"{arch:18s} ({cfg.family:6s}): generated {tuple(out.shape)} in {dt:.2f}s "
              f"-> {out[0, :8].tolist()}")
    print("decode caches validated against full-forward logits in "
          "tests/test_torch_moe.py and tests/test_torch_mamba.py")
    print("launches " + json.dumps({**ops.launches, **ops.variant_launches}))


if __name__ == "__main__":
    main()
