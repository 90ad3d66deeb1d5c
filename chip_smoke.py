#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
Hopper card.

    python3 chip_smoke.py
    python3 chip_smoke.py --only kernels,train   # card and build, then these

Phases, in order; any failure raises and exits non-zero (``--only`` runs the
card and build phases and then the named ones of lint, kernels, multihost,
mqo, examples, serve, moe, mamba, train and shard, and prints no kernels or
result line):

1. card    — the card's name and power limit (``nvidia-smi``);
2. build   — ``nvcc`` for every CUDA source of the port, all in parallel
             (the f32 and bf16 flash sources as five and three translation
             units, ``native.PARTS``), each source's and unit's seconds
             logged, and
             ``ptxas -v`` (registers, spills; each instantiation of
             the flash kernels by name); the SASS of the tensor-core
             forward, dq and dk/dv kernels (dk/dv also at head dims 160
             and 256) must hold bf16 HMMA in their main loops, and dk/dv at
             160 and 256 must not spill; the f32 backward pair must not
             spill at head dims 80 and 160, and its SASS there must hold no
             tensor-core instruction (its main loops' FFMA, LDS, LDGSTS and
             BAR counts logged);
3. lint    — ``tools/sc_lint_torch.py``'s six passes on the card (source,
             ptx, delta-safety, plan, mqo, fixtures): the PTX lints read
             every kernel of ``csrc/dataplane.cu`` as ``nvcc`` compiles it
             now (no ``lint-skipped`` finding; PTX instructions read per
             kernel logged), the two MAP fixtures compiled fresh must fire
             as their committed PTX does (the legacy map both
             ``transcendental-kernel`` and ``fma-contraction``, the shipped
             map nothing), and no gating finding may lie outside
             ``tools/sc_lint_torch_baseline.json``;
4. kernels — each hand-written kernel against its plain PyTorch version on
             the card: the data-plane kernels bitwise at the main path's
             shapes (16,777,216 rows; a 4,194,304-key join index; P = 8
             partitions, and P = 4096 and 100,003 across the shared-memory
             histogram limit, on uniform and Zipf(1.3) keys), with edge
             cases (f32 and f64 columns off 16 bytes: the vector compare
             after its head; the scalar compare on the same column; INT64_MIN
             in an int64 MAP column, NaN, +-inf and values past 2^63 for
             the encode); RMSNorm (with and without residual, and the scalar
             kernel on rows off 16 bytes) and the
             flash-attention forward within the JAX kernel tests'
             tolerances at the serving path's shapes (rows of 5120;
             b 4, 32 query over 8 kv heads, 544 positions, head dim 160),
             f32 and bf16, with ragged and sq != sk cases (bf16 on the
             tensor cores, f32 on the CUDA cores); the two
             flash-attention backward kernels (dq, dk/dv) within 2e-4 / 3e-2
             at the training path's shape (b 2, 32 over 32 heads, 4096
             positions, head dim 80, causal; the forward there too), the
             serving shape (GQA), a ragged non-causal, a causal sq != sk
             and a keyless case, and in bf16 the wide heads' training
             shapes (stablelm-12b: b 2, 32 over 8 heads of 160; gemma-7b:
             16 over 16 heads of 256; qwen2-moe-a2.7b: 16 over 16 heads of
             128; 4096 positions, causal) and, in
             bf16, the examples path's shapes (``train_lm``: RMSNorm on
             256 rows of 128, the forward and both backward kernels at b
             2, 4 over 4 heads of 32, 128 positions, causal); RMSNorm at
             the moe phase's widths (2048, 4096, 8192: prefill and decode
             rows in bf16, the oracles' in f32) and serve_lm's (64, 128);
             the f32 forward at the moe phase's oracles' shapes (4 x 16/16
             x 544 and 4 x 32/8 x 576, head dim 128); the SSD
             scan within 2e-4 / 5e-2 at the Mamba-2 serving prefill (b 4,
             512 positions, 80 heads of 64,
             state 128; f32 and bf16), the long prefill (1 x 32768, bf16),
             jamba's prefill (4 x 512, 128 heads of 64, state 16, bf16)
             and its oracle's forward (4 x 576, f32), serve_lm's reduced
             jamba (4 x 12, 8 heads of 16, state 16, bf16),
             a reduced s = chunk = 20 case, the impulse case and one case
             against the exact recurrence, and its final state within 1e-4
             of ||want|| of the plain version's and of the whole-prefix
             closed form (f64); the scan's five gradients through
             ``SSDScan`` (the kernels forward, the closed-form backward in
             PyTorch ops) against autograd of the plain version in f32
             at mamba2's training microbatch (2 x 4096, 80 heads of 64,
             state 128) and jamba's prefill, bf16 and f32, within the
             scan's tolerances, the backward timed beside the forward and
             its working set held within ``WORKSPACE_BYTES``; kernel, plain and library-call
             times from CUDA events, the kernel's and the library call's
             device time alone (``device_ms``: CUPTI under
             ``torch.profiler``), the kernels each library call ran (SDPA's
             backward: those its forward did not run), each flash case's
             dq + dk/dv device time beside SDPA's backward, and the
             forward+backward pair against SDPA's;
5. main    — one S/C refresh round: ``generate_workload(12, seed=4)``
             realized at 512 MiB per root on the card, run serially (the
             serial run is the calibration run: its manifest sizes the
             nodes), solved for a 1.6 GB Memory Catalog, run with S/C; the
             S/C output must be bitwise the serial output, the catalog
             within budget, and every kernel of the round launched; the S/C
             round then runs once more under ``torch.profiler`` for the
             device's busy share; the (L, n) shapes of the join probe's
             launches are logged;
6. part    — the same calibrated workload through an incremental scenario
             (one round of 10% ingest, 5% update, 2% delete after the
             build), hash-partitioned P = 8 ways and unpartitioned, with the
             1.6 GB catalog: the partitioned stores must reassemble bitwise
             to the unpartitioned ones, every round's catalog stay within
             budget, and ``pid_hist`` and the weighted encode launch; the
             probe's launch shapes are logged, and the probe is held and
             timed once more at the partitioned path's commonest shape;
             the P = 8 store is kept for the next phase;
7. multihost — the same scenario's P = 8 partitions hash-placed on 4
             hosts (``run_multihost_scenario``, the process backend), 0.4
             GB of catalog each, no straggler speculation: run A
             fault-free, run B with host 1 killed after its first task of
             the incremental round; each in a fresh interpreter
             (``--multihost-child``) whose coordinator touches CUDA only
             after the pool forked its hosts, so the four hosts compute on
             the card, each with its own context. Both stores bitwise equal
             to the P = 8 store (one pass after both runs: each oracle table
             read once); B loses host 1 and re-dispatches only from
             it, A nothing; every surviving host's catalog empty at each
             round's end and within its budget at its peak; the hosts'
             shipped launches must hold filter_gt, map_derived,
             fixed_point_encode (weighted too), probe_sorted and pid_hist.
             Round walls beside the single-host P = 8 rounds, per-host
             tasks, hits and peaks, re-dispatches, the card's peak used
             memory (``nvidia-smi``, every process), the children's
             start-up and the verify seconds are logged (``--only
             multihost`` calibrates in memory and builds its own P = 8
             store);
8. mqo     — ``shared_prefix_workload(3)`` (a fact and a dim scan, three
             views sharing a FILTER -> JOIN prefix: 23 nodes) realized at
             512 MiB per root on the card, calibrated in memory (the sizes
             ``calibrate_sizes`` gives, checked at 4 MiB in phase 9, without
             writing every MV), merged there (19
             nodes), then the part phase's incremental scenario unshared
             and merged, the merged run traced (``obs.trace``): every view
             bitwise equal unshared vs merged, each shared class once a
             round, every round's catalog within budget, the FILTER, MAP,
             AGG-encode and probe kernels launched, no gating delta-safety
             finding, ``check_merged`` silent on the merge and
             ``unsound-merge`` on the forged fixture, a valid Chrome trace
             (written to a temporary directory); round times, flagged
             sets, launches, peak memory and the plan audit logged;
9. cpu     — the round, the partitioned scenario (two incremental rounds)
             and the MQO merge's scenario, at 4 MiB per root on
             the card and on the CPU (plain versions): every stored MV and
             partition bitwise equal, both partitioned stores equal to
             a full-recompute scenario on the card, and the same merge
             fingerprints on both;
10. examples — the port's eight examples (``examples/*_torch.py``:
             quickstart, mv_refresh_pipeline, incremental_refresh,
             update_delete_refresh, partitioned_refresh, traced_refresh,
             train_lm, serve_lm) with ``SC_SMOKE=1`` on the card, each in its own
             interpreter with its own time limit, all eight started
             together; each must exit 0 (their
             own asserts: bitwise stores, a falling loss), and each one's
             seconds and kernel launches are logged; the MV examples
             together must launch filter_gt, map_derived,
             fixed_point_encode, probe_sorted and pid_hist, and train_lm
             RMSNorm and the bf16 flash forward, dq and dk/dv (head dim 32)
             on the tensor cores, serve_lm RMSNorm and the SSD scan (held
             against their plain versions at these shapes in the kernels
             phase);
11. serve  — stablelm-12b at full width and depth (40 layers, bf16,
             random weights from a seeded generator on the card) answers 4
             requests of 512-token prompts with 32 greedy tokens each
             through ``greedy_generate``: RMSNorm must launch 81 times per
             forward, its residual variant and the flash kernel never (as
             in the JAX path); a
             prefill and a window of decode steps under ``torch.profiler``
             give the device's busy share and top kernels. Then the
             serving oracle at full width in f32, depth cut to 2 layers:
             prefill + teacher-forced decode logits against the
             cache-less forward (which runs the flash kernel) within 2e-2;
             then reduced stablelm-12b with GQA in f32, card against CPU:
             the same greedy tokens, logits within 1e-4;
12. moe    — qwen2-moe-a2.7b at full width and depth (24 layers, 60
             experts top-4 and 4 shared, bf16) and jamba-v0.1-52b at full
             width, its depth cut to one superblock of 8 layers (7 Mamba-2,
             1 attention, 4 MoE of 16 experts top-2), each answering 4
             requests of 512-token prompts with 32 greedy tokens at the
             configs' capacity factor 1.25: launches as the layer pattern
             predicts (RMSNorm at every norm, the SSD scan once per Mamba-2
             layer per prefill, no flash kernel); the (token, expert) pairs
             one prefill and one decode step drop; a profiled prefill and
             decode window. Each one's oracle in f32, drop-free at capacity
             factor 16.0 (qwen2-moe at 2 layers, jamba at its 8), prefill +
             teacher-forced decode against the cache-less forward within
             2e-2, and jamba's again with dense FFNs in its MoE layers'
             place; each oracle logs where its difference lies, the
             model's gain (its logits' move under a 1-ulp embedding
             change), and checks the first Mamba-2 layer's prefill +
             decode against its scan within 1e-4 of its largest output
             (the mamba phase's oracle too). Then reduced qwen2-moe, jamba, llava-next-34b (seeded
             patch embeddings) and musicgen-large in f32, card against CPU:
             the same greedy tokens, logits within 1e-4;
13. mamba  — mamba2-2.7b at full width and depth (64 layers, bf16, random
             seeded weights) answers 4 requests of 512-token prompts with
             64 greedy tokens each, then prefills one 32768-token prompt:
             RMSNorm must launch 129 times per forward, the SSD scan 64
             times per prefill, no flash kernel; a profiled prefill and
             decode window; the long prefill's profile must hold no scan
             kernel but the SSD scan's (the decode state comes from the
             scan, not a whole-prefix cumsum); the oracle at full width in
             f32 and 2 layers over 512 + 64 positions within 2e-2; reduced
             mamba2 card
             against CPU: the same greedy tokens, logits within 1e-4;
14. train  — the training data (4 shards of 64 x 512 tokens, vocab
             50280, 4097-token rows) materialized by S/C on the card, then
             ``run_training`` of stablelm-3b at full width and depth (32
             layers, d_model 2560, bf16, f32 AdamW moments, remat
             ``block``): 2 steps of 4 rows of 4096 tokens in 2 microbatches;
             finite losses and grad norms, the kernels' launches equal to
             the count the code predicts, step seconds, tokens/s, peak
             device memory, the final write-behind save, every flash
             launch on the tensor cores; one more step
             under ``torch.profiler``. Then stablelm-12b at full width
             (d_model 5120, 32 over 8 heads of 160, d_ff 13824, vocab
             100352) with its depth cut to 4 layers, the same way (its
             final save too), so the wide bf16 dk/dv kernel runs on a
             training path. Then mamba2-2.7b at full width and depth
             (state 128, 64 SSD layers), the same way: the SSD scan's kernels
             twice a layer (forward and recompute), its backward in PyTorch
             ops, no flash; the profiled step also gives the SSD backward's
             device time by op and its share of the step. Then
             qwen2-moe-a2.7b at full width (60 experts top-4 of 1408 and 4
             shared, 16/16 heads of 128, vocab 151936) with its depth cut
             to 4 layers (2,904,541,184 parameters), the same way: the MoE
             layer's routing, dispatch and expert ``bmm`` under grad,
             launches as predicted with every flash launch on the tensor
             cores, and the profiled step split into the experts' ``bmm``,
             the routing and dispatch ops, the other GEMMs and flash. One
             full-width MoE layer's forward and backward on a training
             microbatch twice: every gradient bitwise equal (and the
             earlier dispatch's gather, ``xf[token_of]``, its backward
             twice, logged). Then reduced stablelm-3b with GQA, reduced
             mamba2, reduced qwen2-moe and reduced jamba (one pattern of 8
             layers) in f32, card against CPU (two train steps agree; the
             CPU launches no kernel; the MoE models' top-k sets compared
             token by token); reduced qwen2-moe's gradients under remat
             ``block`` bitwise those under ``none`` on the card;
             ``ef_compress_tree`` on the card bitwise the CPU's on reduced
             stablelm-3b's card gradients, and 2 compressed train steps on
             the card; a bitwise checkpoint save/restore round trip of the
             plain and the compressed states (its errors too);
15. shard  — the sharded steps: an unsharded twin in its own interpreter
             and four ranks (``--shard-child``; they read the twin's
             results as it writes them) sharing the card as a
             2 x 2 data x model mesh on gloo (NCCL refuses ranks that share
             a device), every rank's weights drawn from the twin's seed on
             the card, its shard kept. Reduced qwen2-moe in f32 under FSDP
             off and on with the gather and the expert-parallel MoE (a
             train step of dp 2 in 2 microbatches, a prefill and 4 decode
             steps), each within 1e-4 of the twin's; qwen2-moe-a2.7b at
             full width cut to 4 layers, bf16, capacity 1.25: one FSDP train
             step (the loss within 1e-2, the gradients' global norm, three
             tensors' first moments and updated parameters within limits
             set from runs), a prefill of 4 x 512 tokens and 16 decode
             steps fed the twin's tokens (their logits' errors logged),
             and the same calls on the twin's own inputs sub-layer by
             sub-layer, the gate (each output and the head within 1e-2,
             the same routing and dropped pairs). Then the Mamba-2 and
             hybrid layers on the same mesh: reduced mamba2-2.7b and reduced
             jamba-v0.1-52b (one pattern of 8 layers) in f32 under FSDP off
             and on, as the small qwen2-moe cases, and besides
             ``greedy_generate`` on the mesh (the twin's tokens exactly) and
             ``elastic_restore`` of the twin's train state checkpoint onto
             each rank's shards (bitwise); mamba2-2.7b at full width cut to
             4 layers, bf16 (40 of 80 SSD heads a rank): one FSDP train step
             held as qwen2-moe's, a prefill of 4 x 512 and 16 decode steps
             fed the twin's tokens (logits within 1e-2), ``greedy_generate``
             on the mesh (its tokens against the twin's logged); each
             rank's errors, collective calls and bytes by kind (the gated
             norm's gather under its tag), host-staged bytes, walls, peak
             memory and launches (RMSNorm, the three flash kernels and the
             SSD scan, the same on every rank) logged, and the card's peak
             over every process (``nvidia-smi``, within 72 GB);
16. a JSON line listing every kernel and variant with its launches over
   every path (the multi-host path's also alone: ``multihost_launches``),
   its times (event windows and device alone), its bound and
   its worst error over its cases; then the JSON result line.

Exits with 2, printing no result, when CUDA is unavailable or the port's
sources are not beside this script.
"""
from __future__ import annotations

import collections
import concurrent.futures as cf
import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
N_ROWS = 16_777_216           # rows of one scan table at 512 MiB per root
N_INDEX = 4_194_304           # join-index keys (distinct keys of a scan)
MAIN_BYTES_PER_ROOT = 512 << 20
MAIN_BUDGET = 1.6e9           # the paper's Memory Catalog
SMALL_BYTES_PER_ROOT = 4 << 20
PEAK_FLOPS = 67e12            # f32 outside the tensor cores, H100 SXM
PEAK_BF16_FLOPS = 989e12      # bf16 tensor cores, dense, H100 SXM
ISSUE_PER_SM = 128            # 4 warp schedulers x 32 lanes per clock
I64MAX = (1 << 63) - 1
I64MIN = -(1 << 63)
N_PARTITIONS = 8
SCENARIO = dict(mode="incremental", ingest_frac=0.1, update_frac=0.05,
                delete_frac=0.02, n_rounds=2)
# Incremental rounds of the 512 MiB scenario: cut from 2 to keep the whole
# script near 400 s (396-443 s on an H100 with 2; storage fsync dominates).
MAIN_SCENARIO_ROUNDS = 1
# The kernels of the one-round main path; pid_hist joins them on the
# partitioned path, and hash64 lies on neither (as in the reference, only
# partition._hash64 reaches it).
ROUND_KERNELS = ("filter_gt", "map_derived", "fixed_point_encode", "probe_sorted")
# The multi-host path: the P = 8 scenario's partitions hash-placed on 4
# forked hosts sharing the card, each with a quarter of the paper's 1.6 GB
# catalog; run B kills host 1 after its first task of the incremental round.
MH_HOSTS = 4
MH_HOST_BUDGET = MAIN_BUDGET / MH_HOSTS
MH_KILL = dict(kind="kill", host=1, round_idx=1, after_tasks=1)
MH_KERNELS = (*ROUND_KERNELS, "pid_hist", "fixed_point_encode/weighted")
MH_ROUND_TIMEOUT = 600.0      # a stuck host raises well inside the script's limit
MH_CHILD_TIMEOUT = 900.0
# The MQO path: three views over one fact / dim scan pair sharing a
# FILTER -> JOIN prefix (23 nodes; the merge keeps 19).
MQO_VIEWS = 3
MQO_NODES = (23, 19)
MQO_SHARED = ("v0_filter", "v0_join")
# SASS functions of the two integer kernels, whose operation bound is their
# instructions per row (read from the build) over the card's issue rate.
HASH_SASS = {"hash64": "hash64_kernel", "pid_hist": "pid_hist_kernelILb1"}
# SASS functions of the tensor-core flash kernels at the training path's
# head dim (80, 16-byte copies), and of dk/dv at the wide heads' 160 and
# 256 (two warps per 16 kv rows), whose main loops must run on bf16 HMMA.
MMA_SASS = {"flash_fwd": "flash_fwd_mma_kernelILi80ELb1E",
            "flash_bwd_dq": "flash_bwd_dq_mma_kernelILi80ELb1E",
            "flash_bwd_dkv": "flash_bwd_dkv_mma_kernelILi80ELb1E",
            "flash_bwd_dkv@160": "flash_bwd_dkv_mma_kernelILi160ELb1E",
            "flash_bwd_dkv@256": "flash_bwd_dkv_mma_kernelILi256ELb1E"}
# Instantiations that must not spill (ptxas -v), by source: the split
# tensor-core dk/dv kernels, and the f32 backward pair at the training
# path's head dim 80 and the serving oracle's 160 (both alignments).
NO_SPILL = {"flash_attention_mma": ("flash_bwd_dkv_mma_kernelILi160E",
                                    "flash_bwd_dkv_mma_kernelILi256E"),
            "flash_attention": ("flash_bwd_dq_kernelILi80E", "flash_bwd_dq_kernelILi160E",
                                "flash_bwd_dkv_kernelILi80E", "flash_bwd_dkv_kernelILi160E")}
# SASS functions of the f32 backward pair (16-byte copies) at head dims 80
# and 160, whose every product must stay an f32 FMA: no tensor-core
# instruction anywhere in them.
CUDA_CORE_SASS = {"flash_bwd_dq@80": "flash_bwd_dq_kernelILi80ELb1E",
                  "flash_bwd_dkv@80": "flash_bwd_dkv_kernelILi80ELb1E",
                  "flash_bwd_dq@160": "flash_bwd_dq_kernelILi160ELb1E",
                  "flash_bwd_dkv@160": "flash_bwd_dkv_kernelILi160ELb1E"}

# The port's examples (examples/<name>_torch.py), each run at its SC_SMOKE
# sizes in its own interpreter, all at once: one after another they took
# 93.1 s on an H100 (each ~10 s to reach the card), past what the script's
# limit leaves. The model kernels train_lm must launch on the card (bf16,
# head dim 32: the tensor-core variants), and serve_lm's (RMSNorm at every
# forward, the SSD scan at its reduced jamba's prefill; bf16).
EXAMPLES = ("quickstart", "mv_refresh_pipeline", "incremental_refresh",
            "update_delete_refresh", "partitioned_refresh", "traced_refresh",
            "train_lm", "serve_lm")
EXAMPLE_TIMEOUT = 300.0
MODEL_EXAMPLE_KERNELS = {
    "train_lm": ("rmsnorm", "flash_fwd/mma", "flash_bwd_dq/mma", "flash_bwd_dkv/mma"),
    "serve_lm": ("rmsnorm", "ssd_scan"),
}
# The shapes train_lm gives them at its SC_SMOKE size (stablelm-3b reduced to
# d_model 128, 4/4 heads of 32; 8 rows a step in microbatches of 2, 128
# positions), held against their plain versions in the kernels phase.
TRAIN_LM_SHAPE = (2, 4, 4, 128, 128, 32, True)   # (b, hq, hkv, sq, sk, d, causal)
TRAIN_LM_NORM = (2 * 128, 128)                   # one microbatch's rows, d_model

# Which Pallas kernel each port kernel replaces (JAX package, file:line).
REPLACES = {
    "filter_gt": "src/repro/mv/dataplane.py:364",
    "filter_gt_scalar": "src/repro/mv/dataplane.py:364",
    "map_derived": "src/repro/mv/dataplane.py:376",
    "fixed_point_encode": "src/repro/mv/dataplane.py:395",
    "probe_sorted": "src/repro/mv/dataplane.py:421",
    "hash64": "src/repro/mv/dataplane.py:300",
    "pid_hist": "src/repro/mv/dataplane.py:325",
}
REPLACES.update({
    "rmsnorm": "src/repro/kernels/rmsnorm.py:17",
    "rmsnorm_residual": "src/repro/kernels/rmsnorm.py:25",
    "rmsnorm_scalar": "src/repro/kernels/rmsnorm.py:17",
    "flash_fwd": "src/repro/kernels/flash_attention.py:41",
    "flash_bwd_dq": "src/repro/kernels/flash_attention.py:167",
    "flash_bwd_dkv": "src/repro/kernels/flash_attention.py:209",
    "ssd_scan": "src/repro/kernels/ssd_scan.py:28",
})
REPLACES.update({f"{k}_cuda_core": REPLACES[k]
                 for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")})
SOURCE = "src/repro_torch/csrc/dataplane.cu"
# flash_fwd, flash_bwd_dq and flash_bwd_dkv are the bf16 tensor-core
# kernels; *_cuda_core the CUDA-core kernels that f32 (and dk/dv above head
# dim 128) take.
MODEL_SOURCES = {"rmsnorm": "src/repro_torch/csrc/rmsnorm.cu",
                 "rmsnorm_residual": "src/repro_torch/csrc/rmsnorm.cu",
                 "rmsnorm_scalar": "src/repro_torch/csrc/rmsnorm.cu",
                 "flash_fwd": "src/repro_torch/csrc/flash_attention_mma.cu",
                 "flash_fwd_cuda_core": "src/repro_torch/csrc/flash_attention.cu",
                 "flash_bwd_dq": "src/repro_torch/csrc/flash_attention_mma.cu",
                 "flash_bwd_dq_cuda_core": "src/repro_torch/csrc/flash_attention.cu",
                 "flash_bwd_dkv": "src/repro_torch/csrc/flash_attention_mma.cu",
                 "flash_bwd_dkv_cuda_core": "src/repro_torch/csrc/flash_attention.cu",
                 "ssd_scan": "src/repro_torch/csrc/ssd_scan.cu"}
# The launch counters of the flash kernels' two variants (kernels.cuda).
FLASH_VARIANTS = ("flash_fwd/mma", "flash_fwd/cuda_core", "flash_bwd_dq/mma",
                  "flash_bwd_dq/cuda_core", "flash_bwd_dkv/mma", "flash_bwd_dkv/cuda_core")
# The serving path: stablelm-12b at full width, 4 requests of 512-token
# prompts, 32 new tokens each; the oracle cuts depth to 2 layers (f32).
SERVE_ARCH = "stablelm-12b"
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 512, 32
ORACLE_LAYERS = 2
PROFILE_STEPS = 8             # decode steps in the serving profile window
# Mamba-2 serving: mamba2-2.7b at full width and depth, 4 requests of
# 512-token prompts, 64 new tokens each, and one prompt of prefill_32k's
# 32768 tokens (batch cut from 32 to 1); the oracle as above over 512 + 64
# positions (a multiple of the scan's 64-position chunk).
MAMBA_ARCH = "mamba2-2.7b"
MAMBA_BATCH, MAMBA_PROMPT, MAMBA_NEW, MAMBA_LONG = 4, 512, 64, 32768
# The MoE and hybrid serving paths: qwen2-moe-a2.7b at full width and depth
# and jamba-v0.1-52b at full width, its depth cut from 32 layers to one
# superblock of 8 (7 Mamba-2 + 1 attention, 4 MoE of 16 experts top-2; the
# whole model is 103 GB in bf16), each answering the serving path's
# requests at the configs' capacity factor 1.25, where tokens drop. The
# oracles run drop-free at 16.0 (tests/models/test_decode.py): qwen2-moe at
# ORACLE_LAYERS, jamba at its 8 layers in f32 (~53 GB), over 512 + 64
# positions (a multiple of the scan's chunk, as the Mamba-2 oracle).
MOE_ARCH, JAMBA_ARCH, JAMBA_LAYERS = "qwen2-moe-a2.7b", "jamba-v0.1-52b", 8
MOE_ORACLE_CAPACITY = 16.0
JAMBA_ORACLE_NEW = 64
# the f32 flash forward of the two oracles' cache-less forwards (head dim 128)
MOE_ORACLE_SHAPE = (SERVE_BATCH, 16, 16, SERVE_PROMPT + SERVE_NEW,
                    SERVE_PROMPT + SERVE_NEW, 128, True)
JAMBA_ORACLE_SHAPE = (SERVE_BATCH, 32, 8, SERVE_PROMPT + JAMBA_ORACLE_NEW,
                      SERVE_PROMPT + JAMBA_ORACLE_NEW, 128, True)
# RMSNorm (rows, width, dtype) at the MoE phase's shapes: qwen2-moe's d 2048
# and jamba's d 4096 and gated d_inner 8192 at a prefill of 4 x 512 and a
# decode step of 4 (bf16), the oracles' cache-less forwards (f32); and the
# serve_lm example's reduced models (d 64, d_inner 128; 4 x 12 prompts)
MOE_NORMS = ((2048, 2048, "bfloat16"), (4, 2048, "bfloat16"), (2048, 4096, "bfloat16"),
             (4, 4096, "bfloat16"), (2048, 8192, "bfloat16"), (4, 8192, "bfloat16"),
             (4 * 544, 2048, "float32"), (4 * 576, 4096, "float32"),
             (4 * 576, 8192, "float32"), (48, 64, "bfloat16"), (48, 128, "bfloat16"),
             (4, 64, "bfloat16"), (4, 128, "bfloat16"))
# Tolerances of the JAX kernel tests (tests/kernels/): one bf16 rounding of
# the output, or f32 sums taken in another order.
RMS_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
ATTN_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
SSD_TOL = {"float32": 2e-4, "bfloat16": 5e-2}   # tests/kernels/test_ssd_scan.py
ORACLE_TOL = 2e-2             # tests/models/test_decode.py
CARD_CPU_LOGIT_TOL = 1e-4     # f32 on both sides, sums in another order
# The flash backward: the JAX gradient test's 2e-4 in f32; in bf16 one
# rounding of each gradient, as the forward's 3e-2.
BWD_TOL = {"float32": 2e-4, "bfloat16": 3e-2}
# Every model kernel's output is also held to the data's own scale: its
# ||got - want|| / ||want||. One bf16 rounding of the output is at most
# 2^-8 of each element, about 2^-9 in the mean (2e-3); a kernel that drops
# or repeats a tile is off by the tile's share of the value. f32 sums taken
# in another order stay near 1e-6.
REL_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# The training path: stablelm-3b at full width and depth, train_4k's 4096
# positions, 4 rows a step in 2 microbatches of 2, for 2 steps. The data's
# token ids lie below 50280, mamba2-2.7b's vocabulary (held by stablelm-3b's
# 50304 and 12b's 100352): an id in a padded vocabulary's tail would meet a
# logit of -1e9.
TRAIN_ARCH = "stablelm-3b"
TRAIN_SEQ, TRAIN_ROWS, TRAIN_MICRO, TRAIN_STEPS = 4096, 4, 2, 2
TRAIN_DATA = dict(n_shards=4, docs_per_shard=64, doc_len=512, vocab_size=50280,
                  seq_len=TRAIN_SEQ + 1)
TRAIN_SHAPE = (2, 32, 32, TRAIN_SEQ, TRAIN_SEQ, 80, True)  # one microbatch's attention
# Then stablelm-12b at full width (d_model 5120, 32/8 heads of 160, d_ff
# 13824, vocab 100352), its depth cut from 40 to 4 layers (8 until the
# Mamba-2 training run joined the phase; 4 keeps the script inside its time
# limit): the path of the wide bf16 dk/dv kernel. The same rows, steps and
# data.
WIDE_TRAIN_ARCH, WIDE_TRAIN_LAYERS = "stablelm-12b", 4
WIDE_TRAIN_SHAPE = (2, 32, 8, TRAIN_SEQ, TRAIN_SEQ, 160, True)
GEMMA_TRAIN_SHAPE = (2, 16, 16, TRAIN_SEQ, TRAIN_SEQ, 256, True)   # gemma-7b's heads
# Then mamba2-2.7b at full width and depth (64 SSD layers), the same rows,
# steps and data: the SSD scan's forward kernels under remat and its
# closed-form backward in PyTorch ops (kernels.ssd_scan.SSDScan).
MAMBA_TRAIN_ARCH, MAMBA_TRAIN_LAYERS = "mamba2-2.7b", 64
# SSDScan's gradients held on the card at mamba2-2.7b's training
# microbatch (2, 4096, 80, 64, 128) and jamba's prefill (4, 512, 128, 64,
# 16), (b, s, h, p, n).
SSD_GRAD_SHAPES = ((TRAIN_MICRO, TRAIN_SEQ, 80, 64, 128), (4, 512, 128, 64, 16))
# The SSD backward's case and the training step whose profiles are also
# summed through key_averages, beside the raw events
SSD_SUM_CASE = f"{TRAIN_MICRO}x{TRAIN_SEQ}x80x64x128_L64_bfloat16"
SUM_TRAIN_ARCH = "stablelm-3b"
# Then qwen2-moe-a2.7b at full width (d_model 2048, 16/16 heads of 128, 60
# experts top-4 of width 1408 and 4 shared, vocab 151936), its depth cut
# from 24 to 4 layers (2,904,541,184 parameters; 24 layers' 14.3B do not
# train on one card): the MoE layer's routing, dispatch and expert products
# under grad, and the bf16 flash kernels at head dim 128. The same rows,
# steps and data.
MOE_TRAIN_ARCH, MOE_TRAIN_LAYERS = "qwen2-moe-a2.7b", 4
MOE_TRAIN_SHAPE = (2, 16, 16, TRAIN_SEQ, TRAIN_SEQ, 128, True)
# The profiled MoE step's device time by the PyTorch op that launched it:
# the routing and the dispatch (sort, searchsorted, top-k, the index ops)
ROUTING_OPS = ("aten::sort", "aten::searchsorted", "aten::topk", "aten::index",
               "aten::index_put_", "aten::_index_put_impl_", "aten::index_select",
               "aten::gather", "aten::scatter", "aten::scatter_add_", "aten::one_hot",
               "aten::where", "aten::_softmax", "aten::_softmax_backward_data")
GEMM_OPS = ("aten::mm", "aten::addmm")
SMALL_MAMBA_SEQ = 129     # reduced mamba2 card vs CPU: two chunks of 64
# Reduced jamba card vs CPU: one pattern (7 Mamba-2, 1 attention, 4 MoE),
# 128 tokens (two scan chunks) a row, each step held from the CPU state
# before it (train_card_vs_cpu(per_step=True)): on its own updates the
# card swaps some tokens' experts in step 2 (4 tokens on an H100).
SMALL_JAMBA_LAYERS = 8
# Card against CPU on reduced stablelm-3b, f32 on both sides, sums in
# another order (tests/test_torch_train.py's tolerances): one microbatch's
# gradients before any update within 1e-5 + 1e-4·|g|; after two steps
# loss and grad norm within 1e-5 relative and the moments within 2e-6 (m)
# and 2e-8 (v). Parameters: Adam's normalised update m/(sqrt(v) + eps)
# turns the last bits of a gradient near eps into a different fraction of
# a step, so an element may move by up to lr/4 more on one side (1.1e-3 at
# lr 1e-2 seen on an H100); at most 1e-3 of the elements may differ by more
# than 1e-5.
SMALL_TRAIN_OPT = dict(lr=1e-2, warmup_steps=2)
SMALL_TRAIN_TOL = {"loss": 1e-5, "grad_atol": 1e-5, "grad_rtol": 1e-4,
                   "params_max": SMALL_TRAIN_OPT["lr"] / 4, "params_close": 1e-5,
                   "params_share": 1e-3, "m": 2e-6, "v": 2e-8}


# The shard phase: four ranks sharing the card as a 2 x 2 data x model mesh
# (gloo: NCCL refuses ranks that share a device), each in a fresh
# interpreter (``--shard-child``), against the port's unsharded twin run
# first in an interpreter of its own. The small model is the reference's
# own reduction of qwen2-moe-a2.7b (tests/sharding/test_strategy.py:95) in
# f32, drop-free (16.0), under FSDP off and on with the gather and the
# expert-parallel dispatch: a train step (8 rows of 16 tokens, dp 2, 2
# microbatches), a prefill of 4 x 12 tokens and 4 decode steps, each within
# 1e-4 of ||want|| (a parameter's elements whose gradient is near zero
# aside, as in the CPU tests). Full width: qwen2-moe-a2.7b at the
# train-qwen2-moe-a2.7b-4L cell's 4 of 24 layers, bf16, capacity 1.25: one
# FSDP train step of 2 rows (one a data rank) of 2048 tokens, then a
# prefill of 4 x 512 tokens and 16 decode steps fed the twin's greedy
# tokens on the TP x DP layout without FSDP (the per-step weight gathers
# over gloo would take ~3 s a step). The train step: the loss within 1e-2
# relative; the gradients' global norm, and for SHARD_CHECKED the first
# moments' norms (after one step m = 0.1 g: each tensor's gradient after
# the data sums and FSDP's reduce-scatter) and the updated parameters
# element by element (the update, the ZeRO-1 parts and the gather back,
# as ||got - want|| / ||want - before||) within SHARD_TRAIN_TOL, limits
# set from runs' readings (PERF.md). The step's learning rate is the full
# 3e-4 (warm-up of 1 step): at the default warm-up's 3e-6 a bf16 weight
# of ~0.02 would not move. The same serving calls replayed on the twin's
# own inputs, sub-layer by sub-layer (shard_serve(feed=)) are the gate:
# each mixer's and MoE's output and the head's logits within 1e-2 of
# ||want||, at most 1% of tokens with another top-k set, and a call whose
# top-k sets agree on every token keeps exactly the twin's pairs. The
# free-running calls' logits are logged, not held: top-k routing on
# near-uniform random routers turns bf16 sums taken in another order into
# other experts, more with every layer (2.8-4.6e-2 of ||want||, PERF.md).
# The card's peak over every process must stay within 72 GB.
SHARD_WORLD, SHARD_MESH = 4, (2, 2)
SHARD_SEED = 11
SHARD_SMALL = dict(d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256,
                   moe_experts=8, moe_top_k=2, head_dim=16, dtype="float32",
                   moe_capacity_factor=16.0)
SHARD_SMALL_CASES = ((False, "gather"), (False, "shard_map_ep"), (True, "gather"),
                     (True, "shard_map_ep"))
SHARD_SMALL_ROWS, SHARD_SMALL_SEQ, SHARD_SMALL_PROMPT = 8, 16, 12
SHARD_SMALL_TOL = 1e-4
SHARD_NEAR_ZERO = 2e-3
SHARD_FULL_LAYERS = 4
SHARD_TRAIN_ROWS, SHARD_TRAIN_SEQ = 2, 2048
SHARD_SERVE_BATCH, SHARD_SERVE_PROMPT, SHARD_SERVE_NEW = 4, 512, 16
SHARD_FULL_TOL = 1e-2
SHARD_FULL_OPT = dict(warmup_steps=1)
SHARD_CHECKED = ("embed", "layers.0.ffn.w_in", "lm_head")
# read on an H100 (PERF.md): grad_norm 4.2e-4, m norms 1.1e-5-3.2e-4,
# updates 0.046-0.28 (a shard laid out wrong reads ~1.4)
SHARD_TRAIN_TOL = {"grad_norm": 2e-3, "m_norm": 2e-3, "update": 0.5}
SHARD_SWAP_SHARE = 1e-2
SHARD_PEAK_MIB = int(72e9 / 2**20)    # 72 GB
SHARD_TIMEOUT = 400.0
# Then the Mamba-2 and hybrid cases, in the same twin and rank interpreters.
# Small, f32: reduced mamba2-2.7b (d_model 64, 8 SSD heads of 16, state 16)
# and reduced jamba-v0.1-52b at one pattern of 8 layers (7 Mamba-2 and 1
# attention layer, 4 MoE of 8 experts top 2, drop-free), each under FSDP
# off and on: the small qwen2-moe cases' train step, prefill and decode
# steps within SHARD_SMALL_TOL of the twin's; greedy_generate on the mesh
# from the twin's global prompt gives the twin's SHARD_SSM_SMALL_NEW tokens
# exactly; elastic_restore of the twin's train state (written by
# CheckpointManager) onto each rank's parameter shards and ZeRO-1 moment
# parts is bitwise the whole tensors' cut. Full width: mamba2-2.7b at 4 of
# 64 layers (d_model 2560, d_inner 5120, 80 SSD heads of 64, 40 a rank,
# state 128, vocabulary 50280 padded to 50304), bf16: one FSDP train step
# held as the qwen2-moe one (SHARD_TRAIN_TOL on SHARD_MAMBA_CHECKED); a
# prefill of 4 x 512 tokens and 16 decode steps fed the twin's greedy
# tokens on the TP x DP layout without FSDP (as the qwen2-moe serve), the
# logits within SHARD_FULL_TOL of the twin's; greedy_generate on the mesh
# from the twin's prompt, its tokens against the twin's logged (random
# weights give near-tied logits).
SHARD_SSM_SMALL = (("mamba2-2.7b", dict(dtype="float32")),
                   ("jamba-v0.1-52b", dict(dtype="float32", n_layers=8,
                                           moe_capacity_factor=16.0)))
SHARD_SSM_SMALL_NEW = 4
SHARD_MAMBA_LAYERS = 4
SHARD_MAMBA_CHECKED = ("embed", "layers.0.mixer.w_x", "layers.0.mixer.norm_w")


def log(msg: str) -> None:
    print(msg, flush=True)


def hbm_bytes_per_s(name: str) -> float:
    """Device-memory rate of the card ``nvidia-smi`` names (NVIDIA data
    sheets)."""
    n = name.upper()
    if "H200" in n:
        return 4.8e12
    if "H100" in n and "PCIE" in n:
        return 2.0e12
    if "H100" in n and "NVL" in n:
        return 3.9e12
    if "H100" in n:
        return 3.35e12
    raise RuntimeError(f"no memory rate on record for card {name!r}")


def issue_rate(torch) -> float:
    """Instructions per second the card can issue: SMs x 4 schedulers x 32
    lanes x the maximum SM clock ``nvidia-smi`` reports. No instruction mix
    runs faster; integer work splits between the 64-lane ALU pipe and the
    IMAD (FMA) pipe of each SM, so a mix of both can reach it and a pure ALU
    stream reaches half."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * ISSUE_PER_SM * mhz * 1e6


def sass_functions(lib_path) -> dict[str, list[tuple[int, str]]]:
    """Every function of a built library with its SASS instructions
    (address, text), read with ``cuobjdump -sass``."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    funcs, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = funcs[line.split("Function :", 1)[1].strip()] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if cur is not None and m:
            cur.append((int(m.group(1), 16), m.group(2)))
    return funcs


def sass_loops(ins) -> list[list[tuple[int, str]]]:
    """The body of every loop of a function's SASS: each backward branch
    with the instructions from its target to itself."""
    at = {a: i for i, (a, _) in enumerate(ins)}
    loops = []
    for i, (a, text) in enumerate(ins):
        m = re.search(r"\bBRA\s+(0x[0-9a-f]+)", text)
        if m and int(m.group(1), 16) < a:
            loops.append(ins[at[int(m.group(1), 16)]:i + 1])
    return loops


def sass_per_row(lib_path, functions: dict[str, str]) -> dict[str, float]:
    """SASS instructions each kernel executes per row, read from the built
    library with ``cuobjdump -sass``: the instructions of its main loop
    (the backward branch whose body holds the most global loads), plus
    those of any routine the loop calls up to its return — the 64-bit
    remainder ``% P`` compiles to, as the card has no 64-bit divide — over
    the rows one trip handles (its global loads: unrolled loops load
    several)."""
    funcs = sass_functions(lib_path)
    out = {}
    for kernel, fn in functions.items():
        ins = next(v for k, v in funcs.items() if fn in k)
        at = {a: i for i, (a, _) in enumerate(ins)}
        loops = []
        for body in sass_loops(ins):
            loads = sum(bool(re.search(r"\bLDG\b", t)) for _, t in body)
            if loads:
                loops.append((loads, body))
        loads, body = max(loops, key=lambda lb: (lb[0], len(lb[1])))
        count = len(body)
        for _, text in body:
            m = re.search(r"\bCALL\.REL\.NOINC\s+(0x[0-9a-f]+)", text)
            if m:
                j = at[int(m.group(1), 16)]
                k = next(k for k in range(j, len(ins))
                         if re.search(r"\bRET\b", ins[k][1]))
                count += k - j + 1
        out[kernel] = count / loads
    return out


def ptxas_entries(out: str) -> dict[str, dict[str, int]]:
    """Registers and spill bytes of every entry function in ``ptxas -v``
    output, by mangled name."""
    entries, cur = {}, None
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = entries[m.group(1)] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return entries


def mma_main_loops(lib_path, functions: dict[str, str]) -> dict[str, dict[str, int]]:
    """Tensor-core products, ldmatrix loads and cp.async copies in the main
    loop (the longest loop) of each tensor-core kernel, read from its SASS;
    raise if a main loop has no bf16 HMMA: the kernel would not be running
    on the tensor cores."""
    funcs = sass_functions(lib_path)
    out = {}
    for kernel, fn in functions.items():
        ins = next(v for k, v in funcs.items() if fn in k)
        out[kernel] = main_loop_counts(ins, ("HMMA.16816.F32.BF16", "LDSM", "LDGSTS"))
        if not out[kernel]["HMMA.16816.F32.BF16"]:
            raise AssertionError(f"{kernel} ({fn}): no HMMA.16816.F32.BF16 in its main loop "
                                 f"({len(body)} instructions)")
    return out


def cuda_core_main_loops(lib_path, functions: dict[str, str]) -> dict[str, dict[str, int]]:
    """f32 FMAs, shared-memory loads and cp.async copies in the main loop (the
    longest loop) of each CUDA-core kernel, read from its SASS; raise if any
    instruction of the kernel runs on the tensor cores (HMMA, HGMMA: a TF32
    product would be one)."""
    funcs = sass_functions(lib_path)
    out = {}
    for kernel, fn in functions.items():
        ins = next(v for k, v in funcs.items() if fn in k)
        tensor = [text for _, text in ins if re.search(r"(^|\s)(HMMA|HGMMA|IMMA)", text)]
        if tensor:
            raise AssertionError(f"{kernel} ({fn}): tensor-core instructions {tensor[:3]}")
        out[kernel] = main_loop_counts(ins, ("FFMA", "LDS", "LDGSTS", "BAR"))
    return out


def main_loop_counts(ins, ops) -> dict[str, int]:
    """How many instructions of the main loop (the longest loop) of a
    function's SASS start with each of ``ops``, and the loop's length."""
    body = max(sass_loops(ins), key=len)
    out = {op: sum(bool(re.search(rf"(^|\s){re.escape(op)}", text)) for _, text in body)
           for op in ops}
    out["instructions"] = len(body)
    return out


# ---------------------------------------------------------------------------
# phase 4: kernels against their plain versions
# ---------------------------------------------------------------------------

def time_ms(torch, fn, samples: int = 21, batch: int = 10) -> float:
    """Median per-call device time over ``samples`` CUDA-event windows of
    ``batch`` back-to-back calls each, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def device_ms(torch, fn, samples: int = 21, batch: int = 10) -> float:
    """Device time per call with the host's launch path out of the way: the
    CUPTI time of everything that :func:`time_ms`' ``samples`` x ``batch``
    calls run on the card (kernels, copies, memsets), read under
    ``torch.profiler`` (device activity only), over the calls. Beside
    ``time_ms``, which a caller feels, it says whether the device or the
    host sets the pace."""
    return device_profile(torch, fn, samples, batch)[0]


def device_profile(torch, fn, samples: int = 21, batch: int = 10) -> tuple[float, dict]:
    """:func:`device_ms` and the names of what the calls ran on the card,
    each with its device ms per call. Every ``fn`` given runs work on the
    card, so a profile that recorded no device event (seen once, on one
    of a run's sessions) is taken again, up to three times in all."""
    fn()
    torch.cuda.synchronize()
    calls = samples * batch

    def run():
        for _ in range(calls):
            fn()

    for _ in range(3):
        _, by_name, _ = device_kernel_times(torch, run)
        if by_name:
            break
    else:
        raise AssertionError("device_profile: three profiles recorded no device event")
    per_call = {name: us / calls / 1e3 for name, (us, _) in by_name.items()}
    return sum(per_call.values()), per_call


def max_abs_err(torch, got, want) -> float:
    """Largest |kernel − plain| over the outputs (NaN pairs count as 0)."""
    err = 0.0
    for g, w in zip(got, want):
        d = (g.double() - w.double()).abs().nan_to_num(0.0, 0.0, 0.0)
        err = max(err, float(d.max()) if d.numel() else 0.0)
    return err


def rel_err(torch, got, want) -> tuple[float, float]:
    """The worst output's ||got - want|| / ||want|| over the entries where
    ``want`` is finite (a keyless row's lse, +inf on both sides, is held
    apart), with that output's RMS |want|: the scale the error is taken
    against. An output that should be all zero counts ||got||."""
    worst = (0.0, 0.0)
    for g, w in zip(got, want):
        fin = torch.isfinite(w)
        w64 = w.double()[fin]
        diff = float((g.double()[fin] - w64).norm())
        norm = float(w64.norm())
        rel = diff / norm if norm else diff
        if rel >= worst[0]:
            worst = (rel, norm / max(w64.numel(), 1) ** 0.5)
    return worst


def hold(torch, label, got, want, tol, rel_tol) -> tuple[float, float, float]:
    """Raise unless every output matches its plain version's type and shape,
    lies within |got - want| <= tol + tol·|want| elementwise (+inf lse on
    both sides where a row has no key) and within ``rel_tol`` of it by
    :func:`rel_err`; give the worst absolute error, the relative error and
    the RMS |want| it is taken against."""
    for g, w in zip(got, want, strict=True):
        if g.dtype != w.dtype or g.shape != w.shape or not bool(torch.isclose(
                g.float(), w.float(), rtol=tol, atol=tol).all()):
            raise AssertionError(f"{label}: kernel differs from plain beyond {tol} "
                                 f"(max abs diff {max_abs_err(torch, got, want)})")
    rel, rms = rel_err(torch, got, want)
    if rel > rel_tol:
        raise AssertionError(f"{label}: ||kernel - plain|| / ||plain|| = {rel} beyond "
                             f"{rel_tol} (RMS |plain| {rms})")
    return max_abs_err(torch, got, want), rel, rms


def bitwise_equal(torch, got, want) -> bool:
    return all(
        g.dtype == w.dtype and g.shape == w.shape and torch.equal(
            g.contiguous().view(torch.uint8), w.contiguous().view(torch.uint8))
        for g, w in zip(got, want)
    )


def kernel_cases(torch, np, dp, dev, per_row):
    """(kernel, case, inputs, kernel fn, plain fn, library fn or None,
    operations) at the main path's shapes, with edge values written into
    the first rows. ``per_row`` holds the hash kernels' SASS instructions
    per row."""
    gen = torch.Generator(device=dev).manual_seed(0)
    n = N_ROWS

    def randn(dtype):
        return torch.randn(n, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    f32, f64 = randn(torch.float32), randn(torch.float64)
    i64 = (randn(torch.float64) * 100).to(torch.int64)
    specials = torch.tensor([float("nan"), float("inf"), -float("inf"), -0.0,
                             0.0, 1e-40, 0.1, 3e38], device=dev)
    f32[:8] = specials
    f64[:8] = specials.double()
    i64[:4] = torch.tensor([I64MAX, I64MIN, 0, -1], device=dev)
    b32 = randn(torch.float32) * 50
    b32[:8] = specials.flip(0)
    v32 = randn(torch.float32) * 100
    half = 0.5 / 65536.0
    # then NaN, +-inf and 2^47 (2^47 * 2^16 = 2^63 lies outside int64):
    # INT64_MIN, as x86 numpy converts; -2^47 gives INT64_MIN in range
    v32[:11] = torch.tensor([half, -half, 3 * half, 1.0 + half, 123.456, 0.0,
                             float("nan"), float("inf"), -float("inf"), 2.0**47,
                             -(2.0**47)], device=dev)
    w = torch.randint(-3, 4, (n,), generator=gen, device=dev)
    w[:6] = torch.tensor([7, -7, 1 << 45, -(1 << 50), I64MAX, I64MIN], device=dev)
    thr = 0.1
    # views off 16 bytes (a head of 3 rows, and of 1): the vector compare
    # after its head; the scalar kernel (filter_gt/scalar) timed on the same
    # column
    f32_off = torch.empty(n + 1, device=dev)[1:]
    f32_off.copy_(f32)
    f64_off = torch.empty(n + 1, device=dev, dtype=torch.float64)[1:]
    f64_off.copy_(f64)
    F = torch.nn.functional
    edges = torch.tensor([I64MIN, I64MAX, -1, 0], device=dev)
    keys = torch.from_numpy(np.random.default_rng(12).integers(
        I64MIN, I64MAX, n, dtype=np.int64, endpoint=True)).to(dev)
    keys[:4] = edges
    zipf = torch.from_numpy(np.random.default_rng(13).zipf(1.3, n)).to(dev)
    zipf[:4] = edges

    def hist_case(case, k, P):
        return ("pid_hist", case, (k,), lambda: dp.pid_hist(k, P),
                lambda: dp._pid_hist_plain(k, P), None, per_row["pid_hist"] * n)

    cases = [
        ("filter_gt", "f32", (f32,), lambda: (dp.filter_mask(f32, thr),),
         lambda: (dp._filter_plain(f32, thr),), lambda: (torch.gt(f32, thr),), n),
        ("filter_gt", "f64", (f64,), lambda: (dp.filter_mask(f64, thr),),
         lambda: (dp._filter_plain(f64, thr),), lambda: (torch.gt(f64, thr),), n),
        ("filter_gt", "i64", (i64,), lambda: (dp.filter_mask(i64, -0.3),),
         lambda: (dp._filter_plain(i64, -0.3),), None, n),
        ("filter_gt", "f32_unaligned", (f32_off,), lambda: (dp.filter_mask(f32_off, thr),),
         lambda: (dp._filter_plain(f32_off, thr),), lambda: (torch.gt(f32_off, thr),), n),
        ("filter_gt", "f32_unaligned_scalar", (f32_off,),
         lambda: (scalar_filter(torch, dp, f32_off, thr),),
         lambda: (dp._filter_plain(f32_off, thr),), lambda: (torch.gt(f32_off, thr),), n),
        ("filter_gt", "f64_unaligned", (f64_off,), lambda: (dp.filter_mask(f64_off, thr),),
         lambda: (dp._filter_plain(f64_off, thr),), lambda: (torch.gt(f64_off, thr),), n),
        ("map_derived", "two_f32", (f32, b32),
         lambda: (dp.map_derived(f32, b32),), lambda: (dp._map_plain(f32, b32),),
         None, 5 * n),
        ("map_derived", "one_f32", (f32,), lambda: (dp.map_derived(f32, None),),
         lambda: (dp._map_plain(f32, None),), lambda: (F.softsign(f32),), 3 * n),
        # INT64_MIN among the rows: |x| wraps as numpy's, softsign 1.0
        ("map_derived", "one_i64", (i64,), lambda: (dp.map_derived(i64, None),),
         lambda: (dp._map_plain(i64, None),), None, 3 * n),
        ("map_derived", "two_f64", (f64, b32),
         lambda: (dp.map_derived(f64, b32),), lambda: (dp._map_plain(f64, b32),),
         None, 5 * n),
        ("fixed_point_encode", "f32", (v32,),
         lambda: (dp.fixed_point_encode(v32),),
         lambda: (dp._encode_plain(v32, None),), None, 2 * n),
        ("fixed_point_encode", "f32_weighted", (v32, w),
         lambda: (dp.fixed_point_encode(v32, w),),
         lambda: (dp._encode_plain(v32, w),), None, 3 * n),
        ("fixed_point_encode", "f64", (f64,),
         lambda: (dp.fixed_point_encode(f64),),
         lambda: (dp._encode_plain(f64, None),), None, 2 * n),
        probe_case(torch, dp, dev, N_INDEX, n, "16.7M_into_4.2M"),
        # uint64 output, compared (and timed) through an int64 view
        ("hash64", "uniform", (keys,), lambda: (dp.hash64(keys).view(torch.int64),),
         lambda: (dp._hash64_i64(keys),), None, per_row["hash64"] * n),
        ("hash64", "zipf1.3", (zipf,), lambda: (dp.hash64(zipf).view(torch.int64),),
         lambda: (dp._hash64_i64(zipf),), None, per_row["hash64"] * n),
        hist_case("uniform_P8", keys, N_PARTITIONS),
        hist_case("zipf1.3_P8", zipf, N_PARTITIONS),
        hist_case("uniform_P4096", keys, 4096),
        hist_case("zipf1.3_P4096", zipf, 4096),
        hist_case("uniform_P100003", keys, 100_003),
        hist_case("zipf1.3_P100003", zipf, 100_003),
    ]
    return cases


def scalar_filter(torch, dp, col, thr):
    """The scalar FILTER compare (``filter_gt/scalar``) on an f32 column,
    through its C entry: the wrapper gives it only columns with no 16-byte
    vector past their head, which no path here has, so this times it on the
    main path's column."""
    import ctypes

    from repro_torch import native

    out = torch.empty(len(col), dtype=torch.bool, device=col.device)
    native.launch("filter_gt", "sc_filter_gt_f32", col.device, native.ptr(col),
                  ctypes.c_float(thr), native.ptr(out), ctypes.c_longlong(len(col)), -1,
                  variant="scalar")
    return out


def kernel_phase(torch, np, dp, dev, bw, inst_rate, per_row):
    """Hold every kernel against its plain version; time the cases. Returns
    per-case rows and the case each kernel reports on the kernels line (the
    shape and dtype its main-path calls take). A float kernel's operations
    count against the f32 rate, a hash kernel's SASS instructions against
    the card's issue rate."""
    return [kernel_row(torch, dp, bw, inst_rate, *case)
            for case in kernel_cases(torch, np, dp, dev, per_row)]


def kernel_row(torch, dp, bw, inst_rate, kernel, case, inputs, kfn, pfn, lfn, ops):
    """One case of :func:`kernel_cases`' form, held bitwise and timed; a
    FILTER case logs which kernel (vector or scalar) it took."""
    dp.reset_launches()
    got, want = kfn(), pfn()
    took = ("scalar" if dp.variant_launches["filter_gt/scalar"] else "vector"
            ) if kernel == "filter_gt" else ""
    if took and took != ("scalar" if case.endswith("_scalar") else "vector"):
        raise AssertionError(f"{kernel}/{case}: took the {took} kernel")
    torch.cuda.synchronize()
    if not bitwise_equal(torch, got, want):
        raise AssertionError(f"{kernel}/{case}: kernel differs from plain")
    err = max_abs_err(torch, got, want)
    nbytes = sum(t.nbytes for t in inputs) + sum(t.nbytes for t in got)
    bytes_ms = nbytes / bw * 1e3
    rate = inst_rate if kernel in HASH_SASS else PEAK_FLOPS
    ops_ms = ops / rate * 1e3
    row = dict(
        kernel=kernel, case=case, max_abs_err=err,
        ms=time_ms(torch, kfn), device_ms=device_ms(torch, kfn),
        plain_ms=time_ms(torch, pfn),
        library_ms=None if lfn is None else time_ms(torch, lfn),
        library_device_ms=None if lfn is None else device_ms(torch, lfn),
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        bytes=nbytes,
    )
    log(f"kernel {kernel:<19} {case:<16} {took:<6} bitwise ok  max_abs_err={err} "
        f"ms={row['ms']} device_ms={row['device_ms']} plain_ms={row['plain_ms']} "
        f"library_ms={row['library_ms']} library_device_ms={row['library_device_ms']} "
        f"bound_ms={row['bound_ms']} ({row['bound_by']}, {nbytes} B, bytes "
        f"{bytes_ms} ms, ops {ops_ms} ms)")
    if kernel == "pid_hist":
        check_grouping(torch, dp, inputs[0], got[0], case)
    return row


def probe_case(torch, dp, dev, L, n, name):
    """A ``probe_sorted`` case of :func:`kernel_cases`' form at (L, n): L
    even keys around 0 with INT64_MAX last, n uniform probes over them
    (about half hit) with the extremes among the first."""
    gen = torch.Generator(device=dev).manual_seed(L)
    uniq = torch.arange(L, device=dev, dtype=torch.int64) * 2 - L
    uniq[-1] = I64MAX
    probe = torch.randint(-L - 4, L + 4, (n,), generator=gen, device=dev)
    probe[:6] = torch.tensor([I64MAX, I64MIN, I64MAX - 1, L - 2, -L, -L - 1],
                             device=dev)[:n]
    steps = math.ceil(math.log2(L)) + 1
    return ("probe_sorted", name, (uniq, probe), lambda: dp.probe_sorted(uniq, probe),
            lambda: dp._probe_plain(uniq, probe),
            lambda: (torch.searchsorted(uniq, probe),), steps * n)


@contextlib.contextmanager
def probe_shapes(dp):
    """Count the (L, n) shape of every ``probe_sorted`` call that launches
    its kernel inside the block (the operators call it through the module)."""
    shapes = collections.Counter()
    inner = dp.probe_sorted

    def recording(uniq, probe):
        if len(uniq) and len(probe) and uniq.is_cuda:
            shapes[(len(uniq), len(probe))] += 1
        return inner(uniq, probe)

    dp.probe_sorted = recording
    try:
        yield shapes
    finally:
        dp.probe_sorted = inner


def log_probe_shapes(label, shapes, launches):
    """Print the distinct probe shapes, commonest first; they must account
    for every launch of the kernel."""
    if sum(shapes.values()) != launches:
        raise AssertionError(f"{label}: {sum(shapes.values())} probe shapes recorded, "
                             f"{launches} launches")
    log(f"{label}: probe_sorted launches by (L, n): " + ", ".join(
        f"({L}, {n}) x{c}" for (L, n), c in shapes.most_common()))


def check_grouping(torch, dp, keys, pid, case):
    """``partition_index`` on the card (pid_hist, then the stable sort)
    against the plain grouping, bitwise; and the sort's own time, the
    grouping's cost beside the kernel."""
    P = int(case.rsplit("_P", 1)[1])
    got = dp.partition_index(keys, P)
    plain_pid, plain_counts = dp._pid_hist_plain(keys, P)
    want = (torch.sort(plain_pid, stable=True).indices, plain_counts)
    torch.cuda.synchronize()
    if not bitwise_equal(torch, got, want):
        raise AssertionError(f"partition_index/{case}: order differs from plain")
    sort_ms = time_ms(torch, lambda: torch.sort(pid, stable=True))
    log(f"kernel pid_hist            {case:<16} partition_index order bitwise "
        f"ok; grouping torch.sort(pid, stable=True) ms={sort_ms}")


def attention_pairs(b, hq, sq, sk, causal) -> int:
    """(query, key) pairs a causal (top-left) or full attention computes."""
    return b * hq * sum(min(i + 1, sk) if causal else sk for i in range(sq))


def model_kernel_cases(torch, dev):
    """One dict per case (kernel, case, dtype, inputs, kernel fn, plain fn,
    library fn or None, ``lib_minus``: a call whose time the library time
    leaves out, operations, timing samples) for RMSNorm, the flash-attention
    forward and its two backward kernels at the serving and training paths'
    shapes and the train_lm example's (bf16), with inputs made on the card
    from a seeded generator. A
    backward case's plain fn is ``ref.attention_bwd``, which computes dq, dk
    and dv in one call (timed whole for both kernels); its library time is
    SDPA's forward+backward minus SDPA's forward, which computes dq, dk and
    dv together."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref, rmsnorm as rn

    F = torch.nn.functional
    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(shape, dtype, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale + shift).to(dtype)

    def case(kernel, name, dn, inputs, kfn, pfn, lfn, ops, lib_minus=None, samples=21):
        variant = None
        if kernel.startswith("flash"):   # which of its two kernels runs
            variant = fa.variant(kernel, inputs[0].dtype, inputs[0].shape[-1])
        return dict(kernel=kernel, case=name, dn=dn, inputs=inputs, kfn=kfn, pfn=pfn,
                    lfn=lfn, lib_minus=lib_minus, ops=ops, samples=samples, variant=variant)

    cases = []
    rows_lm, width_lm = TRAIN_LM_NORM
    x = randn(TRAIN_LM_NORM, torch.bfloat16)
    w = randn((width_lm,), torch.bfloat16, 0.1, 1.0)
    cases.append(case("rmsnorm", f"{rows_lm}x{width_lm}_bfloat16", "bfloat16", (x, w),
                      lambda x=x, w=w: (rn.rmsnorm(x, w),),
                      lambda x=x, w=w: (ref.rmsnorm(x, w),),
                      lambda x=x, w=w: (F.rms_norm(x, (width_lm,), w, 1e-6),),
                      4 * rows_lm * width_lm))
    for rows, width, dn in MOE_NORMS:
        x = randn((rows, width), getattr(torch, dn))
        w = randn((width,), getattr(torch, dn), 0.1, 1.0)
        cases.append(case("rmsnorm", f"{rows}x{width}_{dn}", dn, (x, w),
                          lambda x=x, w=w: (rn.rmsnorm(x, w),),
                          lambda x=x, w=w: (ref.rmsnorm(x, w),),
                          lambda x=x, w=w, d=width: (F.rms_norm(x, (d,), w, 1e-6),),
                          4 * rows * width))
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        for rows in (2048, 4):   # a 4x512-token prefill; a 4-request decode step
            x = randn((rows, 5120), dtype)
            r = randn((rows, 5120), dtype)
            w = randn((5120,), dtype, 0.1, 1.0)
            n = rows * 5120
            cases.append(case("rmsnorm", f"{rows}x5120_{dn}", dn, (x, w),
                              lambda x=x, w=w: (rn.rmsnorm(x, w),),
                              lambda x=x, w=w: (ref.rmsnorm(x, w),),
                              lambda x=x, w=w: (F.rms_norm(x, (5120,), w, 1e-6),), 4 * n))
            cases.append(case("rmsnorm_residual", f"{rows}x5120_{dn}", dn, (x, r, w),
                              lambda x=x, r=r, w=w: (rn.rmsnorm(x, w, residual=r),),
                              lambda x=x, r=r, w=w: (ref.rmsnorm(x, w, residual=r),),
                              None, 5 * n))
            # rows off 16 bytes: the scalar kernel
            xs = torch.empty(n + 1, dtype=dtype, device=dev)[1:].view(rows, 5120)
            xs.copy_(x)
            cases.append(case("rmsnorm_scalar", f"{rows}x5120_{dn}_unaligned", dn, (xs, w),
                              lambda x=xs, w=w: (rn.rmsnorm(x, w),),
                              lambda x=xs, w=w: (ref.rmsnorm(x, w),),
                              lambda x=xs, w=w: (F.rms_norm(x, (5120,), w, 1e-6),), 4 * n))
        shapes = [  # (b, hq, hkv, sq, sk, d, causal)
            TRAIN_SHAPE,                                 # the training path
            (SERVE_BATCH, 32, 8, SERVE_PROMPT + SERVE_NEW, SERVE_PROMPT + SERVE_NEW,
             160, True),                                 # the serving oracle (GQA)
            (SERVE_BATCH, 32, 8, 40, 72, 160, False),    # ragged, non-causal
            (SERVE_BATCH, 32, 8, 100, 300, 160, True),   # causal, sq != sk
            (1, 32, 8, 8, 0, 160, True),                 # no key: every row masked
        ]
        if dtype == torch.bfloat16:   # the wide heads' training shapes (dk/dv above
            # 128) and the train_lm example's
            shapes += [WIDE_TRAIN_SHAPE, GEMMA_TRAIN_SHAPE, TRAIN_LM_SHAPE, MOE_TRAIN_SHAPE]
        # the MoE and hybrid oracles' cache-less forwards: the forward alone
        fwd_only = [MOE_ORACLE_SHAPE, JAMBA_ORACLE_SHAPE] if dtype == torch.float32 else []
        for b, hq, hkv, sq, sk, d, causal in shapes + fwd_only:
            q = randn((b, hq, sq, d), dtype)
            k = randn((b, hkv, sk, d), dtype)
            v = randn((b, hkv, sk, d), dtype)
            do = randn((b, hq, sq, d), dtype)
            pairs = attention_pairs(b, hq, sq, sk, causal)
            samples = 5 if pairs > 1e8 else 21
            name = f"{b}x{hq}/{hkv}x{sq}x{sk}x{d}{'_causal' if causal else ''}_{dn}"
            sdpa = lambda q, k, v, c=causal: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, is_causal=c, enable_gqa=True)
            lib = None if sk == 0 else (lambda q=q, k=k, v=v, f=sdpa: (f(q, k, v),))
            cases.append(case(
                "flash_fwd", name, dn, (q, k, v),
                lambda q=q, k=k, v=v, c=causal: fa.flash_attention_fwd(q, k, v, causal=c),
                lambda q=q, k=k, v=v, c=causal: ref.attention_with_lse(q, k, v, causal=c),
                lib, 4 * pairs * d, samples=samples))
            if (b, hq, hkv, sq, sk, d, causal) in fwd_only:
                continue
            o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
            delta = (do.float() * o.float()).sum(-1)
            scale = 1.0 / d**0.5
            grads = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
            lib_pair = lib_fwd = None
            if sk:
                lib_pair = lambda g=grads, do=do, f=sdpa: torch.autograd.grad(  # noqa: E731
                    f(*g), g, do)
                lib_fwd = lambda g=grads, f=sdpa: (f(*g),)  # noqa: E731
            bwd_in = (q, k, v, do, lse, delta)
            plain = lambda q=q, k=k, v=v, o=o, lse=lse, do=do, c=causal: (  # noqa: E731
                ref.attention_bwd(q, k, v, o, lse, do, causal=c))
            cases.append(case(
                "flash_bwd_dq", name, dn, bwd_in,
                lambda a=bwd_in, c=causal, s=scale: (fa._launch_dq(*a, c, s),),
                lambda p=plain: p()[:1], lib_pair, 6 * pairs * d, lib_fwd, samples))
            if sk:
                cases.append(case(
                    "flash_bwd_dkv", name, dn, bwd_in,
                    lambda a=bwd_in, c=causal, s=scale: fa._launch_dkv(*a, c, s),
                    lambda p=plain: p()[1:], lib_pair, 8 * pairs * d, lib_fwd, samples))
            else:  # no kv row: nothing to launch; the wrapper gives empty dk, dv
                _, dk, dv = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
                if dk.shape != k.shape or dv.shape != v.shape:
                    raise AssertionError(f"flash_bwd_dkv/{name}: dk, dv not empty")
    return cases


def ssd_ops(b, s, h, p, n, chunk, dtype_name) -> tuple:
    """Operations of the SSD scan as (count, peak rate) pairs, each product
    at the rate of the operands the kernels give it. Per (batch, head,
    chunk of L): L(L+1)p for the masked intra-chunk product (L(L+1)/2
    causal pairs), 2Lnp for C·Hᵀ and 2Lnp for the state product; per
    (batch, chunk), once for all heads (B and C have no head axis), L(L+1)n
    for C·Bᵀ. bf16 inputs run C·Bᵀ, the intra-chunk product and C·Hᵀ on the
    tensor cores (989 TFLOP/s); the state product, and every product of f32
    inputs, is f32 FMAs (67 TFLOP/s)."""
    L = chunk
    per = b * h * (s // L)
    state = per * 2 * L * n * p
    rest = per * (L * (L + 1) * p + 2 * L * n * p) + b * (s // L) * L * (L + 1) * n
    if dtype_name == "bfloat16":
        return ((state, PEAK_FLOPS), (rest, PEAK_BF16_FLOPS))
    return ((state + rest, PEAK_FLOPS),)


def ssd_kernel_cases(torch, dev):
    """Cases of the SSD scan in :func:`model_kernel_cases`' form, each
    giving ``(y, h_final)``, the state after the last chunk: the bf16 and
    f32 serving prefill (4, 512, 80, 64, 128), the bf16 long prefill (1,
    32768, 80, 64, 128), a reduced case with s = chunk = 20, the impulse of
    ``tests/kernels/test_ssd_scan.py`` and one case whose y is held against
    the exact recurrence (``ref.ssd_scan_sequential``). B and C are the
    halves of one (b, s, 2n) tensor, as the model hands them. The
    operations are :func:`ssd_ops`'. No single PyTorch call computes the
    scan: no library time."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_scan

    out = []

    def add(name, x, dt, a, bm, cm, chunk, plain):
        b, s, h, p = x.shape
        chunk, dn, args = min(chunk, s), str(x.dtype).split(".")[1], (x, dt, a, bm, cm)
        chunked = lambda: ref.ssd_scan_chunked(*args, chunk=chunk, return_state=True)  # noqa: E731
        pfn = (chunked if plain == "chunked"
               else (lambda: (ref.ssd_scan_sequential(*args), chunked()[1])))
        out.append(dict(
            kernel="ssd_scan", dn=dn, inputs=args, pfn=pfn, lfn=None, lib_minus=None,
            case=f"{name}_L{chunk}{'' if plain == 'chunked' else '_vs_sequential'}_{dn}",
            kfn=lambda: ssd_scan(*args, chunk=chunk, return_state=True),
            ops=ssd_ops(b, s, h, p, bm.shape[-1], chunk, dn),
            samples=5 if s > MAMBA_PROMPT else 21))

    gen = torch.Generator(device=dev).manual_seed(4)
    shapes = [  # b, s, h, p, n, chunk, dtype, plain
        (4, MAMBA_PROMPT, 80, 64, 128, 64, torch.bfloat16, "chunked"),
        (4, MAMBA_PROMPT, 80, 64, 128, 64, torch.float32, "chunked"),
        (1, MAMBA_LONG, 80, 64, 128, 64, torch.bfloat16, "chunked"),
        # jamba's prefill (state 16, 128 heads), its f32 oracle's forward
        # (512 + 64 positions), the serve_lm example's reduced jamba
        (4, SERVE_PROMPT, 128, 64, 16, 64, torch.bfloat16, "chunked"),
        (4, SERVE_PROMPT + JAMBA_ORACLE_NEW, 128, 64, 16, 64, torch.float32, "chunked"),
        (4, 12, 8, 16, 16, 64, torch.bfloat16, "chunked"),
        (2, 20, 8, 16, 16, 64, torch.float32, "chunked"),
        (2, 128, 2, 16, 8, 32, torch.float32, "sequential"),
    ]
    for b, s, h, p, n, chunk, dtype, plain in shapes:
        x = torch.randn((b, s, h, p), generator=gen, device=dev).to(dtype)
        dt = (torch.nn.functional.softplus(torch.randn((b, s, h), generator=gen, device=dev))
              * 0.1).to(dtype)
        a = -torch.exp(torch.randn((h,), generator=gen, device=dev) * 0.5)
        bc = (torch.randn((b, s, 2 * n), generator=gen, device=dev) / n**0.5).to(dtype)
        add(f"{b}x{s}x{h}x{p}x{n}", x, dt, a, bc[..., :n], bc[..., n:], chunk, plain)
    x = torch.zeros((1, 64, 1, 4), device=dev)   # an impulse at t = 0
    x[0, 0] = 1.0
    ones = torch.ones((1, 64, 4), device=dev)
    add("impulse_1x64x1x4x4", x, torch.full((1, 64, 1), 0.05, device=dev),
        torch.tensor([-0.1], device=dev), ones, ones, 16, "sequential")
    return out


def model_kernel_phase(torch, dev, bw):
    """Hold RMSNorm, the flash forward and backward and the SSD scan against
    their plain versions (:func:`hold`: the JAX kernel tests' tolerances
    elementwise and ``REL_TOL`` relative to the data); the flash forward's
    lse must be finite on every row that has one, and a keyless row must
    give o = 0, lse = +inf and dq = 0; the SSD impulse must reach the last
    chunk. Operations count against the f32 rate for f32 inputs and the
    bf16 tensor-core rate for bf16 ones, except where a case gives its
    operations as (count, rate) pairs (the SSD scan)."""
    rows = []
    lib_times = {}   # SDPA's backward, shared by the two backward kernels
    for c in [*model_kernel_cases(torch, dev), *ssd_kernel_cases(torch, dev)]:
        kernel, case, dn = c["kernel"], c["case"], c["dn"]
        got, want = c["kfn"](), c["pfn"]()
        torch.cuda.synchronize()
        tol = {"flash_fwd": ATTN_TOL, "flash_bwd_dq": BWD_TOL, "flash_bwd_dkv": BWD_TOL,
               "ssd_scan": SSD_TOL}.get(kernel, RMS_TOL)[dn]
        err, rel, rms = hold(torch, f"{kernel}/{case}", got, want, tol, REL_TOL[dn])
        keyless = kernel.startswith("flash") and c["inputs"][1].shape[2] == 0
        if kernel == "flash_fwd":
            lse = got[1]
            if not keyless and not bool(torch.isfinite(lse).all()):
                raise AssertionError(f"{kernel}/{case}: non-finite lse on a real row")
            if keyless and not (bool(torch.isposinf(lse).all()) and not bool(got[0].any())):
                raise AssertionError(f"{kernel}/{case}: a row with no key must give "
                                     "o = 0 and lse = +inf")
        if kernel == "flash_bwd_dq" and keyless and bool(got[0].any()):
            raise AssertionError(f"{kernel}/{case}: a row with no key must give dq = 0")
        if case.startswith("impulse") and not float(got[0][0, -1].abs().sum()) > 0:
            raise AssertionError(f"{kernel}/{case}: the state was lost across chunks")
        if kernel == "ssd_scan":
            hold_final_state(torch, case, c["inputs"], got[1], want[1])
        nbytes = sum(t.nbytes for t in c["inputs"]) + sum(t.nbytes for t in got)
        bytes_ms = nbytes / bw * 1e3
        ops_at = (c["ops"] if isinstance(c["ops"], tuple) else
                  ((c["ops"], PEAK_BF16_FLOPS if dn == "bfloat16" else PEAK_FLOPS),))
        n_ops = sum(count for count, _ in ops_at)
        ops_ms = sum(count / peak for count, peak in ops_at) * 1e3
        timing = dict(samples=c["samples"], batch=10 if c["samples"] > 5 else 2)
        library_ms = library_device_ms = None
        if c["lfn"] is not None:
            key = (id(c["lfn"]), case)
            if key not in lib_times:
                minus = c["lib_minus"]
                lib_ms = time_ms(torch, c["lfn"], **timing) - (
                    0.0 if minus is None else time_ms(torch, minus, **timing))
                lib_dev, ran = device_profile(torch, c["lfn"], **timing)
                if minus is not None:   # the library's backward: what its forward did not run
                    minus_dev, minus_ran = device_profile(torch, minus, **timing)
                    lib_dev -= minus_dev
                    ran = {name: ms for name, ms in ran.items() if name not in minus_ran}
                lib_times[key] = (lib_ms, lib_dev)
                log(f"library {'backward ' if minus is not None else ''}{kernel} {case}: "
                    "device ms per call by kernel (names to their argument list) "
                    f"{ {name.split('(')[0][:160]: ms for name, ms in ran.items()} }")
            library_ms, library_device_ms = lib_times[key]
        row = dict(
            kernel=kernel, case=case, max_abs_err=err,
            ms=time_ms(torch, c["kfn"], **timing), device_ms=device_ms(torch, c["kfn"], **timing),
            plain_ms=time_ms(torch, c["pfn"], **timing),
            library_ms=library_ms, library_device_ms=library_device_ms,
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations", bytes=nbytes,
            variant=c.get("variant"),
        )
        rows.append(row)
        log(f"kernel {kernel:<17} {case:<38} {c.get('variant') or '':<9} within {tol}  "
            f"max_abs_err={err} rel_err={rel} (limit {REL_TOL[dn]}, RMS |plain| {rms}) "
            f"ms={row['ms']} device_ms={row['device_ms']} plain_ms={row['plain_ms']} "
            f"library_ms={row['library_ms']} library_device_ms={row['library_device_ms']} "
            f"bound_ms={row['bound_ms']} ({row['bound_by']}, {nbytes} B, bytes {bytes_ms} ms, "
            f"{n_ops} ops {ops_ms} ms)")
        del got, want
    log_bwd_pairs(rows)
    bwd_wrapper(torch, dev)
    flash_pair(torch, dev)
    ssd_grads(torch, dev, bw)
    return rows


def log_bwd_pairs(rows) -> None:
    """The two flash backward kernels' device time together, beside their
    bounds and the library's backward (SDPA's pair minus its forward), for
    every case that launched both."""
    pairs = collections.defaultdict(dict)
    for r in rows:
        if r["kernel"] in ("flash_bwd_dq", "flash_bwd_dkv"):
            pairs[r["case"]][r["kernel"]] = r
    for case, pair in pairs.items():
        if len(pair) < 2:
            continue
        dq, dkv = pair["flash_bwd_dq"], pair["flash_bwd_dkv"]
        ours, lib = dq["device_ms"] + dkv["device_ms"], dq["library_device_ms"]
        log(f"kernel flash backward pair {case} ({dq['variant']}): dq {dq['device_ms']} + "
            f"dk/dv {dkv['device_ms']} = {ours} ms device, bound "
            f"{dq['bound_ms'] + dkv['bound_ms']} ms; library backward {lib} ms device"
            + (f" ({ours / lib:.2f}x)" if lib else ""))


def ssd_bwd_ops(b, s, h, p, n, chunk) -> int:
    """Operations of ``ssd_scan_bwd`` (its products, f32 FMAs): per
    (batch, head, chunk of L), 2Lpn for each of the recomputed chunk state,
    C·Hᵀ, dH, dC's state term, dS·B and dB's state term, and 2L²p for each
    of dM = dy·(x·dt)ᵀ and Mᵀ·dy; per (batch, chunk) 2L²n for each of C·Bᵀ,
    dC's and dB's intra-chunk terms. Elementwise passes not counted."""
    L = chunk
    per = b * h * (s // L)
    return per * (6 * 2 * L * p * n + 2 * 2 * L * L * p) + b * (s // L) * 3 * 2 * L * L * n


def ssd_grads(torch, dev, bw) -> None:
    """``SSDScan``'s forward (``y`` and the final state, the scan kernels)
    and its five gradients (the closed-form backward in PyTorch ops) on the
    card against the plain version (``ref.ssd_scan_chunked``) and
    ``torch.autograd`` of it in f32 on the same values, at
    ``SSD_GRAD_SHAPES`` in bf16 and f32, B and C the halves of one (b, s,
    2n) tensor, within ``SSD_TOL`` and ``REL_TOL``. Then the backward alone
    (``ssd_scan_bwd``) timed beside the forward kernel at the same inputs
    (CUDA events and CUPTI device ms; PyTorch ops, not a kernel), its
    working set beyond its inputs and gradients held within
    ``WORKSPACE_BYTES``, and beside the backward it replaces: the plain
    forward recomputed under grad and ``torch.autograd`` through it, timed
    and its working set read the same way."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as mod

    F = torch.nn.functional
    gen = torch.Generator(device=dev).manual_seed(5)
    for b, s, h, p, n in SSD_GRAD_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[1]
            case = f"{b}x{s}x{h}x{p}x{n}_L64_{dn}"
            x = torch.randn((b, s, h, p), generator=gen, device=dev).to(dtype)
            dt = (F.softplus(torch.randn((b, s, h), generator=gen, device=dev)) * 0.1).to(dtype)
            a = -torch.exp(torch.randn((h,), generator=gen, device=dev) * 0.5)
            bc = (torch.randn((b, s, 2 * n), generator=gen, device=dev) / n**0.5).to(dtype)
            dy = torch.randn((b, s, h, p), generator=gen, device=dev).to(dtype)
            leaves = [t.clone().requires_grad_(True) for t in (x, dt, a, bc)]
            y, h_final = mod.ssd_scan(leaves[0], leaves[1], leaves[2], leaves[3][..., :n],
                                      leaves[3][..., n:], return_state=True)
            got = [g.float() for g in torch.autograd.grad(y, leaves, dy)]
            plain = [t.detach().float().requires_grad_(True) for t in (x, dt, a, bc)]
            yp, hp_final = ref.ssd_scan_chunked(plain[0], plain[1], plain[2],
                                                plain[3][..., :n], plain[3][..., n:],
                                                return_state=True)
            want = list(torch.autograd.grad(yp, plain, dy.float()))
            torch.cuda.synchronize()
            # the forward: the plain version's y rounded to the inputs' type,
            # as the plain version gives it on them
            f_err, f_rel, f_rms = hold(torch, f"ssd_scan/{case}", [y.detach(), h_final],
                                       [yp.detach().to(dtype), hp_final.detach()], SSD_TOL[dn],
                                       REL_TOL[dn])
            del y, h_final, yp, hp_final, leaves, plain
            err, rel, rms = hold(torch, f"ssd_scan backward/{case}", got, want, SSD_TOL[dn],
                                 REL_TOL[dn])
            del got, want
            bm, cm = bc[..., :n], bc[..., n:]
            args = (x, dt, a, bm, cm)

            def recompute():
                """The plain forward under grad and autograd through it."""
                with torch.enable_grad():
                    ins = [t.detach().requires_grad_(True) for t in (x, dt, a, bc)]
                    yq = ref.ssd_scan_chunked(ins[0], ins[1], ins[2], ins[3][..., :n],
                                              ins[3][..., n:])
                    return torch.autograd.grad(yq, ins, dy)

            def working_set(fn):
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                grads = fn()
                torch.cuda.synchronize()
                return torch.cuda.max_memory_allocated() - base - sum(g.nbytes for g in grads)

            work = working_set(lambda: mod.ssd_scan_bwd(*args, dy))
            if work > mod.WORKSPACE_BYTES:
                raise AssertionError(f"ssd_scan_bwd/{case}: working set {work} B beyond "
                                     f"WORKSPACE_BYTES {mod.WORKSPACE_BYTES}")
            re_work = working_set(recompute)
            timing = dict(samples=5, batch=2)
            fwd_ms = time_ms(torch, lambda: mod.ssd_scan(*args), **timing)
            fwd_dev = device_ms(torch, lambda: mod.ssd_scan(*args), **timing)
            bwd_ms = time_ms(torch, lambda: mod.ssd_scan_bwd(*args, dy), **timing)
            bwd_dev = device_ms(torch, lambda: mod.ssd_scan_bwd(*args, dy), **timing)
            re_ms = time_ms(torch, recompute, **timing)
            re_dev = device_ms(torch, recompute, **timing)
            if case == SSD_SUM_CASE:
                device_kernel_times(torch, lambda: mod.ssd_scan_bwd(*args, dy),
                                    sums=f"ssd_scan_bwd {case}")
            nbytes = 2 * (sum(t.nbytes for t in args) + dy.nbytes)  # read, gradients written
            n_ops = ssd_bwd_ops(b, s, h, p, n, 64)
            bound = max(nbytes / bw, n_ops / PEAK_FLOPS) * 1e3
            log(f"kernel ssd_scan forward (SSDScan, return_state) {case}: y and the final "
                f"state within {SSD_TOL[dn]} of the plain version, max_abs_err={f_err} "
                f"rel_err={f_rel} (limit {REL_TOL[dn]}, RMS |plain| {f_rms})")
            log(f"kernel ssd_scan backward (SSDScan: kernel forward, PyTorch-ops backward) "
                f"{case}: dx, ddt, da, dB, dC within {SSD_TOL[dn]} of torch.autograd of the "
                f"plain version in f32, max_abs_err={err} rel_err={rel} (limit "
                f"{REL_TOL[dn]}, RMS |plain| {rms}); backward (PyTorch ops, not a kernel) "
                f"ms={bwd_ms} device_ms={bwd_dev} bound_ms={bound} ({n_ops} f32 ops, "
                f"{nbytes} B), working set {work} B (limit {mod.WORKSPACE_BYTES}); forward "
                f"kernel ms={fwd_ms} device_ms={fwd_dev}; plain forward recomputed + "
                f"torch.autograd ms={re_ms} device_ms={re_dev} working set {re_work} B")
            del x, dt, a, bc, dy, args, bm, cm


def hold_final_state(torch, case, inputs, got, plain):
    """The scan's state after the last chunk (f32 whatever the inputs) within
    ``REL_TOL["float32"]`` of ||want|| against its plain version's and
    against the reference's whole-prefix closed form
    (``ref.ssd_final_state``: ``_ssm_state_after_prefill``'s sum, in f64)."""
    from repro_torch.kernels import ref

    closed = ref.ssd_final_state(*inputs[:4])
    rels = {}
    for name, want in (("plain", plain), ("closed form", closed)):
        rel, rms = rel_err(torch, (got,), (want,))
        if got.dtype != torch.float32 or got.shape != want.shape or not rel <= REL_TOL["float32"]:
            raise AssertionError(f"ssd_scan/{case}: final state {got.dtype} "
                                 f"{tuple(got.shape)} vs {name}: ||got - want|| / ||want|| = "
                                 f"{rel} beyond {REL_TOL['float32']} (RMS |want| {rms})")
        rels[name] = rel
    log(f"kernel ssd_scan final state {case}: rel_err vs plain {rels['plain']}, vs "
        f"whole-prefix closed form {rels['closed form']} (limit {REL_TOL['float32']})")


def bwd_wrapper(torch, dev):
    """The backward wrapper that training calls (``flash_attention_bwd``:
    its own δ, the lse cast, ``do`` as autograd hands it back through the
    model's (b, s, h, d) layout, a transposed view) against
    ``ref.attention_bwd`` at the training path's shape, in both types, held
    as the backward kernels are."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    b, hq, hkv, sq, sk, d, causal = TRAIN_SHAPE
    gen = torch.Generator(device=dev).manual_seed(3)
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        q, k, v = (torch.randn((b, h, s, d), generator=gen, device=dev).to(dtype)
                   for h, s in ((hq, sq), (hkv, sk), (hkv, sk)))
        do = torch.randn((b, sq, hq, d), generator=gen, device=dev).to(dtype).transpose(1, 2)
        if do.is_contiguous():
            raise AssertionError("flash_attention_bwd check: do should be a strided view")
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        want = ref.attention_bwd(q, k, v, o, lse, do, causal=causal)
        err, rel, rms = hold(torch, f"flash_attention_bwd/{dn}", got, want,
                             BWD_TOL[dn], REL_TOL[dn])
        log(f"kernel flash_attention_bwd (wrapper, do strides {do.stride()}) "
            f"{b}x{hq}/{hkv}x{sq}x{sk}x{d}{'_causal' if causal else ''}_{dn}: dq, dk, dv "
            f"within {BWD_TOL[dn]}  max_abs_err={err} rel_err={rel} "
            f"(limit {REL_TOL[dn]}, RMS |plain| {rms})")
        del got, want


def flash_pair(torch, dev):
    """The flash forward+backward pair (the autograd Function, both backward
    kernels) against SDPA's pair at the training path's shape, in both
    types."""
    from repro_torch.kernels import ops

    F = torch.nn.functional
    b, hq, hkv, sq, sk, d, causal = TRAIN_SHAPE
    gen = torch.Generator(device=dev).manual_seed(2)
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (torch.randn((b, h, s, d), generator=gen, device=dev).to(dtype)
                   .requires_grad_(True) for h, s in ((hq, sq), (hkv, sk), (hkv, sk)))
        do = torch.randn((b, hq, sq, d), generator=gen, device=dev).to(dtype)
        ours = time_ms(torch, lambda: torch.autograd.grad(
            ops.flash_attention(q, k, v, causal=causal), (q, k, v), do), samples=5, batch=2)
        sdpa = time_ms(torch, lambda: torch.autograd.grad(F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True), (q, k, v), do), samples=5, batch=2)
        log(f"kernel flash pair (forward + backward) {b}x{hq}/{hkv}x{sq}x{sk}x{d}"
            f"{'_causal' if causal else ''}_{str(dtype).split('.')[1]}: ms={ours} "
            f"SDPA pair ms={sdpa} ({ours / sdpa:.2f}x)")


# ---------------------------------------------------------------------------
# phases 11-12: serving (stablelm-12b, mamba2-2.7b)
# ---------------------------------------------------------------------------

def log_breakdown(label, wall, by_name, per=1, phase="serve"):
    """The device's busy share of ``wall`` and the top kernels, each over
    ``per`` steps."""
    busy = sum(us for us, _ in by_name.values())
    log(f"{phase}: profile {label}: wall {wall / per * 1e3:.3f} ms, device busy "
        f"{busy / per / 1e3:.3f} ms, busy share {busy / (wall * 1e6):.4f}")
    for k, (us, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        log(f"{phase}:   {us / per / 1e3:9.4f} ms {count / per:8.1f}x  {k[:90]}")


def predicted_model_launches(cfg, forwards, prefills, cacheless=0) -> dict:
    """Launches of ``forwards`` forwards of ``cfg``, ``prefills`` of them
    prefills and ``cacheless`` of them cache-less: every forward runs
    RMSNorm at each layer's norm1, at norm2 where the layer has a
    feed-forward, at each Mamba-2 layer's gated norm and once at the final
    norm; a prefill or a cache-less forward runs the SSD scan once per
    Mamba-2 layer (a decode step is the plain recurrence); only a
    cache-less forward runs the flash forward, once per attention layer
    (f32 on the CUDA cores, bf16 on the tensor cores)."""
    from repro_torch.models.transformer import layer_kinds

    kinds = layer_kinds(cfg)
    norms = 1 + sum(1 + (mlp is not None) + (mixer == "ssm") for mixer, mlp in kinds)
    ssm = sum(mixer == "ssm" for mixer, _ in kinds)
    flash = cacheless * sum(mixer == "attn" for mixer, _ in kinds)
    want = {"rmsnorm": norms * forwards, "rmsnorm/residual": 0, "rmsnorm/scalar": 0,
            "flash_fwd": flash, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "ssd_scan": ssm * (prefills + cacheless), **dict.fromkeys(FLASH_VARIANTS, 0)}
    want["flash_fwd/cuda_core" if cfg.dtype == "float32" else "flash_fwd/mma"] = flash
    return want


def serve_phase(torch, np, dev):
    """stablelm-12b at full width and depth answers SERVE_BATCH requests;
    then the full-width f32 oracle at ORACLE_LAYERS layers, and reduced GQA
    card against CPU. Returns the launch counts of the two card paths, each
    kernel's total and its variants' shares (``kernel/variant``)."""
    import dataclasses as dc

    from repro_torch import configs, models, serve
    from repro_torch.kernels import ops

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 products in full f32
    torch.backends.cudnn.allow_tf32 = False
    cfg = configs.get_config(SERVE_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = models.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != cfg.param_count():
        raise AssertionError(f"{n_params} parameters, config counts {cfg.param_count()}")
    log(f"serve: {cfg.name} {cfg.n_layers} layers d_model {cfg.d_model} heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads} head_dim {cfg.head_dim_} d_ff {cfg.d_ff} "
        f"vocab {cfg.vocab_size} {cfg.dtype}: {n_params} parameters, "
        f"{sum(p.nbytes for p in model.parameters())} B, init "
        f"{time.perf_counter() - t0:.3f}s")
    prompt = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT)))

    def generate(max_new):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = serve.greedy_generate(cfg, model, prompt, max_new)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    generate(2)                                   # warm-up (cuBLAS, allocator)
    _, prefill_s = generate(1)                    # prefill and one argmax
    ops.reset_launches()
    out, total_s = generate(SERVE_NEW)
    serve_launches = {**ops.launches, **ops.variant_launches}
    peak = torch.cuda.max_memory_allocated()
    decode_ms = (total_s - prefill_s) / (SERVE_NEW - 1) * 1e3
    if out.shape != (SERVE_BATCH, SERVE_NEW) or not bool(
            ((out >= 0) & (out < cfg.vocab_size)).all()):
        raise AssertionError(f"generated tokens {tuple(out.shape)} out of range")
    want = predicted_model_launches(cfg, SERVE_NEW, 1)
    if serve_launches != want:
        raise AssertionError(f"serving launches {serve_launches}, expected {want}")
    log(f"serve: {SERVE_BATCH} requests x {SERVE_PROMPT}-token prompts, "
        f"{SERVE_NEW} new tokens each: total {total_s:.4f}s, prefill "
        f"{prefill_s:.4f}s, decode {decode_ms:.3f} ms/token (per step of "
        f"{SERVE_BATCH}), {SERVE_BATCH * SERVE_NEW / total_s:.2f} tokens/s; "
        f"max_memory_allocated {peak} B; launches {serve_launches}")
    log(f"serve: sample {out[0, :12].tolist()}")
    # where the time goes: the prefill alone, then prefill + PROFILE_STEPS
    # decode steps; the decode step's kernels are the difference
    pre_wall, pre, _ = device_kernel_times(
        torch, lambda: serve.greedy_generate(cfg, model, prompt, 1))
    both_wall, both, _ = device_kernel_times(
        torch, lambda: serve.greedy_generate(cfg, model, prompt, 1 + PROFILE_STEPS))
    dec = {k: (us - pre.get(k, (0.0, 0))[0], n - pre.get(k, (0.0, 0))[1])
           for k, (us, n) in both.items()}
    log_breakdown(f"prefill ({SERVE_BATCH} x {SERVE_PROMPT} tokens)", pre_wall, pre)
    log_breakdown(f"decode step (mean of {PROFILE_STEPS})", both_wall - pre_wall,
                  {k: v for k, v in dec.items() if v[0] > 0}, PROFILE_STEPS)
    del model, out
    torch.cuda.empty_cache()

    # the serving oracle: prefill + teacher-forced decode against forward
    t0 = time.perf_counter()
    ocfg = dc.replace(cfg, n_layers=ORACLE_LAYERS, dtype="float32")
    omodel = models.init_params(ocfg, torch.Generator(device=dev).manual_seed(1), dev)
    total = SERVE_PROMPT + SERVE_NEW
    tok = torch.from_numpy(np.random.default_rng(6).integers(
        0, ocfg.vocab_size, (SERVE_BATCH, total))).to(dev)
    ops.reset_launches()
    worst, top, where = oracle_check(torch, models, ocfg, omodel, tok, SERVE_PROMPT,
                                     "serving")
    oracle_launches = {**ops.launches, **ops.variant_launches}
    want = predicted_model_launches(ocfg, 2 + SERVE_NEW, 1, cacheless=1)
    if oracle_launches != want:
        raise AssertionError(f"oracle launches {oracle_launches}, expected {want}")
    log(f"serve: oracle ({ORACLE_LAYERS} layers, full width, f32) prefill + "
        f"{SERVE_NEW} teacher-forced decode steps match the cache-less forward "
        f"within {ORACLE_TOL} (max abs diff {worst}: {where}; logits up to "
        f"{top}); launches {oracle_launches}; "
        f"{time.perf_counter() - t0:.3f}s")
    del omodel
    torch.cuda.empty_cache()

    # card against CPU: reduced stablelm-12b with GQA, f32
    t0 = time.perf_counter()
    scfg = configs.get_config(SERVE_ARCH).reduced(dtype="float32", n_heads=8,
                                                  n_kv_heads=2)
    cpu_model = models.init_params(scfg, torch.Generator().manual_seed(2), "cpu")
    card_model = models.init_params(scfg, torch.Generator().manual_seed(2), "cpu").to(dev)
    sprompt = torch.from_numpy(np.random.default_rng(7).integers(
        0, scfg.vocab_size, (2, 24)))
    cpu_tok = serve.greedy_generate(scfg, cpu_model, sprompt, 8, "cpu")
    card_tok = serve.greedy_generate(scfg, card_model, sprompt, 8).cpu()
    if not torch.equal(cpu_tok, card_tok):
        raise AssertionError(f"greedy tokens differ card vs CPU:\n{cpu_tok}\n{card_tok}")
    with torch.inference_mode():
        cpu_logits, _, _ = models.forward(scfg, cpu_model, sprompt)
        card_logits, _, _ = models.forward(scfg, card_model, sprompt.to(dev))
    diff = float((card_logits.cpu() - cpu_logits).abs().max())
    if not bool(torch.isclose(card_logits.cpu(), cpu_logits, rtol=CARD_CPU_LOGIT_TOL,
                              atol=CARD_CPU_LOGIT_TOL).all()):
        raise AssertionError(f"forward logits differ card vs CPU by {diff}")
    log(f"serve: reduced {SERVE_ARCH} (GQA 8/2, f32) card vs CPU: the same "
        f"greedy tokens {card_tok[0].tolist()}; forward logits within "
        f"{CARD_CPU_LOGIT_TOL} (max abs diff {diff}); {time.perf_counter() - t0:.3f}s")
    return serve_launches, oracle_launches


def oracle_check(torch, models, cfg, model, tok, prompt_len, label, moe_stats=None):
    """Prefill ``tok[:, :prompt_len]`` and decode the rest teacher-forced;
    raise unless every step's logits lie within ``ORACLE_TOL`` of the
    cache-less forward's. Returns the worst difference, the largest logit
    over the real vocabulary (the padded one holds -1e9) and where the
    differences lie: at the prompt's last position, and at the first,
    worst and last decode step. With ``moe_stats``, every call adds its MoE
    layers' dropped and routed (token, expert) pairs there."""
    b, total = tok.shape
    with torch.inference_mode():
        full, _, _ = models.forward(cfg, model, tok, moe_stats=moe_stats)
        cache = models.make_cache(cfg, b, total, tok.device)
        last, cache = models.prefill(cfg, model, tok[:, :prompt_len], cache,
                                     moe_stats=moe_stats)
        at_prompt = float((last - full[:, prompt_len - 1]).abs().max())
        ok = bool(torch.isclose(last, full[:, prompt_len - 1], rtol=ORACLE_TOL,
                                atol=ORACLE_TOL).all())
        steps = []
        for t in range(prompt_len, total):
            step, cache = models.decode_step(cfg, model, tok[:, t], cache, t,
                                             moe_stats=moe_stats)
            steps.append(float((step - full[:, t]).abs().max()))
            ok = ok and bool(torch.isclose(step, full[:, t], rtol=ORACLE_TOL,
                                           atol=ORACLE_TOL).all())
    worst = max([at_prompt, *steps])
    if not ok or not bool(torch.isfinite(full).all()):
        raise AssertionError(f"{label} oracle: prefill/decode logits differ from the "
                             f"forward by up to {worst} (tolerance {ORACLE_TOL})")
    k = max(range(len(steps)), key=steps.__getitem__)
    where = (f"prompt's last position {at_prompt}, decode steps first {steps[0]}, "
             f"worst {steps[k]} (step {k}), last {steps[-1]}")
    return worst, float(full[..., :cfg.vocab_size].abs().max()), where


def oracle_causes(torch, models, cfg, model, tok, prompt_len, label) -> str:
    """What an oracle's difference is made of, on the oracle's own model
    and tokens (f32). The gain: the largest change of the cache-less
    forward's logits when every element of the embedding table moves by
    one f32 ulp of 1 (relative 2^-23, seeded signs), which is what the
    model makes of the rounding that separates the cached path from the
    cache-less one. And, where the model has Mamba-2 layers, the first
    one's output through a prefill of ``prompt_len`` positions and
    single-step decodes from its handed-off state against the scan over
    every position, on that layer's own input; raises unless within
    REL_TOL of the output's largest value (a fault of the state hand-off
    or of the decode recurrence would show there, not amplified)."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L

    emb = model.embed
    with torch.inference_mode():
        full, _, _ = models.forward(cfg, model, tok)
        saved = emb.detach().clone()
        gen = torch.Generator(device=emb.device).manual_seed(3)
        up = torch.rand(emb.shape, generator=gen, device=emb.device) < 0.5
        emb.mul_(torch.where(up, 1.0 + 2.0 ** -23, 1.0 - 2.0 ** -23))
        del up
        moved, _, _ = models.forward(cfg, model, tok)
        emb.copy_(saved)
        del saved
        v = cfg.vocab_size
        gain = float((moved[..., :v] - full[..., :v]).abs().max())
        out = f"gain {gain} (logits moved by a 1-ulp embedding change)"
        ssm = [i for i, layer in enumerate(model.layers) if isinstance(layer.mixer, L.SSM)]
        if not ssm:
            return out
        layer = model.layers[ssm[0]]
        h = ops.rmsnorm(models.embed_inputs(cfg, model, tok), layer.norm1, eps=cfg.norm_eps)
        want, _ = L.ssm_forward(cfg, layer.mixer, h)
        state = L.make_ssm_cache(cfg, tok.shape[0], tok.device)
        got, state = L.ssm_forward(cfg, layer.mixer, h[:, :prompt_len], state)
        ys = [got]
        for t in range(prompt_len, tok.shape[1]):
            y, state = L.ssm_forward(cfg, layer.mixer, h[:, t:t + 1], state)
            ys.append(y)
        got = torch.cat(ys, dim=1)
        diff = (got - want).abs()
        top = float(want.abs().max())
        at_prompt = float(diff[:, :prompt_len].max())
        at_decode = float(diff[:, prompt_len:].max())
    if max(at_prompt, at_decode) > REL_TOL["float32"] * top:
        raise AssertionError(f"{label}: Mamba-2 layer {ssm[0]} through prefill + decode "
                             f"differs from its scan by {max(at_prompt, at_decode)} "
                             f"(largest output {top})")
    return (f"{out}; Mamba-2 layer {ssm[0]} (state {cfg.ssm_state}, {cfg.ssm_heads} "
            f"heads of {cfg.ssm_head_dim}) prefill + decode against its scan: "
            f"prompt {at_prompt}, decode steps {at_decode} (largest output {top})")


def mamba_phase(torch, np, dev):
    """mamba2-2.7b at full width and depth (bf16, random seeded weights)
    answers MAMBA_BATCH requests through ``greedy_generate`` and prefills
    one MAMBA_LONG-token prompt; then the full-width f32 oracle at
    ORACLE_LAYERS layers, and reduced mamba2 card against CPU. Every
    forward launches RMSNorm twice per layer and once at the final norm;
    each prefill or cache-less forward launches the SSD scan once per layer
    (decode is the plain recurrence, as in the JAX package); no flash
    kernel runs. Returns the launch counts of the serving run, the long
    prefill and the oracle."""
    import dataclasses as dc

    from repro_torch import configs, models, serve
    from repro_torch.kernels import ops

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 products in full f32
    torch.backends.cudnn.allow_tf32 = False
    cfg = configs.get_config(MAMBA_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = models.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != cfg.param_count():
        raise AssertionError(f"{n_params} parameters, config counts {cfg.param_count()}")
    log(f"mamba: {cfg.name} {cfg.n_layers} layers d_model {cfg.d_model} d_inner "
        f"{cfg.ssm_d_inner} SSD heads {cfg.ssm_heads} x {cfg.ssm_head_dim} state "
        f"{cfg.ssm_state} vocab {cfg.vocab_size} (padded {cfg.vocab_padded}) {cfg.dtype}: "
        f"{n_params} parameters, {sum(p.nbytes for p in model.parameters())} B, init "
        f"{time.perf_counter() - t0:.3f}s")
    rng = np.random.default_rng(9)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (MAMBA_BATCH, MAMBA_PROMPT)))

    def generate(p, max_new):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = serve.greedy_generate(cfg, model, p, max_new)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    generate(prompt, 2)                           # warm-up (cuBLAS, allocator)
    _, prefill_s = generate(prompt, 1)            # prefill and one argmax
    ops.reset_launches()
    out, total_s = generate(prompt, MAMBA_NEW)
    serve_launches = {**ops.launches, **ops.variant_launches}
    peak = torch.cuda.max_memory_allocated()
    decode_ms = (total_s - prefill_s) / (MAMBA_NEW - 1) * 1e3
    if out.shape != (MAMBA_BATCH, MAMBA_NEW) or not bool(
            ((out >= 0) & (out < cfg.vocab_size)).all()):
        raise AssertionError(f"generated tokens {tuple(out.shape)} out of range")
    if serve_launches != predicted_model_launches(cfg, MAMBA_NEW, 1):
        raise AssertionError(f"mamba serving launches {serve_launches}, expected "
                             f"{predicted_model_launches(cfg, MAMBA_NEW, 1)}")
    log(f"mamba: {MAMBA_BATCH} requests x {MAMBA_PROMPT}-token prompts, {MAMBA_NEW} new "
        f"tokens each: total {total_s:.4f}s, prefill {prefill_s:.4f}s, decode "
        f"{decode_ms:.3f} ms/token (per step of {MAMBA_BATCH}), "
        f"{MAMBA_BATCH * MAMBA_NEW / total_s:.2f} tokens/s; max_memory_allocated {peak} B; "
        f"launches {serve_launches}")
    log(f"mamba: sample {out[0, :12].tolist()}")
    pre_wall, pre, _ = device_kernel_times(
        torch, lambda: serve.greedy_generate(cfg, model, prompt, 1))
    both_wall, both, _ = device_kernel_times(
        torch, lambda: serve.greedy_generate(cfg, model, prompt, 1 + PROFILE_STEPS))
    dec = {k: (us - pre.get(k, (0.0, 0))[0], n - pre.get(k, (0.0, 0))[1])
           for k, (us, n) in both.items()}
    log_breakdown(f"prefill ({MAMBA_BATCH} x {MAMBA_PROMPT} tokens)", pre_wall, pre,
                  phase="mamba")
    log_breakdown(f"decode step (mean of {PROFILE_STEPS})", both_wall - pre_wall,
                  {k: v for k, v in dec.items() if v[0] > 0}, PROFILE_STEPS, phase="mamba")

    # one long prompt: prefill_32k's length, batch 1; the first run warms up
    # under the profiler (its device times; its wall clock is not reported)
    long_prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, MAMBA_LONG)))
    _, by_name, _ = device_kernel_times(torch, lambda: generate(long_prompt, 1))
    busy = sum(us for us, _ in by_name.values())
    log(f"mamba: profile {MAMBA_LONG}-token prefill (warm-up run): device busy "
        f"{busy / 1e3:.3f} ms")
    for k, (us, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        log(f"mamba:   {us / 1e3:9.4f} ms {count:8d}x  {k[:90]}")
    scan_us = sum(us for k, (us, _) in by_name.items() if "ssd_" in k)
    log(f"mamba: the SSD scan's three kernels {scan_us / 1e3:.4f} ms of the long prefill")
    # the decode state comes from the scan: no whole-prefix cumsum (a torch
    # scan kernel) is left on the prefill
    stray = [k for k in by_name if "scan" in k.lower() and "ssd_" not in k]
    if stray:
        raise AssertionError(f"the long prefill launched scan kernels besides the SSD "
                             f"scan's: {stray}")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    long_out, long_s = generate(long_prompt, 1)
    long_launches = {**ops.launches, **ops.variant_launches}
    long_peak = torch.cuda.max_memory_allocated()
    if long_launches != predicted_model_launches(cfg, 1, 1):
        raise AssertionError(f"long prefill launches {long_launches}, expected "
                             f"{predicted_model_launches(cfg, 1, 1)}")
    if long_out.shape != (1, 1) or not 0 <= int(long_out) < cfg.vocab_size:
        raise AssertionError(f"long prefill token {long_out.tolist()} out of range")
    log(f"mamba: one {MAMBA_LONG}-token prompt: prefill {long_s:.4f}s "
        f"({MAMBA_LONG / long_s:.1f} tokens/s); max_memory_allocated {long_peak} B; "
        f"launches {long_launches}")
    del model, out
    torch.cuda.empty_cache()

    # the serving oracle: prefill + teacher-forced decode against forward
    t0 = time.perf_counter()
    ocfg = dc.replace(cfg, n_layers=ORACLE_LAYERS, dtype="float32")
    omodel = models.init_params(ocfg, torch.Generator(device=dev).manual_seed(1), dev)
    tok = torch.from_numpy(rng.integers(0, ocfg.vocab_size,
                                        (MAMBA_BATCH, MAMBA_PROMPT + MAMBA_NEW))).to(dev)
    ops.reset_launches()
    worst, top, where = oracle_check(torch, models, ocfg, omodel, tok, MAMBA_PROMPT,
                                     "mamba")
    oracle_launches = {**ops.launches, **ops.variant_launches}
    want = predicted_model_launches(ocfg, 2 + MAMBA_NEW, 1, cacheless=1)
    if oracle_launches != want:
        raise AssertionError(f"mamba oracle launches {oracle_launches}, expected {want}")
    causes = oracle_causes(torch, models, ocfg, omodel, tok, MAMBA_PROMPT, "mamba")
    log(f"mamba: oracle ({ORACLE_LAYERS} layers, full width, f32) prefill + {MAMBA_NEW} "
        f"teacher-forced decode steps match the cache-less forward over "
        f"{MAMBA_PROMPT + MAMBA_NEW} positions within {ORACLE_TOL} (max abs diff {worst}: "
        f"{where}; logits up to {top}); {causes}; launches {oracle_launches}; "
        f"{time.perf_counter() - t0:.3f}s")
    del omodel
    torch.cuda.empty_cache()

    # card against CPU: reduced mamba2, f32
    t0 = time.perf_counter()
    scfg = configs.get_config(MAMBA_ARCH).reduced(dtype="float32")
    cpu_model = models.init_params(scfg, torch.Generator().manual_seed(2), "cpu")
    card_model = models.init_params(scfg, torch.Generator().manual_seed(2), "cpu").to(dev)
    sprompt = torch.from_numpy(rng.integers(0, scfg.vocab_size, (2, 20)))
    cpu_tok = serve.greedy_generate(scfg, cpu_model, sprompt, 8, "cpu")
    card_tok = serve.greedy_generate(scfg, card_model, sprompt, 8).cpu()
    if not torch.equal(cpu_tok, card_tok):
        raise AssertionError(f"mamba greedy tokens differ card vs CPU:\n{cpu_tok}\n{card_tok}")
    with torch.inference_mode():
        cpu_logits, _, _ = models.forward(scfg, cpu_model, sprompt)
        card_logits, _, _ = models.forward(scfg, card_model, sprompt.to(dev))
    diff = float((card_logits.cpu() - cpu_logits).abs().max())
    if not bool(torch.isclose(card_logits.cpu(), cpu_logits, rtol=CARD_CPU_LOGIT_TOL,
                              atol=CARD_CPU_LOGIT_TOL).all()):
        raise AssertionError(f"mamba forward logits differ card vs CPU by {diff}")
    log(f"mamba: reduced {MAMBA_ARCH} (f32) card vs CPU: the same greedy tokens "
        f"{card_tok[0].tolist()}; forward logits within {CARD_CPU_LOGIT_TOL} (max abs "
        f"diff {diff}); {time.perf_counter() - t0:.3f}s")
    return serve_launches, long_launches, oracle_launches


# ---------------------------------------------------------------------------
# phase 12: MoE and hybrid serving
# ---------------------------------------------------------------------------

def moe_serve(torch, np, dev, cfg, label):
    """``cfg`` (bf16, random seeded weights) answers SERVE_BATCH requests of
    SERVE_PROMPT tokens with SERVE_NEW greedy tokens through
    ``greedy_generate``, its launches held to
    :func:`predicted_model_launches`; then one prefill and one decode step
    counting the (token, expert) pairs their MoE layers drop, and the
    prefill and a decode window under ``torch.profiler``. Returns the
    serving run's launches and its numbers."""
    from repro_torch import models, serve
    from repro_torch.kernels import ops
    from repro_torch.models.layers import moe_capacity

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = models.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != cfg.param_count():
        raise AssertionError(f"{n_params} parameters, config counts {cfg.param_count()}")
    n_moe = sum(mlp == "moe" for _, mlp in models.transformer.layer_kinds(cfg))
    log(f"moe: {label}: {cfg.name} {cfg.n_layers} layers ({n_moe} MoE of "
        f"{cfg.moe_experts} experts top-{cfg.moe_top_k}, ffe {cfg.moe_d_ff}, shared "
        f"{cfg.moe_shared_experts}) d_model {cfg.d_model} heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads} head_dim {cfg.head_dim_} vocab {cfg.vocab_size} "
        f"capacity factor {cfg.moe_capacity_factor} {cfg.dtype}: {n_params} parameters, "
        f"{sum(p.nbytes for p in model.parameters())} B, init "
        f"{time.perf_counter() - t0:.3f}s")
    prompt = torch.from_numpy(np.random.default_rng(11).integers(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT)))

    def generate(max_new):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = serve.greedy_generate(cfg, model, prompt, max_new)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    generate(2)                                   # warm-up (cuBLAS, allocator)
    _, prefill_s = generate(1)                    # prefill and one argmax
    ops.reset_launches()
    out, total_s = generate(SERVE_NEW)
    launches = {**ops.launches, **ops.variant_launches}
    peak = torch.cuda.max_memory_allocated()
    decode_ms = (total_s - prefill_s) / (SERVE_NEW - 1) * 1e3
    if out.shape != (SERVE_BATCH, SERVE_NEW) or not bool(
            ((out >= 0) & (out < cfg.vocab_size)).all()):
        raise AssertionError(f"{label}: generated tokens {tuple(out.shape)} out of range")
    want = predicted_model_launches(cfg, SERVE_NEW, 1)
    if launches != want:
        raise AssertionError(f"{label}: serving launches {launches}, expected {want}")
    numbers = dict(prefill_s=prefill_s, decode_ms=decode_ms,
                   tokens_per_s=SERVE_BATCH * SERVE_NEW / total_s, peak=peak)
    log(f"moe: {label}: {SERVE_BATCH} requests x {SERVE_PROMPT}-token prompts, "
        f"{SERVE_NEW} new tokens each: total {total_s:.4f}s, prefill {prefill_s:.4f}s, "
        f"decode {decode_ms:.3f} ms/token (per step of {SERVE_BATCH}), "
        f"{numbers['tokens_per_s']:.2f} tokens/s; max_memory_allocated {peak} B; "
        f"launches {launches} (as predicted)")
    log(f"moe: {label}: sample {out[0, :12].tolist()}")
    pre_stats, dec_stats = {}, {}
    with torch.inference_mode():
        cache = models.make_cache(cfg, SERVE_BATCH, SERVE_PROMPT + 1, dev)
        logits, cache = models.prefill(cfg, model, prompt.to(dev), cache,
                                       moe_stats=pre_stats)
        models.decode_step(cfg, model, torch.argmax(logits[..., :cfg.vocab_size], -1),
                           cache, SERVE_PROMPT, moe_stats=dec_stats)
    del cache, logits
    log(f"moe: {label}: dropped (token, expert) pairs at capacity factor "
        f"{cfg.moe_capacity_factor}: prefill {pre_stats['dropped']} of "
        f"{pre_stats['routed']} ({moe_capacity(cfg, SERVE_BATCH * SERVE_PROMPT)} slots an "
        f"expert), one decode step {dec_stats['dropped']} of {dec_stats['routed']} "
        f"({moe_capacity(cfg, SERVE_BATCH)} slot an expert), over {n_moe} MoE layers")
    pre_wall, pre, _ = device_kernel_times(
        torch, lambda: serve.greedy_generate(cfg, model, prompt, 1))
    both_wall, both, _ = device_kernel_times(
        torch, lambda: serve.greedy_generate(cfg, model, prompt, 1 + PROFILE_STEPS))
    dec = {k: (us - pre.get(k, (0.0, 0))[0], n - pre.get(k, (0.0, 0))[1])
           for k, (us, n) in both.items()}
    log_breakdown(f"{label} prefill ({SERVE_BATCH} x {SERVE_PROMPT} tokens)", pre_wall, pre,
                  phase="moe")
    log_breakdown(f"{label} decode step (mean of {PROFILE_STEPS})", both_wall - pre_wall,
                  {k: v for k, v in dec.items() if v[0] > 0}, PROFILE_STEPS, phase="moe")
    if cfg.has_mixer("ssm"):   # the scan at state 16: its three kernels' share
        scan_us = sum(us for k, (us, _) in pre.items() if "ssd_" in k)
        log(f"moe: {label}: the SSD scan's kernels {scan_us / 1e3:.4f} ms of the prefill")
    del model, out
    torch.cuda.empty_cache()
    return launches, numbers


def moe_oracle(torch, np, dev, cfg, new, label):
    """``cfg`` in f32 at ``MOE_ORACLE_CAPACITY`` (drop-free), random seeded
    weights: prefill + ``new`` teacher-forced decode steps against the
    cache-less forward (:func:`oracle_check`), launches as predicted, no
    pair dropped; then :func:`oracle_causes`. Returns the launches."""
    from repro_torch import models
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = models.init_params(cfg, torch.Generator(device=dev).manual_seed(1), dev)
    tok = torch.from_numpy(np.random.default_rng(12).integers(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT + new))).to(dev)
    ops.reset_launches()
    stats = {}
    worst, top, where = oracle_check(torch, models, cfg, model, tok, SERVE_PROMPT, label,
                                     stats)
    launches = {**ops.launches, **ops.variant_launches}
    want = predicted_model_launches(cfg, 2 + new, 1, cacheless=1)
    if launches != want:
        raise AssertionError(f"{label} oracle launches {launches}, expected {want}")
    causes = oracle_causes(torch, models, cfg, model, tok, SERVE_PROMPT, label)
    if stats.get("dropped"):
        raise AssertionError(f"{label} oracle dropped {stats['dropped']} pairs at "
                             f"capacity factor {cfg.moe_capacity_factor}")
    routing = (f"capacity factor {cfg.moe_capacity_factor}: 0 of {stats['routed']} pairs "
               f"dropped" if stats else "no MoE layer")
    log(f"moe: {label} oracle ({cfg.n_layers} layers, d_model {cfg.d_model}, f32, "
        f"{routing}) prefill + {new} teacher-forced decode steps match the cache-less "
        f"forward over {SERVE_PROMPT + new} positions within {ORACLE_TOL} (max abs diff "
        f"{worst}: {where}; logits up to {top}); {causes}; launches {launches}; "
        f"max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} B; {time.perf_counter() - t0:.3f}s")
    del model
    torch.cuda.empty_cache()
    return launches


def moe_card_vs_cpu(torch, np, dev):
    """Reduced qwen2-moe-a2.7b and jamba-v0.1-52b (capacity factor 1.25:
    tokens drop), llava-next-34b (seeded patch embeddings) and
    musicgen-large, f32, card against CPU: the same greedy tokens, forward
    logits within CARD_CPU_LOGIT_TOL."""
    from repro_torch import configs, models, serve

    rng = np.random.default_rng(13)
    for arch in (MOE_ARCH, JAMBA_ARCH, "llava-next-34b", "musicgen-large"):
        t0 = time.perf_counter()
        scfg = configs.get_config(arch).reduced(dtype="float32")
        cpu_model = models.init_params(scfg, torch.Generator().manual_seed(2), "cpu")
        card_model = models.init_params(scfg, torch.Generator().manual_seed(2),
                                        "cpu").to(dev)
        sprompt = torch.from_numpy(rng.integers(0, scfg.vocab_size, (2, 24)))
        patches = None
        if scfg.frontend == "vlm":
            patches = torch.from_numpy(rng.standard_normal(
                (2, scfg.vlm_patches, scfg.d_model)).astype(np.float32))
        cpu_tok = serve.greedy_generate(scfg, cpu_model, sprompt, 8, "cpu",
                                        patch_embeds=patches)
        card_tok = serve.greedy_generate(scfg, card_model, sprompt, 8,
                                         patch_embeds=patches).cpu()
        if not torch.equal(cpu_tok, card_tok):
            raise AssertionError(f"{arch}: greedy tokens differ card vs CPU:\n"
                                 f"{cpu_tok}\n{card_tok}")
        with torch.inference_mode():
            cpu_logits, cpu_aux, _ = models.forward(scfg, cpu_model, sprompt,
                                                    patch_embeds=patches)
            card_logits, card_aux, _ = models.forward(
                scfg, card_model, sprompt.to(dev),
                patch_embeds=None if patches is None else patches.to(dev))
        diff = float((card_logits.cpu() - cpu_logits).abs().max())
        if not bool(torch.isclose(card_logits.cpu(), cpu_logits, rtol=CARD_CPU_LOGIT_TOL,
                                  atol=CARD_CPU_LOGIT_TOL).all()):
            raise AssertionError(f"{arch}: forward logits differ card vs CPU by {diff}")
        if not math.isclose(float(card_aux), float(cpu_aux), rel_tol=CARD_CPU_LOGIT_TOL,
                            abs_tol=CARD_CPU_LOGIT_TOL):
            raise AssertionError(f"{arch}: MoE aux {float(card_aux)} on the card, "
                                 f"{float(cpu_aux)} on the CPU")
        log(f"moe: reduced {arch} ({scfg.family}, f32{', 8 patches' if patches is not None else ''}) "
            f"card vs CPU: the same greedy tokens {card_tok[0].tolist()}; forward logits "
            f"within {CARD_CPU_LOGIT_TOL} (max abs diff {diff}), aux {float(card_aux)}; "
            f"{time.perf_counter() - t0:.3f}s")


def moe_phase(torch, np, dev):
    """qwen2-moe-a2.7b at full width and depth and jamba-v0.1-52b at full
    width and JAMBA_LAYERS layers serve (:func:`moe_serve`); each one's f32
    oracle (:func:`moe_oracle`: qwen2-moe at ORACLE_LAYERS, jamba at its
    JAMBA_LAYERS, then again with dense FFNs in place of its MoE layers);
    the reduced models card against CPU. Returns the launches of the two
    serving runs and the three oracles."""
    import dataclasses as dc

    from repro_torch import configs

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 products in full f32
    torch.backends.cudnn.allow_tf32 = False
    qwen = configs.get_config(MOE_ARCH)
    jamba = dc.replace(configs.get_config(JAMBA_ARCH), n_layers=JAMBA_LAYERS)
    runs = []
    for cfg, label, oracle_layers, new in ((qwen, "qwen2-moe", ORACLE_LAYERS, SERVE_NEW),
                                          (jamba, "jamba-8L", JAMBA_LAYERS, JAMBA_ORACLE_NEW)):
        launches, _ = moe_serve(torch, np, dev, cfg, label)
        runs.append(launches)
        ocfg = dc.replace(cfg, n_layers=oracle_layers, dtype="float32",
                          moe_capacity_factor=MOE_ORACLE_CAPACITY)
        runs.append(moe_oracle(torch, np, dev, ocfg, new, label))
    # jamba's oracle again with dense FFNs in the MoE layers' place: what the
    # SSM stack alone makes of the rounding, without top-k routing
    dense = dc.replace(jamba, dtype="float32", pattern=tuple(
        (mixer, "mlp" if ffn == "moe" else ffn) for mixer, ffn in jamba.pattern))
    runs.append(moe_oracle(torch, np, dev, dense, JAMBA_ORACLE_NEW, "jamba-8L-dense"))
    moe_card_vs_cpu(torch, np, dev)
    return runs


# ---------------------------------------------------------------------------
# phase 13: training
# ---------------------------------------------------------------------------

def predicted_train_launches(cfg, steps, n_micro) -> dict:
    """Launches of one ``run_training`` under remat ``block``, per
    microbatch, from the layers ``models.layer_kinds`` gives: every layer's
    forward runs once, and again in its checkpoint region's recompute (the
    final norm lies outside the regions and runs once). A layer's RMSNorms
    are its block norm, its feed-forward's norm where it has a feed-forward
    and, for Mamba-2, the mixer's gated norm; an attention layer launches
    the flash forward in each pass and each flash backward kernel once; a
    Mamba-2 layer the SSD scan in each pass. The backwards of RMSNorm and
    of the SSD scan are PyTorch ops: no launch. Every flash launch takes
    the variant the config's dtype and head dim call for (bf16: the tensor
    cores)."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.transformer import layer_kinds

    kinds = layer_kinds(cfg)
    norms = sum(1 + (mlp is not None) + (mixer == "ssm") for mixer, mlp in kinds)
    attn = sum(mixer == "attn" for mixer, _ in kinds)
    ssm = len(kinds) - attn
    n = steps * n_micro
    counts = {"rmsnorm": n * (2 * norms + 1), "rmsnorm/residual": 0, "rmsnorm/scalar": 0,
              "flash_fwd": n * 2 * attn, "flash_bwd_dq": n * attn,
              "flash_bwd_dkv": n * attn, "ssd_scan": n * 2 * ssm,
              **dict.fromkeys(FLASH_VARIANTS, 0)}
    dtype = getattr(torch, cfg.dtype)
    for kernel in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        counts[f"{kernel}/{fa.variant(kernel, dtype, cfg.head_dim_)}"] += counts[kernel]
    return counts


def train_run(torch, dev, root, dcfg, cfg) -> dict:
    """``run_training`` of ``cfg`` on the card (``TRAIN_STEPS`` steps of
    ``TRAIN_ROWS`` rows in microbatches of ``cfg.microbatch_size``, its final
    write-behind save under ``root / "ckpt"``, removed after), then one more
    step under ``torch.profiler`` (for a model with Mamba-2 layers, the SSD
    backward's share of it from one call's device time by op,
    :func:`ssd_bwd_by_op`).
    Raises unless the launches are those
    :func:`predicted_train_launches` gives, the losses and gradient norms are
    finite and, for bf16, every flash launch ran on the tensor cores (checked
    last, after the numbers are logged). Returns the launch counts."""
    from repro_torch.data import BatchIterator
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import layer_kinds
    from repro_torch.train import AdamWConfig, make_train_step
    from repro_torch.train.loop import LoopConfig, run_training

    n_micro = TRAIN_ROWS // cfg.microbatch_size
    metrics = []
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = run_training(
        cfg, LoopConfig(steps=TRAIN_STEPS, batch_size=TRAIN_ROWS, ckpt_every=TRAIN_STEPS + 1,
                        ckpt_dir=str(root / "ckpt"), data_dir=str(root / "data")),
        dcfg, AdamWConfig(),
        on_step=lambda step, m: metrics.append(
            {"step": step, **{k: float(v) for k, v in m.items()}}),
        device=dev)
    run_s = time.perf_counter() - t0
    launches = {**ops.launches, **ops.variant_launches}
    peak = torch.cuda.max_memory_allocated()
    want = predicted_train_launches(cfg, TRAIN_STEPS, n_micro)
    if launches != want:
        raise AssertionError(f"{cfg.name}: training launches {launches}, predicted {want}")
    if len(metrics) != TRAIN_STEPS or not all(
            math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]) for m in metrics):
        raise AssertionError(f"{cfg.name}: training metrics not finite: {metrics}")
    state = res["state"]
    n_params = sum(p.numel() for p in state["params"].parameters())
    if n_params != cfg.param_count():
        raise AssertionError(f"{n_params} parameters, config counts {cfg.param_count()}")
    state_bytes = sum(p.nbytes for p in state["params"].parameters()) + sum(
        t.nbytes for key in ("m", "v") for t in state["opt"][key].values())
    ckpt_bytes = sum(f.stat().st_size for f in (root / "ckpt").rglob("*") if f.is_file())
    tokens = TRAIN_ROWS * TRAIN_SEQ
    mixer = (f"SSD d_inner {cfg.ssm_d_inner} as {cfg.ssm_heads} heads of "
             f"{cfg.ssm_head_dim}, state {cfg.ssm_state}" if cfg.has_mixer("ssm") else
             f"heads {cfg.n_heads}/{cfg.n_kv_heads} head_dim {cfg.head_dim_}")
    log(f"train: {cfg.name} {cfg.n_layers} layers d_model {cfg.d_model} {mixer} d_ff "
        f"{cfg.d_ff} vocab {cfg.vocab_size} {cfg.dtype}, moments {cfg.opt_state_dtype}, "
        f"remat {cfg.remat_policy}: {n_params} parameters, state {state_bytes} B")
    for m, secs in zip(metrics, res["step_seconds"]):
        log(f"train: {cfg.name} step {m['step']} loss {m['loss']} grad_norm {m['grad_norm']} "
            f"lr {m['lr']} seconds {secs:.4f} tokens/s {tokens / secs:.1f}")
    log(f"train: {cfg.name} {TRAIN_STEPS} steps x {TRAIN_ROWS} rows x {TRAIN_SEQ} tokens in "
        f"{n_micro} microbatches: run_training {run_s:.3f}s, steps "
        f"{sum(res['step_seconds']):.3f}s, max_memory_allocated {peak} B; final write-behind "
        f"save {ckpt_bytes} B in {res['ckpt'].write_seconds:.3f}s; launches {launches} as "
        "predicted")
    del res
    shutil.rmtree(root / "ckpt")

    # -- one more step under the profiler
    it = BatchIterator(root / "data", dcfg, TRAIN_ROWS, device=dev)
    batch = it.next_batch()
    step_fn = make_train_step(cfg, AdamWConfig(), global_rows=TRAIN_ROWS)
    wall, by_name, _ = device_kernel_times(
        torch, lambda: step_fn(state, batch),
        sums=f"{cfg.name} train step" if cfg.name == SUM_TRAIN_ARCH else None)
    log_breakdown(f"{cfg.name} train step ({TRAIN_ROWS} x {TRAIN_SEQ} tokens)", wall, by_name,
                  phase="train")
    if cfg.has_mixer("ssm"):
        # one SSD backward a Mamba-2 layer and microbatch, each at the same
        # shapes: one call's device time by op, times the calls, against
        # the step's device time
        calls = n_micro * sum(m == "ssm" for m, _ in layer_kinds(cfg))
        per_call, by_op = ssd_bwd_by_op(torch, dev, cfg, TRAIN_ROWS // n_micro, TRAIN_SEQ)
        busy = sum(us for us, _ in by_name.values()) / 1e3
        log(f"train: {cfg.name} profiled step: SSD backward (PyTorch ops) {calls} calls x "
            f"{per_call:.4f} ms device = {calls * per_call:.3f} ms of {busy:.3f} ms device "
            f"time, share {calls * per_call / busy:.4f}; by op (device ms a call): " + "; ".join(
                f"{name} {ms:.4f}" for name, ms in by_op.most_common(12) if ms > 0))
    if cfg.has_mixer("attn"):
        flash = {name: us for name, (us, _) in by_name.items() if "flash_" in name}
        log(f"train: {cfg.name} profiled step: flash kernels {sum(flash.values()) / 1e3:.4f} "
            "ms device time: " + "; ".join(
                f"{us / 1e3:.4f} ms {name[:60]}"
                for name, us in sorted(flash.items(), key=lambda kv: -kv[1])))
    if any(mlp == "moe" for _, mlp in layer_kinds(cfg)):
        moe_step_split(torch, cfg, lambda: step_fn(state, batch), by_name, wall)
    del state, step_fn, batch
    torch.cuda.empty_cache()
    if cfg.has_mixer("attn") and cfg.dtype == "bfloat16" and not all(
            launches[f"{k}/mma"] == launches[k] > 0
            for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")):
        raise AssertionError(f"{cfg.name}: bf16 flash launches not all on the tensor cores: "
                             f"{launches}")
    return launches


def moe_step_split(torch, cfg, fn, by_name, wall) -> None:
    """One more step of an MoE model (``fn``) under ``torch.profiler`` with
    host activity: its kernels' device ms by the PyTorch op that launched
    them (each op's own kernels, not its children's), logged as the
    experts' ``bmm``, the routing and dispatch ops (``ROUTING_OPS``), the
    other GEMMs and the flash kernels (launched through ctypes, under no
    op: from the device-only profile ``by_name`` of the step before, whose
    host wall is ``wall`` s), beside that step's device busy time and
    share, and the top ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_op = collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.self_device_time_total > 0:
            by_op[e.name] += e.self_device_time_total / 1e3
    busy = sum(us for us, _ in by_name.values()) / 1e3
    split = {"experts' bmm": by_op["aten::bmm"],
             "routing and dispatch": sum(by_op[o] for o in ROUTING_OPS),
             "other GEMMs (mm, addmm)": sum(by_op[o] for o in GEMM_OPS),
             "flash": sum(us for name, (us, _) in by_name.items() if "flash_" in name) / 1e3}
    log(f"train: {cfg.name} profiled step split (device ms, share of the step's "
        f"{busy:.3f} ms device busy; busy share {busy / (wall * 1e3):.4f} of its "
        f"{wall:.4f} s wall): " + "; ".join(f"{k} {ms:.3f} ({ms / busy:.4f})"
                                             for k, ms in split.items()))
    log(f"train: {cfg.name} profiled step, device ms by op: " + "; ".join(
        f"{name} {ms:.3f}" for name, ms in by_op.most_common(14)))


def ssd_bwd_by_op(torch, dev, cfg, rows, seq) -> tuple[float, dict]:
    """One ``ssd_scan_bwd`` call at a training microbatch's shapes of
    ``cfg``'s Mamba-2 layers (``rows`` x ``seq``, in its dtype; random
    inputs: the call's work depends on the shapes alone) under
    ``torch.profiler`` with host and device activity: its device ms, and
    that time split by the PyTorch op that launched each kernel (the op's
    own kernels, summed by name over the call's ops)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ssd_scan as mod

    h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    dtype = getattr(torch, cfg.dtype)
    gen = torch.Generator(device=dev).manual_seed(6)
    x, dy = (torch.randn((rows, seq, h, p), generator=gen, device=dev).to(dtype)
             for _ in range(2))
    dt = (torch.nn.functional.softplus(torch.randn((rows, seq, h), generator=gen, device=dev))
          * 0.1).to(dtype)
    bc = (torch.randn((rows, seq, 2 * n), generator=gen, device=dev) / n**0.5).to(dtype)
    args = (x, dt, -torch.rand((h,), generator=gen, device=dev), bc[..., :n], bc[..., n:], dy)
    mod.ssd_scan_bwd(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("ssd_scan_bwd"):
            mod.ssd_scan_bwd(*args)
        torch.cuda.synchronize()
    events = prof.events()
    (call,) = [e for e in events if e.name == "ssd_scan_bwd" and e.device_type == DeviceType.CPU]
    by_op = collections.Counter()

    def walk(e):
        for ch in e.cpu_children:
            by_op[ch.name] += ch.self_device_time_total / 1e3
            walk(ch)

    walk(call)
    return call.device_time_total / 1e3, by_op


@contextlib.contextmanager
def recording_topk(torch, layers, calls: list):
    """While open, each ``layers.moe_forward`` call first appends its
    tokens' top-k expert ids (ascending, on the CPU) to ``calls``, routed
    as ``moe_forward`` routes them (f32 router logits, padded experts
    masked, softmax, ``topk``)."""
    original = layers.moe_forward

    def recorded(cfg, p, x, *args, **kwargs):
        with torch.no_grad():
            logits = x.reshape(-1, x.shape[-1]).float() @ p.router
            e = cfg.moe_experts_padded
            if e > cfg.moe_experts:
                logits = logits.masked_fill(
                    torch.arange(e, device=x.device) >= cfg.moe_experts, -1e9)
            topi = torch.topk(torch.softmax(logits, dim=-1), cfg.moe_top_k, dim=-1)[1]
            calls.append(torch.sort(topi, dim=-1)[0].cpu())
        return original(cfg, p, x, *args, **kwargs)

    layers.moe_forward = recorded
    try:
        yield calls
    finally:
        layers.moe_forward = original


def train_card_vs_cpu(torch, np, dev, scfg, seq_len, kernels, label, per_step=False):
    """The reduced f32 model ``scfg`` on the card against the CPU, from the
    same weights: one microbatch's gradients before any update, then 2
    AdamW steps of 4 rows of ``seq_len`` in 2 microbatches, within
    ``SMALL_TRAIN_TOL``; the card must launch each of ``kernels`` and the
    CPU none. For a model with MoE layers, logs how many tokens' top-k
    expert sets differ between card and CPU in that first microbatch. With
    ``per_step``, the card's own two steps are logged (losses, gradient
    norms and the tokens whose top-k set differs, by step) and the steps
    held are the card's from the CPU's state before each, copied over bit
    for bit: where Adam turns a near-zero gradient's last bits into a step
    of up to twice the learning rate, a router moved so can swap a token's
    experts, a discrete change no tolerance covers. Returns the card's
    train state and its first-microbatch gradients (CPU copies, by name)."""
    import copy

    from repro_torch import models
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    from repro_torch.train import AdamWConfig, init_train_state, make_train_step

    t0 = time.perf_counter()
    cpu_model = models.init_params(scfg, torch.Generator().manual_seed(3), "cpu")
    places = {"cpu": torch.device("cpu"), "card": dev}
    states = {"cpu": init_train_state(scfg, cpu_model),
              "card": init_train_state(scfg, copy.deepcopy(cpu_model).to(dev))}
    rng = np.random.default_rng(8)
    seqs = [torch.from_numpy(rng.integers(0, scfg.vocab_size, (4, seq_len)).astype(np.int32))
            for _ in range(2)]

    routed = {"card": [], "cpu": []}

    def first_grads(where):
        mb = {"tokens": seqs[0][:2, :-1].to(places[where]),
              "labels": seqs[0][:2, 1:].to(places[where])}
        model = states[where]["params"]
        with recording_topk(torch, L, routed[where]):
            loss, _ = models.lm_loss(scfg, model, mb)
        return [g.cpu() for g in torch.autograd.grad(loss, list(model.parameters()))]

    card_grads = first_grads("card")
    for g_card, g_cpu in zip(card_grads, first_grads("cpu")):
        if not bool(torch.isclose(g_card, g_cpu, rtol=SMALL_TRAIN_TOL["grad_rtol"],
                                  atol=SMALL_TRAIN_TOL["grad_atol"]).all()):
            raise AssertionError(f"{label}: card vs CPU gradients differ by up to "
                                 f"{float((g_card - g_cpu).abs().max())}")
    if routed["card"]:
        differ = [int((a != b).any(dim=-1).sum()) for a, b in zip(routed["card"], routed["cpu"])]
        log(f"train: {label} first microbatch: {len(differ)} MoE layers' forwards of "
            f"{routed['card'][0].shape[0]} tokens; tokens whose top-"
            f"{scfg.moe_top_k} expert set differs card vs CPU: {differ} (sum {sum(differ)})")
    runs, before = {}, []
    for where, st in states.items():   # the CPU first
        step_fn = make_train_step(scfg, AdamWConfig(**SMALL_TRAIN_OPT), global_rows=4)
        ops.reset_launches()
        mets, calls = [], []
        for s_ in seqs:
            if where == "cpu":
                before.append(copy.deepcopy(st))
            b_ = {"tokens": s_[:, :-1].to(places[where]),
                  "labels": s_[:, 1:].to(places[where])}
            calls.append([])
            with recording_topk(torch, L, calls[-1]) if per_step else contextlib.nullcontext():
                st, m = step_fn(st, b_)
            mets.append({k: float(v) for k, v in m.items()})
        states[where] = st
        runs[where] = (mets, dict(ops.launches), calls)
    if per_step:
        # the card's own two steps, logged; then each step on the card from
        # the CPU's state before it, held below
        swaps = [sum(int((a != b).any(dim=-1).sum()) for a, b in zip(c, p))
                 for c, p in zip(runs["card"][2], runs["cpu"][2])]
        log(f"train: {label} card vs CPU, each side on its own updates: losses "
            f"{[m['loss'] for m in runs['card'][0]]} vs {[m['loss'] for m in runs['cpu'][0]]}, "
            f"grad norms {[m['grad_norm'] for m in runs['card'][0]]} vs "
            f"{[m['grad_norm'] for m in runs['cpu'][0]]}; tokens whose top-{scfg.moe_top_k} "
            f"set differs, by step: {swaps}")
        step_fn = make_train_step(scfg, AdamWConfig(**SMALL_TRAIN_OPT), global_rows=4)
        mets = []
        for s_, st in zip(seqs, before):
            card_model = copy.deepcopy(st["params"]).to(dev).requires_grad_(True)
            st = {"params": card_model,
                  "opt": {"m": {k: t.to(dev) for k, t in st["opt"]["m"].items()},
                          "v": {k: t.to(dev) for k, t in st["opt"]["v"].items()},
                          "step": st["opt"]["step"].to(dev)}}
            st, m = step_fn(st, {"tokens": s_[:, :-1].to(dev), "labels": s_[:, 1:].to(dev)})
            mets.append({k: float(v) for k, v in m.items()})
        states["card"] = st
        runs["card"] = (mets, *runs["card"][1:])
    if any(runs["cpu"][1].values()) or not all(runs["card"][1][k] for k in kernels):
        raise AssertionError(f"{label} launches: CPU {runs['cpu'][1]}, card {runs['card'][1]}")
    for mc, mg in zip(runs["cpu"][0], runs["card"][0]):
        for key in ("loss", "grad_norm"):
            if not math.isclose(mg[key], mc[key], rel_tol=SMALL_TRAIN_TOL["loss"]):
                raise AssertionError(f"{label}: card vs CPU {key}: {mg[key]} vs {mc[key]}")
    cpu_p = dict(states["cpu"]["params"].named_parameters())
    diff = torch.cat([(p.detach().cpu() - cpu_p[n].detach()).abs().reshape(-1)
                      for n, p in states["card"]["params"].named_parameters()])
    worst = {"params": float(diff.max()),
             "params_share": float((diff > SMALL_TRAIN_TOL["params_close"]).float().mean())}
    for key in ("m", "v"):
        worst[key] = max(float((t.cpu() - states["cpu"]["opt"][key][n]).abs().max())
                         for n, t in states["card"]["opt"][key].items())
    if worst["params"] > SMALL_TRAIN_TOL["params_max"] or any(
            worst[k] > SMALL_TRAIN_TOL[k] for k in ("params_share", "m", "v")):
        raise AssertionError(f"{label}: card vs CPU state differs: {worst} (tolerance "
                             f"{SMALL_TRAIN_TOL})")
    log(f"train: {label} card vs CPU: first-microbatch gradients within "
        f"{SMALL_TRAIN_TOL['grad_atol']} + {SMALL_TRAIN_TOL['grad_rtol']}·|g|; 2 steps"
        f"{' (each from the CPU state before it)' if per_step else ''} of 2 "
        f"microbatches of {seq_len - 1} tokens: losses {[m['loss'] for m in runs['card'][0]]} "
        f"vs {[m['loss'] for m in runs['cpu'][0]]}, grad norms within "
        f"{SMALL_TRAIN_TOL['loss']} relative; worst abs diff {worst}; card launches "
        f"{runs['card'][1]}, CPU none; {time.perf_counter() - t0:.3f}s")
    names = [n for n, _ in states["card"]["params"].named_parameters()]
    return states["card"], dict(zip(names, card_grads))


def moe_determinism(torch, dev) -> None:
    """One full-width MoE layer of ``MOE_TRAIN_ARCH`` (bf16, seeded weights)
    on one training microbatch (``TRAIN_MICRO`` x ``TRAIN_SEQ`` tokens; 683
    slots an expert at capacity factor 1.25), forward and backward twice
    on the same input and cotangent: the gradients of x, the router,
    ``w_in``, ``w_out`` and the shared MLP must be bitwise equal. Then the
    dispatch gather the layer had before (``xf[token_of]``, each token k
    times, its backward an accumulating scatter) at the same routing, its
    backward twice: logged, not gated."""
    from repro_torch import configs
    from repro_torch.models import layers as L

    t0 = time.perf_counter()
    cfg = configs.get_config(MOE_TRAIN_ARCH)
    gen = torch.Generator(device=dev).manual_seed(11)
    moe = L.init_moe(cfg, gen).requires_grad_(True)
    names = ["x", *(n for n, _ in moe.named_parameters())]
    shape = (TRAIN_MICRO, TRAIN_SEQ, cfg.d_model)
    x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    dy = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    tokens = TRAIN_MICRO * TRAIN_SEQ
    cap = L.moe_capacity(cfg, tokens)
    if cap != 683:
        raise AssertionError(f"{cfg.name}: {cap} slots an expert at {tokens} tokens, not 683")

    def run():
        xx = x.clone().requires_grad_(True)
        stats = {}
        y, aux = L.moe_forward(cfg, moe, xx, cfg.mlp_kind, stats)
        grads = torch.autograd.grad((y.float() * dy.float()).sum() + aux,
                                    [xx, *moe.parameters()])
        return stats, dict(zip(names, grads))

    (stats, a), (_, b) = run(), run()
    same = {k: bitwise_equal(torch, [a[k]], [b[k]]) for k in names}
    log(f"train: {cfg.name} MoE layer (full width, bf16) on {TRAIN_MICRO} x {TRAIN_SEQ} "
        f"tokens, capacity {cap} slots, {stats['dropped']} of {stats['routed']} pairs "
        f"dropped: two forward + backward runs, gradients bitwise equal: {same}")
    if not all(same.values()):
        raise AssertionError(f"{cfg.name}: MoE backward differs between runs: {same}")
    # the earlier dispatch's gather, at this routing
    with torch.no_grad():
        xf = x.reshape(tokens, cfg.d_model)
        probs = torch.softmax(xf.float() @ moe.router, dim=-1)
        topi = torch.topk(probs, cfg.moe_top_k, dim=-1)[1]
        order = torch.sort(topi.reshape(-1), stable=True)[1]
        cot = torch.randn((tokens * cfg.moe_top_k, cfg.d_model), generator=gen,
                          device=dev).to(torch.bfloat16)
    leaf = xf.clone().requires_grad_(True)
    grads = [torch.autograd.grad(leaf[order // cfg.moe_top_k], leaf, cot)[0] for _ in range(2)]
    log(f"train: the earlier dispatch's gather xf[token_of] ({tokens} tokens x "
        f"{cfg.moe_top_k}, bf16): its backward twice bitwise equal: "
        f"{bitwise_equal(torch, grads[:1], grads[1:])}, max difference "
        f"{float((grads[0].float() - grads[1].float()).abs().max())}; "
        f"{time.perf_counter() - t0:.3f}s")


def remat_bitwise_on_card(torch, np, dev, scfg, seq_len, label) -> None:
    """The reduced model ``scfg`` on the card: one microbatch's loss and
    gradients under remat ``block`` must equal those under ``none`` bit for
    bit (the recompute routes as the forward did)."""
    import dataclasses as dc

    from repro_torch import models

    model = models.init_params(scfg, torch.Generator(device=dev).manual_seed(3), dev)
    model.requires_grad_(True)
    seq = torch.from_numpy(np.random.default_rng(8).integers(
        0, scfg.vocab_size, (2, seq_len)).astype(np.int32)).to(dev)
    mb = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
    out = {}
    for policy in ("none", "block"):
        loss, _ = models.lm_loss(dc.replace(scfg, remat_policy=policy), model, mb)
        out[policy] = [loss.detach().reshape(1),
                       *torch.autograd.grad(loss, list(model.parameters()))]
    if not bitwise_equal(torch, out["block"], out["none"]):
        raise AssertionError(f"{label}: remat block differs from none on the card")
    log(f"train: {label} on the card: loss and {len(out['none']) - 1} gradients under remat "
        "block bitwise equal to none")


def compression_on_card(torch, np, dev, scfg, seq_len, grads, label):
    """``ef_compress_tree`` on the card against the CPU on the same
    gradients (``grads``: CPU copies of the card's), two rounds (the second
    carrying the first's errors), with the train step's scale groups and
    with a scale a tensor: every dequantized gradient and error bitwise
    equal. Then 2 steps of ``make_train_step(compress_grads=True)`` of
    ``scfg`` on the card (4 rows of ``seq_len`` in 2 microbatches): finite
    losses and gradient norms, errors carried. Returns that train state."""
    from repro_torch import models
    from repro_torch.sharding import compression
    from repro_torch.train import AdamWConfig, init_train_state, make_train_step
    from repro_torch.train.step import _stacked_leaves

    t0 = time.perf_counter()
    for groups in (_stacked_leaves(scfg, grads), None):
        out = {}
        for where in ("cpu", "card"):
            g = {k: v.to("cpu" if where == "cpu" else dev) for k, v in grads.items()}
            err = compression.init_error_state(g)
            out[where] = []
            for _ in range(2):
                deq, err = compression.ef_compress_tree(g, err, groups)
                out[where] += [*deq.values(), *err.values()]
        if not bitwise_equal(torch, [t.cpu() for t in out["card"]], out["cpu"]):
            raise AssertionError(f"{label}: ef_compress_tree differs card vs CPU "
                                 f"({'grouped' if groups else 'a scale a tensor'})")
    model = models.init_params(scfg, torch.Generator(device=dev).manual_seed(3), dev)
    state = init_train_state(scfg, model, compress_grads=True)
    step_fn = make_train_step(scfg, AdamWConfig(**SMALL_TRAIN_OPT), global_rows=4,
                              compress_grads=True)
    rng = np.random.default_rng(8)
    mets = []
    for _ in range(2):
        seq = torch.from_numpy(rng.integers(0, scfg.vocab_size, (4, seq_len))
                               .astype(np.int32)).to(dev)
        state, m = step_fn(state, {"tokens": seq[:, :-1], "labels": seq[:, 1:]})
        mets.append({k: float(v) for k, v in m.items()})
    if not all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]) for m in mets):
        raise AssertionError(f"{label}: compressed training not finite: {mets}")
    if not any(bool(e.any()) for e in state["ef_error"].values()):
        raise AssertionError(f"{label}: compressed training carried no error")
    log(f"train: {label}: ef_compress_tree on the card bitwise equal to the CPU on its "
        f"first-microbatch card gradients ({len(grads)} tensors, two rounds, grouped as "
        f"the train step's leaves and a scale a tensor); 2 compressed steps on the card: "
        f"losses {[m['loss'] for m in mets]}, grad norms {[m['grad_norm'] for m in mets]}; "
        f"{time.perf_counter() - t0:.3f}s")
    return state


def train_phase(torch, np, dev, root):
    """Materialize the training data by S/C on the card, run stablelm-3b at
    full width and depth, stablelm-12b at full width with
    ``WIDE_TRAIN_LAYERS`` layers, mamba2-2.7b at full width with
    ``MAMBA_TRAIN_LAYERS`` layers and
    qwen2-moe-a2.7b at full width with ``MOE_TRAIN_LAYERS`` layers through
    :func:`train_run`; the MoE layer's backward twice, bitwise
    (:func:`moe_determinism`); then reduced GQA stablelm-3b, reduced
    mamba2, reduced qwen2-moe and reduced jamba (one pattern) card against
    CPU (:func:`train_card_vs_cpu`), reduced qwen2-moe's remat ``block``
    against ``none`` on the card, gradient compression on the card
    (:func:`compression_on_card`) and a checkpoint round trip of the
    plain and the compressed card states. Returns the launch counts of the
    four ``run_training`` runs, summed."""
    import dataclasses as dc

    from repro_torch import configs, models
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import DataConfig, materialize_dataset
    from repro_torch.train import init_train_state

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 products in full f32
    torch.backends.cudnn.allow_tf32 = False
    # -- the data, by S/C on the card
    t0 = time.perf_counter()
    dcfg = DataConfig(**TRAIN_DATA)
    data = materialize_dataset(dcfg, root / "data", device=dev)
    rep = data["report"]
    if not rep.peak_catalog_bytes <= dcfg.catalog_budget_bytes:
        raise AssertionError(f"data pipeline: peak catalog {rep.peak_catalog_bytes} "
                             f"exceeds budget {dcfg.catalog_budget_bytes}")
    missing = {n.name for n in data["workload"].nodes} - set(data["store"].manifest())
    if missing:
        raise AssertionError(f"data pipeline: manifest lacks {sorted(missing)}")
    packed = int(data["store"].read("index")["total"][0])
    log(f"train: data {dcfg.n_shards} shards x {dcfg.docs_per_shard} docs x "
        f"{dcfg.doc_len} tokens -> {packed} rows of {dcfg.seq_len} on {dev}: S/C "
        f"{rep.elapsed:.3f}s, plan flagged {sorted(data['plan'].flagged)} order "
        f"{list(data['plan'].order)}, catalog_hits {rep.catalog_hits}, peak catalog "
        f"{rep.peak_catalog_bytes:.0f} B within budget {dcfg.catalog_budget_bytes:.0f} B; "
        f"{time.perf_counter() - t0:.3f}s")

    # -- stablelm-3b at full width and depth, then stablelm-12b, mamba2-2.7b and
    # qwen2-moe-a2.7b, each at full width with its depth cut, through run_training
    runs = [configs.get_config(TRAIN_ARCH),
            dc.replace(configs.get_config(WIDE_TRAIN_ARCH), n_layers=WIDE_TRAIN_LAYERS),
            dc.replace(configs.get_config(MAMBA_TRAIN_ARCH), n_layers=MAMBA_TRAIN_LAYERS),
            dc.replace(configs.get_config(MOE_TRAIN_ARCH), n_layers=MOE_TRAIN_LAYERS)]
    counts = [train_run(torch, dev, root, dcfg, dc.replace(cfg, microbatch_size=TRAIN_MICRO))
              for cfg in runs]
    launches = {k: sum(c[k] for c in counts) for k in counts[0]}
    moe_determinism(torch, dev)

    # -- card against CPU: reduced stablelm-3b with GQA, reduced mamba2,
    # reduced qwen2-moe and reduced jamba (one pattern), f32
    scfg = configs.get_config(TRAIN_ARCH).reduced(dtype="float32", n_heads=8, n_kv_heads=2)
    flash = ("rmsnorm", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    state, grads = train_card_vs_cpu(torch, np, dev, scfg, 65, flash,
                                     f"reduced {TRAIN_ARCH} (GQA 8/2, f32)")
    train_card_vs_cpu(torch, np, dev,
                      configs.get_config(MAMBA_TRAIN_ARCH).reduced(dtype="float32"),
                      SMALL_MAMBA_SEQ, ("rmsnorm", "ssd_scan"),
                      f"reduced {MAMBA_TRAIN_ARCH} (f32)")
    qcfg = configs.get_config(MOE_TRAIN_ARCH).reduced(dtype="float32")
    train_card_vs_cpu(torch, np, dev, qcfg, 65, flash, f"reduced {MOE_TRAIN_ARCH} (f32)")
    train_card_vs_cpu(torch, np, dev,
                      configs.get_config("jamba-v0.1-52b").reduced(
                          dtype="float32", n_layers=SMALL_JAMBA_LAYERS),
                      SMALL_MAMBA_SEQ, (*flash, "ssd_scan"),
                      f"reduced jamba-v0.1-52b ({SMALL_JAMBA_LAYERS} layers, f32)", per_step=True)
    remat_bitwise_on_card(torch, np, dev, qcfg, 65, f"reduced {MOE_TRAIN_ARCH} (f32)")
    cstate = compression_on_card(torch, np, dev, scfg, 65, grads,
                                 f"reduced {TRAIN_ARCH} (GQA 8/2, f32)")

    # -- a checkpoint round trip of the card states, the compressed one with
    # its errors, bitwise
    mgr = CheckpointManager(root / "small_ckpt")
    saved = {"train": state, "compressed": cstate, "data": {"epoch": 1, "cursor": 8, "seed": 0}}
    mgr.save(saved, 2, blocking=True)

    def fresh(compress):
        return init_train_state(scfg, models.init_params(
            scfg, torch.Generator(device=dev).manual_seed(9), dev), compress_grads=compress)

    template = {"train": fresh(False), "compressed": fresh(True),
                "data": {"epoch": 0, "cursor": 0, "seed": 0}}
    restored = mgr.restore(template)

    def tensors(tr):
        return [t.detach() for key in ("train", "compressed") for t in (
            *tr[key]["params"].parameters(), *tr[key]["opt"]["m"].values(),
            *tr[key]["opt"]["v"].values(), tr[key]["opt"]["step"].reshape(1),
            *tr[key].get("ef_error", {}).values())]

    if len(tensors(restored)) != len(tensors(saved)) or not bitwise_equal(
            torch, tensors(restored), tensors(saved)) or restored["data"] != saved["data"]:
        raise AssertionError("checkpoint round trip is not bitwise")
    log(f"train: checkpoint save -> restore of the card states bitwise "
        f"({len(tensors(saved))} tensors, the compressed state's {len(cstate['ef_error'])} "
        f"errors among them; step {int(restored['train']['opt']['step'])})")
    shutil.rmtree(root, ignore_errors=True)
    return launches


# ---------------------------------------------------------------------------
# phases 5 and 9: the refresh round
# ---------------------------------------------------------------------------

def on_device_fns(torch, wl, dev_type):
    """The workload with every node fn wrapped to check that each table it
    is handed and each table it returns lies on ``dev_type``."""
    def check(name, table):
        for col, v in table.items():
            if v.device.type != dev_type:
                raise AssertionError(f"{name}.{col} on {v.device}, not {dev_type}")

    def wrap(node):
        def fn(inputs):
            for t in inputs:
                check(node.name + " input", t)
            out = node.fn(inputs)
            check(node.name, out)
            return out
        return dataclasses.replace(node, fn=fn)

    return dataclasses.replace(wl, nodes=[wrap(n) for n in wl.nodes])


def sized_by(mv, wl, nbytes):
    """``wl`` with each node sized as ``calibrate_sizes`` sizes it from the
    bytes its output took (``nbytes[name]``; at least 1 B)."""
    return mv.Workload(wl.name, [
        dataclasses.replace(n, size=max(float(nbytes.get(n.name, n.size)), 1.0))
        for n in wl.nodes], dict(wl.meta))


def calibrate_in_memory(mv, wl):
    """``calibrate_sizes`` without its store: every node computed once, in
    topological order on the workload's device, its output's bytes recorded
    and the output dropped after its last child ran (no write, no fsync)."""
    from repro_torch.mv.storage import table_nbytes

    graph = wl.to_graph()
    left = [len(graph.children[v]) for v in range(wl.n)]
    outs, nbytes = {}, {}
    for v in graph.topological_order():
        node = wl.nodes[v]
        outs[v] = node.fn([outs[p] for p in node.parents])
        nbytes[node.name] = table_nbytes(outs[v])
        for p in node.parents:
            left[p] -= 1
            if left[p] == 0:
                del outs[p]
        if left[v] == 0:
            del outs[v]
    return sized_by(mv, wl, nbytes)


def refresh_round(torch, core, mv, root, bytes_per_root, budget, device):
    """Realize, then a serial run, which is also the calibration run
    (``calibrate_sizes`` runs the same serial plan with no catalog: its
    manifest sizes the workload), then solve and an S/C run. Returns the
    stores, reports, plan and launch counts of each step."""
    from repro_torch.mv import dataplane as dp

    wl = mv.realize_workload(mv.generate_workload(12, seed=4),
                             bytes_per_root=bytes_per_root, device=device)
    wl = on_device_fns(torch, wl, torch.device(device).type)
    dp.reset_launches()
    with probe_shapes(dp) as shapes:
        serial = mv.DiskStore(root / "serial", device=device)
        serial_rep = mv.Controller(wl, serial, 0.0).run(core.serial_plan(wl.to_graph()))
        wl = sized_by(mv, wl, serial.manifest())
        graph = wl.to_graph()
        plan = core.solve(graph, budget=budget)
        before_sc = dict(dp.launches)
        sc = mv.DiskStore(root / "sc", device=device)
        sc_rep = mv.Controller(wl, sc, budget).run(plan)
    launches = dict(dp.launches)
    sc_launches = {k: launches[k] - before_sc[k] for k in launches}
    names = [n.name for n in wl.nodes]
    for store in (serial, sc):
        missing = set(names) - set(store.manifest())
        if missing:
            raise AssertionError(f"manifest lacks {sorted(missing)}")
    if not sc_rep.peak_catalog_bytes <= budget:
        raise AssertionError(
            f"peak catalog {sc_rep.peak_catalog_bytes} exceeds budget {budget}")
    return dict(wl=wl, graph=graph, plan=plan, serial=serial, sc=sc,
                serial_rep=serial_rep, sc_rep=sc_rep,
                launches=launches, sc_launches=sc_launches, names=names,
                variants=dict(dp.variant_launches), probe_shapes=shapes)


def device_kernel_times(torch, fn, sums: str | None = None):
    """Run ``fn`` under ``torch.profiler`` (device activity only): its wall
    seconds (host clock, synchronised), ``{kernel name: (device us,
    count)}`` and what ``fn`` returned. The device events are summed by
    name straight from the profiler's raw results: ``key_averages`` gives
    the same sums but first builds an event tree in Python, ~13 s for
    100,000 kernels on the card's host against ~1 s here (a Mamba-2
    training step launches about that many). With ``sums``, a label, it
    also logs the total through ``key_averages`` (every event's self
    device time) beside the raw one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            us, count = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (us + e.duration_ns() / 1e3, count + 1)
    if sums is not None:
        raw = sum(us for us, _ in by_name.values())
        averaged = sum(float(getattr(e, "self_device_time_total", 0.0) or 0.0)
                       for e in prof.key_averages())
        log(f"profiler sums {sums}: {sum(c for _, c in by_name.values())} device events, "
            f"raw {raw:.3f} us, key_averages {averaged:.3f} us, ratio {raw / averaged:.6f}")
    return wall, by_name, result


def profiled_round(torch, mv, wl, plan, budget, root):
    """Rerun the S/C round under ``torch.profiler`` (device activity only)
    and print the device's busy share and its top kernels."""
    _, by_name, rep = device_kernel_times(
        torch, lambda: mv.Controller(wl, mv.DiskStore(root, device="cuda"),
                                     budget).run(plan))
    copy_us = sum(us for k, (us, _) in by_name.items()
                  if k.startswith(("Memcpy", "Memset")))
    kernel_us = sum(us for us, _ in by_name.values()) - copy_us
    wall_us = rep.elapsed * 1e6
    log(f"profile: S/C round {rep.elapsed:.3f}s under the profiler; device "
        f"kernels {kernel_us / 1e3:.3f} ms, copies {copy_us / 1e3:.3f} ms; "
        f"busy share {(kernel_us + copy_us) / wall_us:.5f} "
        f"(kernels alone {kernel_us / wall_us:.6f})")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    for k, (us, count) in top:
        log(f"profile:   {us / 1e3:10.3f} ms  {count:5d}x  {k[:100]}")


# ---------------------------------------------------------------------------
# phases 6 and 9: the incremental scenario, hash-partitioned and unpartitioned
# ---------------------------------------------------------------------------

def run_scenarios(torch, core, mv, dp, wl, root, budget, device, n_rounds):
    """The incremental scenario P-way partitioned (``planner="auto"``) and
    unpartitioned on ``wl``, each into its own store, with the launch
    counts of each run; the partitioned stores must reassemble bitwise to
    the unpartitioned ones, and every round's catalog stay in budget."""
    spec = mv.UpdateSpec(**dict(SCENARIO, n_rounds=n_rounds))
    out = {}
    for label in ("partitioned", "unpartitioned"):
        store = mv.DiskStore(root / f"{label}_{device}", device=device)
        dp.reset_launches()
        t0 = time.perf_counter()
        with probe_shapes(dp) as shapes:
            if label == "partitioned":
                rep = mv.run_partitioned_scenario(wl, N_PARTITIONS, store, budget, spec,
                                                  core.PAPER_COST_MODEL, planner="auto")
            else:
                rep = mv.run_scenario(wl, store, budget, spec, core.PAPER_COST_MODEL)
        out[label] = dict(rep=rep, store=store, seconds=time.perf_counter() - t0,
                          launches=dict(dp.launches),
                          variants=dict(dp.variant_launches), probe_shapes=shapes)
        for r in rep.rounds:
            if not r.run.peak_catalog_bytes <= budget:
                raise AssertionError(
                    f"{label} round {r.round_idx}: peak catalog "
                    f"{r.run.peak_catalog_bytes} exceeds budget {budget}")
    t0 = time.perf_counter()
    mv.verify_partitioned_equivalence(wl, out["partitioned"]["store"],
                                      N_PARTITIONS, out["unpartitioned"]["store"])
    out["verify_seconds"] = time.perf_counter() - t0
    return out


def log_rounds(label, rep):
    """Per round: wall, planning and store seconds, catalog hits, the count
    of each refresh status, JOIN fallbacks and the skipped (clean) tasks."""
    for r in rep.rounds:
        counts = {s: list(r.statuses.values()).count(s)
                  for s in ("static", "appended", "delta", "replaced")}
        log(f"part: {label} round {r.round_idx} ({r.mode}) elapsed "
            f"{r.elapsed:.3f}s plan {r.plan_seconds:.3f}s read "
            f"{r.run.read_seconds:.3f}s write {r.run.write_seconds:.3f}s "
            f"catalog_hits {r.run.catalog_hits} peak_catalog "
            f"{r.run.peak_catalog_bytes:.0f} B flagged {len(r.plan.flagged)} "
            f"statuses {counts} join_fallbacks {r.join_fallbacks} "
            f"skipped {len(r.run.skipped)} {sorted(r.run.skipped)}")


# ---------------------------------------------------------------------------
# phase 8: the MQO shared-prefix path
# ---------------------------------------------------------------------------

def realize_shared_prefix(mv, bytes_per_root, device, root=None):
    """``shared_prefix_workload(MQO_VIEWS)`` realized on ``device`` and
    calibrated: by ``calibrate_sizes`` into a store under ``root`` (then
    removed), or without ``root`` in memory (``calibrate_in_memory``, the
    same sizes without writing every MV)."""
    wl = mv.realize_workload(mv.shared_prefix_workload(n_views=MQO_VIEWS),
                             bytes_per_root=bytes_per_root, device=device)
    if root is None:
        return calibrate_in_memory(mv, wl)
    wl = mv.calibrate_sizes(wl, mv.DiskStore(root / f"calib_{device}", device=device))
    shutil.rmtree(root / f"calib_{device}")
    return wl


def mqo_static_checks(wl, merged, spec):
    """Delta-safety over the realized workload (no gating finding), merge
    soundness of the real merge (nothing) and of the forged fixture
    (``unsound-merge``), all typed on the card."""
    from repro_torch.analysis import delta_safety, fixtures, gating, mqo_check

    _, findings = delta_safety.analyze_workload(wl, spec=spec, device="cuda")
    if gating(findings):
        raise AssertionError(f"mqo: gating delta-safety findings {gating(findings)}")
    unsound = mqo_check.check_merged(merged, device="cuda")
    if unsound:
        raise AssertionError(f"mqo: check_merged flags the real merge: {unsound}")
    forged = mqo_check.check_merged(fixtures.forged_threshold_merge(device="cuda"),
                                    device="cuda")
    if not any(f.rule == "unsound-merge" for f in forged):
        raise AssertionError(f"mqo: the forged merge is not unsound-merge: {forged}")
    log(f"mqo: delta-safety {len(findings)} findings, none gating "
        f"({sorted({f.rule for f in findings})}); check_merged silent on the merge, "
        f"unsound-merge on the forged fixture")


def check_once_per_round(label, rep, wl, merged):
    """Each shared class runs once a round: its representative once in the
    merged run, each member once in the unshared run."""
    for r in rep.rounds:
        counts = collections.Counter(r.run.executed)
        for rep_name, members in merged.classes.items():
            if len(members) < 2:
                continue
            names = ([rep_name] if label == "merged"
                     else [wl.nodes[m].name for m in members])
            runs = sum(counts[n] for n in names)
            if runs != len(names):
                raise AssertionError(f"mqo: {label} round {r.round_idx} ran class "
                                     f"{rep_name} {runs} times, not {len(names)}")


def mqo_phase(torch, core, mv, dp):
    """The shared-prefix workload at 512 MiB per root on the card: merged
    there, then the incremental scenario unshared and merged (the merged
    one traced), held bitwise, linted and audited. Returns the launch and
    variant counts of the two scenario runs together."""
    from repro_torch.obs import trace as tr
    from repro_torch.obs.audit import audit_scenario
    from repro_torch.obs.export import validate_chrome_trace, to_chrome_trace, \
        write_chrome_trace

    root = HERE / "build" / "chip_smoke_mqo"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    spec = mv.UpdateSpec(**dict(SCENARIO, n_rounds=MAIN_SCENARIO_ROUNDS))
    t0 = time.perf_counter()
    wl = realize_shared_prefix(mv, MAIN_BYTES_PER_ROOT, "cuda")
    calib_s = time.perf_counter() - t0
    # a scan's calibrated size is its stored bytes: int64 key and rid, three
    # f32 columns a row
    scan_bytes = {n.name: n.size for n in wl.nodes if n.op == "SCAN"}
    if set(scan_bytes.values()) != {float(N_ROWS * 28)}:
        raise AssertionError(f"mqo: scans hold {scan_bytes} B, not {N_ROWS} rows each")
    log(f"mqo: scans {scan_bytes} B ({N_ROWS} rows each), MV output "
        f"{sum(n.size for n in wl.nodes):.4e} B unshared")
    t0 = time.perf_counter()
    merged = mv.merge_workload(wl, device="cuda")
    merge_s = time.perf_counter() - t0
    if (wl.n, merged.workload.n) != MQO_NODES or merged.shared != MQO_SHARED:
        raise AssertionError(f"mqo: merge {wl.n} -> {merged.workload.n} nodes, "
                             f"shared {merged.shared}")
    log(f"mqo: calibrate in memory {calib_s:.3f}s; merge on the card {merge_s:.3f}s: {wl.n} -> "
        f"{merged.workload.n} nodes, MV output {sum(n.size for n in merged.workload.nodes):.4e} "
        f"B merged, classes {[(k, v) for k, v in merged.classes.items() if len(v) > 1]}")
    mqo_static_checks(wl, merged, spec)

    runs = {}
    for label, workload in (("unshared", wl), ("merged", merged.workload)):
        store = mv.DiskStore(root / label, device="cuda")
        torch.cuda.reset_peak_memory_stats()
        if label == "merged":
            tr.clear()
            tr.enable(True)
        dp.reset_launches()
        t0 = time.perf_counter()
        rep = mv.run_scenario(workload, store, MAIN_BUDGET, spec, core.PAPER_COST_MODEL)
        seconds = time.perf_counter() - t0
        launches, variants = dict(dp.launches), dict(dp.variant_launches)
        spans = tr.drain() if label == "merged" else []
        tr.enable(False)
        runs[label] = dict(rep=rep, store=store, seconds=seconds, launches=launches,
                           variants=variants, spans=spans,
                           peak_mem=torch.cuda.max_memory_allocated())
        names = [n.name for n in workload.nodes]
        for r in rep.rounds:
            if not r.run.peak_catalog_bytes <= MAIN_BUDGET:
                raise AssertionError(f"mqo: {label} round {r.round_idx}: peak catalog "
                                     f"{r.run.peak_catalog_bytes} exceeds {MAIN_BUDGET}")
            flagged = sorted(names[v] for v in r.plan.flagged)
            log(f"mqo: {label} round {r.round_idx} ({r.mode}) elapsed {r.elapsed:.3f}s "
                f"plan {r.plan_seconds:.3f}s read {r.run.read_seconds:.3f}s write "
                f"{r.run.write_seconds:.3f}s executed {len(r.run.executed)} catalog_hits "
                f"{r.run.catalog_hits} peak_catalog {r.run.peak_catalog_bytes:.0f} B "
                f"flagged {flagged} (v0_filter {'v0_filter' in flagged}, v0_join "
                f"{'v0_join' in flagged})")
        log(f"mqo: {label} scenario {seconds:.3f}s max_memory_allocated "
            f"{runs[label]['peak_mem']} B launches {launches} {variants}")
        check_once_per_round(label, rep, wl, merged)
    unlaunched = [k for k in ROUND_KERNELS if runs["merged"]["launches"][k] <= 0]
    if unlaunched:
        raise AssertionError(f"kernels never launched on the MQO path: {unlaunched}")
    t0 = time.perf_counter()
    mv.verify_merged_equivalence(merged, runs["merged"]["store"], runs["unshared"]["store"])
    log(f"mqo: {wl.n} views bitwise equal unshared vs merged "
        f"(verify {time.perf_counter() - t0:.3f}s); each shared class once a round; "
        f"every round within budget")

    spans = runs["merged"]["spans"]
    problems = validate_chrome_trace(to_chrome_trace(spans))
    if problems:
        raise AssertionError(f"mqo: {len(problems)} trace problems: {problems[:5]}")
    with tempfile.TemporaryDirectory() as td:
        path = write_chrome_trace(Path(td) / "mqo_trace.json", spans)
        log(f"mqo: Chrome trace valid: {len(spans)} spans, {path.stat().st_size} B")
    audit = audit_scenario(merged.workload, runs["merged"]["rep"], spans,
                           core.PAPER_COST_MODEL)
    log(f"mqo: audit (PAPER_COST_MODEL): predicted {audit.predicted_s:.6f}s realized "
        f"{audit.realized_s:.6f}s drift {audit.drift_s:+.6f}s over {len(audit.rows)} rows")
    for (name, _), agg in sorted(audit.by_mv_partition().items()):
        if name in MQO_SHARED:
            log(f"mqo: audit {name}: {json.dumps(agg)}")
    shutil.rmtree(root, ignore_errors=True)
    return tuple({k: runs["unshared"][kind][k] + runs["merged"][kind][k]
                  for k in runs["unshared"][kind]} for kind in ("launches", "variants"))


def mqo_card_vs_cpu(core, mv, root, budget):
    """The MQO merge at 4 MiB per root on the card and on the CPU: the same
    fingerprints, and the merged scenario's stores bitwise equal."""
    from repro_torch.mv import tableops as T

    out = {}
    for device in ("cuda", "cpu"):
        wl = realize_shared_prefix(mv, SMALL_BYTES_PER_ROOT, device, root)
        in_memory = realize_shared_prefix(mv, SMALL_BYTES_PER_ROOT, device)
        if [n.size for n in in_memory.nodes] != [n.size for n in wl.nodes]:
            raise AssertionError(f"calibrate_in_memory on {device} sized the MQO "
                                 "workload other than calibrate_sizes")
        merged = mv.merge_workload(wl, device=device)
        store = mv.DiskStore(root / f"mqo_{device}", device=device)
        mv.run_scenario(merged.workload, store, budget, mv.UpdateSpec(**SCENARIO),
                        core.PAPER_COST_MODEL)
        out[device] = (merged, store)
    (card_m, card), (cpu_m, cpu) = out["cuda"], out["cpu"]
    if card_m.fingerprints != cpu_m.fingerprints or card_m.classes != cpu_m.classes:
        raise AssertionError("card and CPU merges differ")
    if card.manifest() != cpu.manifest():
        raise AssertionError("card and CPU merged stores hold other entries")
    for name in card.manifest():
        T.assert_tables_bitwise(cpu.read(name), card.read(name), f"mqo cpu vs card {name}")
    log(f"cpu: 4 MiB per root MQO merge, identical fingerprints card vs CPU "
        f"(in-memory calibration equal to calibrate_sizes on both); "
        f"{len(card.manifest())} merged entries bitwise equal after the scenario")


# ---------------------------------------------------------------------------
# phase 7: multi-host partitioned refresh, forked hosts on the card
# ---------------------------------------------------------------------------

def multihost_child(args) -> int:
    """``chip_smoke.py --multihost-child JSON``: one multi-host scenario in
    this fresh interpreter, whose coordinator touches CUDA only after the
    pool has forked its hosts. The workload is realized on the card with the
    sizes the parent calibrated; prints the report as one JSON line."""
    t_start = time.perf_counter()
    sys.path.insert(0, str(HERE / "src"))
    import torch
    import repro_torch.core as core
    import repro_torch.mv as mv

    cfg = json.loads(args)
    wl = mv.realize_workload(mv.generate_workload(12, seed=4),
                             bytes_per_root=MAIN_BYTES_PER_ROOT, device="cuda")
    if len(cfg["sizes"]) != wl.n:
        raise AssertionError(f"{len(cfg['sizes'])} sizes for {wl.n} nodes")
    wl = mv.Workload(wl.name, [dataclasses.replace(n, size=float(s))
                               for n, s in zip(wl.nodes, cfg["sizes"])], dict(wl.meta))
    store = mv.DiskStore(cfg["root"], device="cuda")
    if torch.cuda.is_initialized():
        raise AssertionError("the coordinator initialised CUDA before the fork")
    fault = (mv.FaultPlan((mv.FaultAction(**cfg["fault"]),)) if cfg["fault"]
             else None)
    import_s = time.perf_counter() - t_start
    t0 = time.perf_counter()
    rep = mv.run_multihost_scenario(
        wl, N_PARTITIONS, store, [MH_HOST_BUDGET] * MH_HOSTS,
        mv.UpdateSpec(**dict(SCENARIO, n_rounds=MAIN_SCENARIO_ROUNDS)),
        core.PAPER_COST_MODEL, placement="hash", backend="process",
        fault_plan=fault, straggler=mv.StragglerConfig(speculate=False),
        round_timeout=MH_ROUND_TIMEOUT)
    print(json.dumps(dict(
        import_s=import_s, scenario_s=time.perf_counter() - t0,
        backend=rep.backend, placement=rep.placement, hosts_lost=rep.hosts_lost,
        launches=rep.launches,
        redispatches=[dataclasses.asdict(r) for r in rep.redispatches],
        rounds=[dict(round_idx=r.round_idx, mode=r.mode, elapsed=r.elapsed,
                     hosts_lost=r.hosts_lost, budgets=r.plan.host_budgets,
                     flagged=len(r.plan.flagged),
                     statuses={st: list(r.statuses.values()).count(st)
                               for st in ("static", "appended", "delta", "replaced")},
                     join_fallbacks=r.join_fallbacks,
                     hosts=[dataclasses.asdict(h) for h in r.host_stats])
                for r in rep.rounds])), flush=True)
    return 0


def card_memory_used_mib() -> int:
    """The card's used memory (MiB), every process's, as ``nvidia-smi``
    reads it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=30).stdout
    return int(out.strip().splitlines()[0])


def run_multihost_child(root, sizes, fault) -> tuple[dict, float, int]:
    """One multi-host scenario in a fresh interpreter (``--multihost-child``),
    the card's used memory polled every 0.25 s meanwhile. Returns the
    child's report, its wall seconds and the peak used memory (MiB); a
    non-zero exit raises with the child's output."""
    import threading

    cfg = json.dumps(dict(root=str(root), sizes=list(sizes), fault=fault))
    peak, done = [card_memory_used_mib()], threading.Event()

    def poll():
        while not done.wait(0.25):
            peak[0] = max(peak[0], card_memory_used_mib())

    poller = threading.Thread(target=poll, daemon=True)
    poller.start()
    t0 = time.perf_counter()
    try:
        res = subprocess.run([sys.executable, str(HERE / "chip_smoke.py"),
                              "--multihost-child", cfg], capture_output=True, text=True,
                             timeout=MH_CHILD_TIMEOUT)
    finally:
        done.set()
        poller.join()
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"multihost child (fault {fault}) exited {res.returncode}:\n"
                             f"{res.stdout[-4000:]}\n{res.stderr[-8000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1]), wall, peak[0]


def check_multihost_run(label, rep, fault):
    """The phase's checks on one run's report: the process backend, the
    hosts lost and re-dispatched, every surviving host's catalog empty at
    each round's end and within its budget at its peak, and the kernels
    the forked hosts launched."""
    if rep["backend"] != "process":
        raise AssertionError(f"multihost {label}: backend {rep['backend']}")
    want_lost = [fault["host"]] if fault else []
    if rep["hosts_lost"] != want_lost:
        raise AssertionError(f"multihost {label}: hosts lost {rep['hosts_lost']}, "
                             f"expected {want_lost}")
    sources = {r["from_host"] for r in rep["redispatches"]}
    if (fault and (not rep["redispatches"] or sources != {fault["host"]})) or (
            not fault and rep["redispatches"]):
        raise AssertionError(f"multihost {label}: re-dispatches {rep['redispatches']}")
    for r in rep["rounds"]:
        for h in r["hosts"]:
            if h["alive"] and h["used_bytes"] != 0.0:
                raise AssertionError(f"multihost {label} round {r['round_idx']} host "
                                     f"{h['host']}: {h['used_bytes']} B left in its catalog")
            if not h["peak_catalog_bytes"] <= r["budgets"][h["host"]]:
                raise AssertionError(f"multihost {label} round {r['round_idx']} host "
                                     f"{h['host']}: peak catalog {h['peak_catalog_bytes']} "
                                     f"over its budget {r['budgets'][h['host']]}")
    unlaunched = [k for k in MH_KERNELS if rep["launches"].get(k, 0) <= 0]
    if unlaunched:
        raise AssertionError(f"multihost {label}: the forked hosts never launched "
                             f"{unlaunched}: {rep['launches']}")
    if rep["launches"].get("filter_gt/scalar", 0):
        raise AssertionError(f"multihost {label}: a FILTER launch took the scalar compare")


def multihost_phase(torch, core, mv, wl=None, oracle=None, part_rounds=None):
    """The sc-incr-P8 scenario on 4 forked hosts sharing the card (0.4 GB of
    catalog each), fault-free (A) and with host 1 killed mid-round (B),
    each in a fresh interpreter; both stores held bitwise against the
    single-host P = 8 store ``oracle`` (built here when not given, as with
    ``--only multihost``) in one pass that reads each of its tables once
    (the three stores' reads of a table side by side), then removed with
    it. Returns the launches the
    forked hosts shipped over both runs."""
    from repro_torch.mv import tableops as T

    t_phase = time.perf_counter()
    root = HERE / "build" / "chip_smoke_multihost"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    spec = mv.UpdateSpec(**dict(SCENARIO, n_rounds=MAIN_SCENARIO_ROUNDS))
    if wl is None:
        wl = mv.realize_workload(mv.generate_workload(12, seed=4),
                                 bytes_per_root=MAIN_BYTES_PER_ROOT, device="cuda")
        wl = calibrate_in_memory(mv, wl)
    if oracle is None:
        oracle = mv.DiskStore(root / "oracle", device="cuda")
        rep = mv.run_partitioned_scenario(wl, N_PARTITIONS, oracle, MAIN_BUDGET, spec,
                                          core.PAPER_COST_MODEL, planner="auto")
        part_rounds = [r.elapsed for r in rep.rounds]
    pwl, _ = mv.partition_workload(wl, N_PARTITIONS)
    sizes = [n.size for n in wl.nodes]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    launches = collections.Counter()
    runs = {}
    for label, fault in (("A", None), ("B", MH_KILL)):
        base_mib = card_memory_used_mib()
        rep, wall, peak_mib = run_multihost_child(root / label, sizes, fault)
        check_multihost_run(label, rep, fault)
        runs[label] = (fault, rep, wall, base_mib, peak_mib)
    # both stores against the oracle, each of its tables read once, the
    # three stores' reads of a table side by side
    t0 = time.perf_counter()
    stores = {label: mv.DiskStore(root / label, device="cuda") for label in runs}
    with cf.ThreadPoolExecutor(1 + len(stores)) as pool:
        for node in pwl.nodes:
            want, *got = pool.map(lambda store, n=node.name: store.read(n),
                                  [oracle, *stores.values()])
            for label, table in zip(stores, got):
                T.assert_tables_bitwise(want, table, f"{label}: {node.name}")
            del want, got
    verify_s = time.perf_counter() - t0
    for label in runs:
        shutil.rmtree(root / label)
    for label, (fault, rep, wall, base_mib, peak_mib) in runs.items():
        launches.update(rep["launches"])
        walls = [r["elapsed"] for r in rep["rounds"]]
        log(f"multihost: run {label} ({'fault-free' if not fault else 'kill ' + json.dumps(fault)}): "
            f"child {wall:.3f}s (start-up to the scenario {rep['import_s']:.3f}s, scenario "
            f"{rep['scenario_s']:.3f}s); rounds {[f'{w:.3f}' for w in walls]} s vs the "
            f"single-host P={N_PARTITIONS} rounds {[f'{w:.3f}' for w in part_rounds]} s; "
            f"card memory used {base_mib} MiB before, peak {peak_mib} MiB; bitwise equal "
            f"to the single-host P={N_PARTITIONS} store (verify of A and B {verify_s:.3f}s, "
            "the oracle read once)")
        for r in rep["rounds"]:
            hosts = "; ".join(
                f"h{h['host']}{'' if h['alive'] else ' (lost)'} executed {h['executed']} "
                f"hits {h['catalog_hits']} peak {h['peak_catalog_bytes']:.0f} B"
                for h in r["hosts"])
            log(f"multihost: run {label} round {r['round_idx']} ({r['mode']}) "
                f"{r['elapsed']:.3f}s flagged {r['flagged']} statuses {r['statuses']} "
                f"join_fallbacks {r['join_fallbacks']} hosts lost {r['hosts_lost']}: {hosts}")
        log(f"multihost: run {label} re-dispatches {len(rep['redispatches'])} "
            f"{sorted({(d['from_host'], d['to_host'], d['reason']) for d in rep['redispatches']})}; "
            f"launches in the forked hosts {rep['launches']}")
    shutil.rmtree(root, ignore_errors=True)
    log(f"multihost: {MH_HOSTS} forked hosts on one card, P={N_PARTITIONS}, "
        f"{MH_HOST_BUDGET:.3e} B of catalog each: both runs bitwise equal to the "
        f"single-host store; phase {time.perf_counter() - t_phase:.1f}s")
    return dict(launches)


def load_sc_lint():
    """``tools/sc_lint_torch.py`` as a module (the tools directory is no
    package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "sc_lint_torch", HERE / "tools" / "sc_lint_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def lint_phase(dev) -> None:
    """``sc_lint_torch``'s passes on the card, then what its ptx and fixtures
    passes read: every kernel of ``determinism.DATAPLANE_KERNELS`` linted
    from fresh PTX with no ``lint-skipped`` finding, the two MAP fixtures
    compiled fresh firing as their committed PTX does (the legacy map both
    rules, the shipped map nothing), and no gating finding outside the
    baseline. A missing ``nvcc`` or a failed compile raises."""
    from repro_torch.analysis import (
        determinism, fixtures, format_findings, load_baseline, new_findings)

    sc_lint = load_sc_lint()
    log(f"lint: {sc_lint.describe(dev)}; fixture PTX committed from {fixtures.PTX_NVCC}")
    t0 = time.perf_counter()
    record = {}
    findings, counts = sc_lint.collect(dev, verbose=False, record=record)
    log(f"lint: findings per pass {counts} in {time.perf_counter() - t0:.1f}s")
    skipped = [f for f in findings if f.rule == "lint-skipped"]
    if skipped:
        raise AssertionError("lint-skipped on the card:\n" + format_findings(skipped))
    per_kernel = record["ptx"]
    missing = [k for k in determinism.DATAPLANE_KERNELS if k not in per_kernel]
    if missing:
        raise AssertionError(f"data-plane kernels without a PTX entry: {missing}")
    for kernel, (entries, instructions) in per_kernel.items():
        log(f"lint: ptx {kernel}: {entries} instantiation(s), {instructions} "
            "PTX instructions read")
    rules = record["fixtures"]
    log(f"lint: MAP fixtures' rules {rules}")
    if "fresh" not in rules:
        raise AssertionError("the MAP fixtures were not compiled fresh")
    if not {"transcendental-kernel", "fma-contraction"} <= set(rules["fresh"]["legacy_fused_map"]):
        raise AssertionError(f"the fresh legacy map fires {rules['fresh']['legacy_fused_map']}")
    if rules["fresh"]["shipped_map"]:
        raise AssertionError(f"the fresh shipped map fires {rules['fresh']['shipped_map']}")
    if rules["fresh"] != rules["committed"]:
        raise AssertionError("the fresh MAP fixtures' rules differ from the committed PTX's")
    new = new_findings(findings, load_baseline(sc_lint.BASELINE))
    if new:
        raise AssertionError("gating findings outside the baseline:\n" + format_findings(new))
    log(f"lint: {len(findings)} finding(s), none gating outside the baseline; every "
        f"data-plane kernel linted from fresh PTX")


def examples_phase() -> None:
    """Each of ``EXAMPLES`` with ``SC_SMOKE=1`` on the card, each in its own
    interpreter with its own time limit, all eight started together (one
    working directory, a temporary one; output to files there). A non-zero
    exit or a timeout fails the phase and stops the others. Logs each
    example's seconds (start to exit, beside the six others) and its
    launches (its last line)."""
    env = dict(os.environ, SC_SMOKE="1", PYTHONPATH=str(HERE / "src"))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_examples_") as tmp:
        cwd = Path(tmp)
        procs, seconds = {}, {}
        t0 = time.perf_counter()
        try:
            for name in EXAMPLES:
                with open(cwd / f"{name}.out", "w") as out, \
                        open(cwd / f"{name}.err", "w") as err:
                    procs[name] = subprocess.Popen(
                        [sys.executable, str(HERE / "examples" / f"{name}_torch.py")],
                        cwd=cwd, env=env, stdout=out, stderr=err)
            while len(seconds) < len(procs):
                for name, proc in procs.items():
                    if name not in seconds and proc.poll() is not None:
                        seconds[name] = time.perf_counter() - t0
                        if proc.returncode != 0:
                            raise AssertionError(
                                f"example {name}_torch.py exit {proc.returncode} after "
                                f"{seconds[name]:.1f}s:\n"
                                f"{(cwd / f'{name}.out').read_text()[-3000:]}\n"
                                f"{(cwd / f'{name}.err').read_text()[-3000:]}")
                if time.perf_counter() - t0 > EXAMPLE_TIMEOUT:
                    late = [n for n in procs if n not in seconds]
                    raise AssertionError(f"examples {late} ran past {EXAMPLE_TIMEOUT:.0f}s")
                time.sleep(0.1)
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        mv_launches = collections.Counter()
        for name in EXAMPLES:
            last = (cwd / f"{name}.out").read_text().strip().splitlines()[-1]
            launches = {k: v for k, v in json.loads(last.removeprefix("launches ")).items()
                        if v}
            log(f"example {name}: {seconds[name]:.1f}s, launches {launches}")
            if name in MODEL_EXAMPLE_KERNELS:
                unlaunched = [k for k in MODEL_EXAMPLE_KERNELS[name] if not launches.get(k)]
                if unlaunched:
                    raise AssertionError(f"{name} never launched {unlaunched}")
            else:
                mv_launches.update(launches)
    unlaunched = [k for k in (*ROUND_KERNELS, "pid_hist") if not mv_launches[k]]
    if unlaunched:
        raise AssertionError(f"the MV examples never launched {unlaunched}")
    log(f"examples: the six MV examples' data-plane launches {dict(mv_launches)}")


def check_finite(torch, name, table):
    for col, v in table.items():
        if v.dtype.is_floating_point and not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{name}.{col} holds non-finite values")


# ---------------------------------------------------------------------------
# phase 15: sharded train and serve steps on a 2 x 2 mesh of ranks on the card
# ---------------------------------------------------------------------------

def shard_cfgs():
    """The small and the full-width qwen2-moe configurations of the shard
    phase."""
    from repro_torch import configs

    small = configs.get_config(MOE_ARCH).reduced(**SHARD_SMALL)
    full = dataclasses.replace(configs.get_config(MOE_ARCH), n_layers=SHARD_FULL_LAYERS)
    return small, full


def shard_ssm_cfgs():
    """The small Mamba-2 and hybrid configurations and full-width
    mamba2-2.7b at ``SHARD_MAMBA_LAYERS`` layers."""
    from repro_torch import configs

    small = [configs.get_config(arch).reduced(**over) for arch, over in SHARD_SSM_SMALL]
    full = dataclasses.replace(configs.get_config(MAMBA_ARCH), n_layers=SHARD_MAMBA_LAYERS)
    return small, full


def shard_batch(np, vocab, rows, seq, seed):
    """A train batch of ``rows`` rows of ``seq`` positions made from a seed
    (numpy), ids below ``vocab``."""
    seqs = np.random.default_rng(seed).integers(0, vocab, (rows, seq + 1))
    return {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}


def shard_child(args) -> int:
    """``chip_smoke.py --shard-child JSON``: the shard phase's unsharded
    twin (``role: twin``) or one rank of its mesh (``role: rank``), in this
    fresh interpreter; prints its report as the last line."""
    sys.path.insert(0, str(HERE / "src"))
    cfg = json.loads(args)
    root = Path(cfg["root"])
    if cfg["role"] == "twin":
        report = shard_twin(root)
    else:
        report = shard_rank(root, cfg["rank"])
    print(json.dumps(report), flush=True)
    return 0


def twin_small(torch, models, cfg, batch, gen, dev, ckpt=None) -> dict:
    """The twin's run of a small f32 model (its weights from ``gen()``): a
    train step (dp over the mesh's data axis, ``SHARD_SMALL_ROWS`` global
    rows), its loss, learning rate, parameters and moments (CPU); with
    ``ckpt`` that state written there by ``CheckpointManager``; then, on
    the weights drawn again, a prefill of rows 0-3 and decode steps
    (``serve``) and, with ``ckpt``, ``SHARD_SSM_SMALL_NEW`` greedy tokens
    from the prefill's prompt (``greedy``)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.serve import greedy_generate
    from repro_torch.train import AdamWConfig, init_train_state, make_train_step

    model = models.init_params(cfg, gen(), dev)
    state = init_train_state(cfg, model)
    state, met = make_train_step(cfg, AdamWConfig(**SMALL_TRAIN_OPT), dp=SHARD_MESH[0],
                                 global_rows=SHARD_SMALL_ROWS)(state, batch)
    params = {k: p.detach() for k, p in model.named_parameters()}
    out = {"loss": float(met["loss"]), "lr": float(met["lr"]),
           "params": {k: p.cpu() for k, p in params.items()},
           "m": {k: t.cpu() for k, t in state["opt"]["m"].items()},
           "v": {k: t.cpu() for k, t in state["opt"]["v"].items()}}
    if ckpt is not None:
        CheckpointManager(ckpt).save({"params": params, "opt": state["opt"]}, 1, blocking=True)
    with torch.inference_mode():
        model = models.init_params(cfg, gen(), dev)
        tok = batch["tokens"][:4]
        cache = models.make_cache(cfg, 4, SHARD_SMALL_SEQ, dev)
        last, cache = models.prefill(cfg, model, tok[:, :SHARD_SMALL_PROMPT], cache)
        steps = [last]
        for pos in range(SHARD_SMALL_PROMPT, SHARD_SMALL_SEQ):
            lg, cache = models.decode_step(cfg, model, tok[:, pos], cache, pos)
            steps.append(lg)
        out["serve"] = torch.stack(steps, 1).cpu()
        if ckpt is not None:
            out["greedy"] = greedy_generate(cfg, model, tok[:, :SHARD_SMALL_PROMPT],
                                            SHARD_SSM_SMALL_NEW, dev).cpu()
    return out


def twin_full_train(torch, np, models, cfg, checked, gen, dev, path: Path):
    """The twin's full-width train step (one step of ``SHARD_TRAIN_ROWS`` x
    ``SHARD_TRAIN_SEQ`` tokens at ``SHARD_FULL_OPT``): ``(report, train)``,
    its wall, peak and loss, and its gradient norm with ``checked``'s
    first-moment and update norms; ``checked``'s updated parameters saved
    to ``path``."""
    from repro_torch.train import AdamWConfig, init_train_state, make_train_step

    torch.cuda.reset_peak_memory_stats()
    model = models.init_params(cfg, gen(), dev)
    state = init_train_state(cfg, model)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             shard_batch(np, cfg.vocab_size, SHARD_TRAIN_ROWS, SHARD_TRAIN_SEQ, 2).items()}
    step = make_train_step(cfg, AdamWConfig(**SHARD_FULL_OPT), dp=SHARD_MESH[0],
                           global_rows=SHARD_TRAIN_ROWS)
    params = dict(model.named_parameters())
    before = {k: params[k].detach().clone() for k in checked}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, met = step(state, batch)
    loss = float(met["loss"])
    report = {"train_s": time.perf_counter() - t0, "loss": loss,
              "train_peak": torch.cuda.max_memory_allocated()}
    train = {"grad_norm": float(met["grad_norm"]),
             "m_norm": {k: float(torch.linalg.vector_norm(state["opt"]["m"][k]))
                        for k in checked},
             "update_norm": {k: float(torch.linalg.vector_norm(
                 params[k].detach().float() - before[k].float())) for k in checked}}
    save_atomic(torch, {k: params[k].detach().cpu() for k in checked}, path)
    del model, state, step, params, before
    torch.cuda.empty_cache()
    return report, train


def twin_serve_prompt(torch, np, cfg, dev):
    """The full-width serving prompt (``SHARD_SERVE_BATCH`` x
    ``SHARD_SERVE_PROMPT`` ids below the vocabulary, seed 3)."""
    return torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (SHARD_SERVE_BATCH, SHARD_SERVE_PROMPT))).to(dev)


def shard_twin(root: Path) -> dict:
    """The port's unsharded runs the ranks are held against, on the card,
    saved under ``root`` in the order the ranks read them: the small
    qwen2-moe model's train step and its prefill and decode steps
    (``twin_small.pt``); the small Mamba-2 and hybrid models' the same,
    their greedy tokens and their train states as checkpoints
    (``twin_ssm_small.pt``, ``ckpt_<name>/``); full-width mamba2-2.7b's
    train step and its prefill and 16 greedy decode steps
    (``twin_mamba.pt``; ``SHARD_MAMBA_CHECKED``'s updated parameters in
    ``twin_train_mamba.pt``); the full-width qwen2-moe model's train step
    and its prefill and 16 greedy decode steps with their routing
    (``twin_full.pt``; ``SHARD_CHECKED``'s updated parameters in
    ``twin_train.pt``)."""
    import numpy as np
    import torch

    from repro_torch import models
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    small, full = shard_cfgs()
    ssm_small, mamba = shard_ssm_cfgs()
    report = {}

    def gen():
        return torch.Generator(device=dev).manual_seed(SHARD_SEED)

    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             shard_batch(np, small.vocab_size, SHARD_SMALL_ROWS, SHARD_SMALL_SEQ, 1).items()}
    # -- the small models (f32, drop-free): a train step, then a prefill and decode
    save_atomic(torch, twin_small(torch, models, small, batch, gen, dev),
                root / "twin_small.pt")
    save_atomic(torch, {cfg.name: twin_small(torch, models, cfg, batch, gen, dev,
                                             ckpt=root / f"ckpt_{cfg.name}")
                        for cfg in ssm_small}, root / "twin_ssm_small.pt")

    # -- full-width mamba2-2.7b: a train step, then a prefill and greedy decode steps
    ops.reset_launches()
    rep, train = twin_full_train(torch, np, models, mamba, SHARD_MAMBA_CHECKED, gen, dev,
                                 root / "twin_train_mamba.pt")
    with torch.inference_mode():
        model = models.init_params(mamba, gen(), dev)
        prompt = twin_serve_prompt(torch, np, mamba, dev)
        torch.cuda.synchronize()
        free = shard_serve(torch, models, mamba, model, prompt, None, dev)
    rep.update(prefill_s=free["walls"][0], decode_ms=[w * 1e3 for w in free["walls"][1:]],
               train=train, launches={**ops.launches, **ops.variant_launches},
               peak=torch.cuda.max_memory_allocated())
    report["mamba"] = rep
    del model
    torch.cuda.empty_cache()
    save_atomic(torch, {"loss": rep["loss"], "train": train, "prompt": prompt.cpu(),
                        "fed": free["fed"].cpu(), "logits": free["logits"]},
                root / "twin_mamba.pt")

    # -- full width qwen2-moe: a train step, then a prefill and greedy decode steps
    ops.reset_launches()
    rep, train = twin_full_train(torch, np, models, full, SHARD_CHECKED, gen, dev,
                                 root / "twin_train.pt")
    report.update(rep)
    with torch.inference_mode():
        model = models.init_params(full, gen(), dev)
        prompt = twin_serve_prompt(torch, np, full, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        free = shard_serve(torch, models, full, model, prompt, None, dev)
        torch.cuda.synchronize()
        report["serve_s"] = time.perf_counter() - t0
        report["prefill_s"] = free["walls"][0]
        report["decode_ms"] = [w * 1e3 for w in free["walls"][1:]]
        fed = free["fed"]
        # the same calls layer by layer, each sub-layer's input and output kept
        record = shard_serve(torch, models, full, model, prompt, fed, dev, record=[])
        if not torch.equal(record["logits"], free["logits"]):
            raise AssertionError("shard: the layer-by-layer replay gives other logits than "
                                 "prefill and decode_step")
    report.update(train=train, dropped=free["dropped"], routed=free["routed"],
                  launches={**ops.launches, **ops.variant_launches},
                  peak=torch.cuda.max_memory_allocated())
    # the card's memory back before the ranks, which wait for this file, lay
    # the full-width model out
    del model
    torch.cuda.empty_cache()
    save_atomic(torch, {"loss": report["loss"], "train": train, "prompt": prompt.cpu(),
                        "fed": fed.cpu(), "logits": free["logits"], "routing": free["routing"],
                        "dropped": free["dropped"], "routed": free["routed"],
                        "record": record["record"], "record_routing": record["routing"]},
                root / "twin_full.pt")
    return report


def save_atomic(torch, obj, path: Path) -> None:
    """``torch.save`` under a temporary name, then a rename: a rank that
    waits for the file (:func:`wait_for`) never reads it half written."""
    torch.save(obj, path.with_suffix(".tmp"))
    os.replace(path.with_suffix(".tmp"), path)


def wait_for(torch, path: Path):
    """``torch.load(path)`` once the twin has written it (at most
    ``SHARD_TIMEOUT`` seconds)."""
    deadline = time.monotonic() + SHARD_TIMEOUT
    while not path.exists():
        if time.monotonic() > deadline:
            raise AssertionError(f"shard: {path.name} not written in {SHARD_TIMEOUT} s")
        time.sleep(0.1)
    return torch.load(path)


def shard_serve(torch, models, cfg, model, prompt, fed, dev, record=None, feed=None,
                gather=None) -> dict:
    """A prefill of ``prompt`` and ``SHARD_SERVE_NEW`` decode steps, each
    fed ``fed[i]`` (or, without ``fed``, the greedy token of the step
    before). Without ``record`` the calls are ``models.prefill`` and
    ``models.decode_step``; with it (a list) they run ``forward``'s cache
    path layer by layer (``transformer._mixer_out`` and ``_ffn_out``, the
    same ops), each call appending one dict a layer of its sub-layers'
    inputs and outputs (CPU copies), and with ``feed`` (a twin's record,
    this rank's rows) each sub-layer and the head take the twin's input
    instead of the one the call computed. ``gather`` makes a rank's logits
    and records whole. Returns the logits (f32, on the CPU), the tokens
    fed, the MoE routing and drop counts, and each call's wall seconds
    (the card synchronised; a rank's gather of its logits outside)."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T

    whole = gather or (lambda t, rows_only=False: t)
    cache = models.make_cache(cfg, SHARD_SERVE_BATCH, SHARD_SERVE_PROMPT + SHARD_SERVE_NEW, dev)
    stats = {"routing": []}

    def call(tokens, pos, n):
        if record is None:
            if pos == 0:
                return models.prefill(cfg, model, tokens, cache, moe_stats=stats)[0]
            return models.decode_step(cfg, model, tokens, cache, pos, moe_stats=stats)[0]
        x = T.embed_inputs(cfg, model, tokens if pos == 0 else tokens[:, None])
        positions = torch.arange(pos, pos + x.shape[1], device=dev)
        for i, layer in enumerate(model.layers):
            src = feed[n][i] if feed is not None else None
            xin = x if src is None else src["x"].to(dev)
            y = T._mixer_out(cfg, layer, xin, positions, cache[i], pos)
            mid = xin + y if src is None else src["mid"].to(dev)
            f, _ = T._ffn_out(cfg, layer, mid, stats)
            x = mid + f
            record_n.append({"x": whole(xin, True).cpu(), "y": whole(y, True).cpu(),
                             "mid": whole(mid, True).cpu(), "f": whole(f, True).cpu()})
        if feed is not None:
            x = feed[n][-1]["out"].to(dev)
        record_n[-1]["out"] = whole(x, True).cpu()
        logits = T._head(cfg, model, ops.rmsnorm(x, model.final_norm, eps=cfg.norm_eps))
        return logits[:, -1]

    def timed(tokens, pos, n):
        t0 = time.perf_counter()
        out = call(tokens, pos, n)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        return whole(out).float().cpu()

    logits, toks, walls = [], [], []
    record_n = []
    logits.append(timed(prompt, 0, 0))
    for i in range(SHARD_SERVE_NEW):
        if record is not None:
            record.append(record_n)
            record_n = []
        nxt = (fed[i] if fed is not None
               else torch.argmax(logits[-1][:, :cfg.vocab_size], dim=-1)).to(dev)
        toks.append(nxt)
        logits.append(timed(nxt, SHARD_SERVE_PROMPT + i, i + 1))
    if record is not None:
        record.append(record_n)
    return {"logits": torch.stack(logits), "fed": torch.stack(toks), "record": record,
            "routing": stats["routing"], "dropped": stats.get("dropped", 0),
            "routed": stats.get("routed", 0), "walls": walls}


def rel_norm(torch, got, want, keep=None) -> float:
    """||got - want|| / ||want|| in f64 (over ``keep``'s elements where given)."""
    g, w = got.double(), want.double()
    if keep is not None:
        g, w = g[keep], w[keep]
    return float(torch.linalg.vector_norm(g - w) / max(torch.linalg.vector_norm(w), 1e-30))


def shard_state_errors(torch, whole, twin, lr, b1, wd) -> dict:
    """The small run's gathered state against the twin's: the worst
    ||got - want|| / ||want|| of a tensor's parameters, m and v. A
    parameter's elements whose step-1 gradient (m / (1 - b1)) lies under
    ``SHARD_NEAR_ZERO`` of its tensor's largest are left out of its norm
    (Adam's normalised step there follows the gradient's last bits, as in
    the CPU tests) and held to move at most two steps apart."""
    worst = {"params": 0.0, "m": 0.0, "v": 0.0}
    for k, want in twin["params"].items():
        got = whole["params"][k].cpu()
        g = twin["m"][k].abs() / (1 - b1)
        free = g <= SHARD_NEAR_ZERO * g.max()
        if bool(free.any()):
            apart = float((got[free].double() - want[free].double()).abs().max())
            if apart > 2 * lr * (1 + wd):
                raise AssertionError(f"shard: {k}: an ill-conditioned element {apart} apart")
        worst["params"] = max(worst["params"], rel_norm(torch, got, want, ~free))
        for key in ("m", "v"):
            worst[key] = max(worst[key], rel_norm(torch, whole[key][k].cpu(), twin[key][k]))
    return worst


def shard_train_errors(torch, cfg, checked, params, start, state, met, twin, twin_params,
                       mesh) -> dict:
    """The full-width sharded train step against the twin's: the
    gradients' global norm, relative; for each of ``checked`` its
    first moment's norm, relative (after one step m = 0.1 g), and its
    updated parameter element by element, ||got - want|| / ||want -
    before|| (``update``), each rank comparing its shard of the twin's
    tensor. Sums of squares are summed over every rank: a tensor
    replicated over an axis counts each element as often in every sum,
    which leaves the ratios as they are and is divided out of a norm."""
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding import layout, strategy

    world = tuple(mesh.axis_names)

    def total(x):   # a sum over every rank, in f64 on the host
        return float(C.all_reduce(x.double().reshape(1).cpu(), world, mesh=mesh))

    ospecs = strategy.opt_state_specs(cfg, {k: params[k] for k in checked}, mesh)
    out = {"grad_norm": abs(float(met["grad_norm"]) - twin["grad_norm"]) / twin["grad_norm"],
           "m_norm": {}, "update": {}}
    for k in checked:
        held = mesh.axis_size(tuple(a for e in ospecs[k] for a in strategy.axes_of(e)))
        m = state["opt"]["m"][k].float()
        norm = math.sqrt(total(torch.sum(m * m)) * held / mesh.axis_size(world))
        out["m_norm"][k] = abs(norm - twin["m_norm"][k]) / twin["m_norm"][k]
        spec = strategy.param_spec(cfg, k, params[k].dim(), mesh)
        want = layout.shard_tensor(twin_params[k], spec, mesh, fused_last=layout.is_fused(k))
        want = want.to(params[k].device).float()
        got, was = params[k].detach().float(), start[k].float()
        out["update"][k] = math.sqrt(total(torch.sum((got - want) ** 2))
                                     / max(total(torch.sum((want - was) ** 2)), 1e-300))
    return out


def routing_match(torch, got, want, strict: bool = True) -> dict:
    """The MoE calls' routing of one run against another's: tokens whose
    top-k set differs, and the (token, expert) pairs kept, compared as
    token x expert matrices. With ``strict``, calls whose top-k sets agree
    on every token must keep exactly the same pairs."""
    swapped = tokens = calls_same = 0
    by_call = {}
    for n, ((topi, kept), (wtopi, wkept)) in enumerate(zip(got, want)):
        same = (topi.sort(-1).values == wtopi.sort(-1).values).all(-1)
        swapped += int((~same).sum())
        if not bool(same.all()):
            by_call[n] = int((~same).sum())
        tokens += same.numel()
        e = int(max(topi.max(), wtopi.max())) + 1
        rows = torch.arange(topi.shape[0])[:, None].expand_as(topi)
        mat = torch.zeros(topi.shape[0], e, dtype=torch.bool)
        wmat = torch.zeros_like(mat)
        mat[rows[kept], topi[kept]] = True
        wmat[rows[wkept], wtopi[wkept]] = True
        if bool(same.all()):
            calls_same += 1
            if strict and not torch.equal(mat, wmat):
                raise AssertionError(f"shard: MoE call {n} routes as the twin but keeps "
                                     f"{int((mat != wmat).sum())} other pairs")
    if len(got) != len(want):
        raise AssertionError(f"shard: {len(got)} MoE calls, the twin {len(want)}")
    return {"calls": len(got), "calls_same_routing": calls_same, "tokens": tokens,
            "tokens_other_topk": swapped, "other_topk_by_call": by_call}


def collective_delta(after: dict, before: dict) -> dict:
    """Collective counts (``collectives.counts()``) between two readings."""
    out = {}
    for k, v in after.items():
        if k == "tags":
            out[k] = {t: {n: c[n] - before[k].get(t, {}).get(n, 0) for n in c}
                      for t, c in v.items()}
        elif isinstance(v, dict):
            out[k] = {kind: v[kind] - before[k][kind] for kind in v}
        else:
            out[k] = v - before[k]
    return out


def rank_small(torch, models, cfg, twin, batch, tok, gen, mesh, dev, ckpt=None) -> dict:
    """One small f32 case on this rank against the twin's
    (:func:`twin_small`): a train step's loss, and its gathered parameters
    and moments (:func:`shard_state_errors`); the prefill and decode
    steps' gathered logits (``logits``). With ``ckpt`` (the twin's state
    written there), also ``greedy_generate`` on the mesh from the twin's
    global prompt (``greedy_same``: the twin's tokens exactly) and
    ``elastic_restore`` of that checkpoint onto this rank's parameter
    shards and ZeRO-1 moment parts (``restore_bitwise``: each bitwise the
    whole tensor's cut by ``shard_tensor``, ``zero_slice``; the step)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.runtime import elastic_restore
    from repro_torch.serve import greedy_generate
    from repro_torch.sharding import layout, strategy
    from repro_torch.train import AdamWConfig, init_train_state, make_train_step
    from repro_torch.train.step import train_state_specs

    opt = AdamWConfig(**SMALL_TRAIN_OPT)
    model = layout.init_sharded_params(cfg, gen(), mesh, dev)
    state = init_train_state(cfg, model)
    state, met = make_train_step(cfg, opt, dp=SHARD_MESH[0],
                                 global_rows=SHARD_SMALL_ROWS)(state, batch)
    whole = layout.gather_train_state(cfg, state, mesh)
    err = {"loss": abs(float(met["loss"]) - twin["loss"]) / abs(twin["loss"])}
    err.update(shard_state_errors(torch, whole, twin, twin["lr"], opt.b1, opt.weight_decay))
    checks = {}
    if ckpt is not None:
        named = {k: p.detach() for k, p in model.named_parameters()}
        specs = train_state_specs(cfg, named, mesh)
        pspec, ospec = specs["params"], specs["opt"]["m"]
        flat = CheckpointManager(ckpt).restore_flat()
        got = elastic_restore(flat, {"params": named, "opt": state["opt"]},
                              layout.named_shardings(specs, mesh))
        same = torch.equal(got["opt"]["step"].cpu(), flat["opt/step"])
        for k in named:
            def cut(t):
                return layout.shard_tensor(t, pspec[k], mesh, fused_last=layout.is_fused(k))
            same &= torch.equal(got["params"][k].cpu(), cut(flat[f"params/{k}"]))
            for key in ("m", "v"):
                same &= torch.equal(got["opt"][key][k].cpu(), layout.zero_slice(
                    cut(flat[f"opt/{key}/{k}"]), pspec[k], ospec[k], mesh))
        checks["restore_bitwise"] = bool(same)
    with torch.inference_mode():
        model = layout.init_sharded_params(cfg, gen(), mesh, dev)
        cache = models.make_cache(cfg, 4, SHARD_SMALL_SEQ, dev)
        local = layout.shard_tensor(tok, strategy.P(strategy.dp_axes(mesh), None), mesh)
        last, cache = models.prefill(cfg, model, local[:, :SHARD_SMALL_PROMPT], cache)
        steps = [shard_logits(last, mesh)]
        for pos in range(SHARD_SMALL_PROMPT, SHARD_SMALL_SEQ):
            lg, cache = models.decode_step(cfg, model, local[:, pos], cache, pos)
            steps.append(shard_logits(lg, mesh))
        err["logits"] = rel_norm(torch, torch.stack(steps, 1).cpu(), twin["serve"])
        if ckpt is not None:
            tokens = greedy_generate(cfg, model, tok[:, :SHARD_SMALL_PROMPT],
                                     SHARD_SSM_SMALL_NEW, dev)
            checks["greedy_same"] = torch.equal(tokens.cpu(), twin["greedy"])
    return err, checks


def shard_logits(logits, mesh):
    """Whole logits (f32) from each rank's rows and vocabulary columns."""
    from repro_torch.sharding import layout, strategy

    return layout.gather_tensor(logits.float(), strategy.P(strategy.dp_axes(mesh), "model"),
                                mesh)


def rank_full_train(torch, np, cfg, checked, twin, twin_train, gen, mesh, dev) -> dict:
    """One full-width FSDP train step on this rank against the twin's
    (:func:`twin_full_train`): its wall, collectives, loss and
    :func:`shard_train_errors`, peak and local parameter count."""
    import torch.distributed as dist

    from repro_torch.sharding import collectives as C
    from repro_torch.sharding import layout, strategy
    from repro_torch.train import AdamWConfig, init_train_state, make_train_step

    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(cfg, fsdp_params=True)
    model = layout.init_sharded_params(cfg, gen(), mesh, dev)
    state = init_train_state(cfg, model)
    rows = strategy.P(strategy.dp_axes(mesh), None)
    batch = {k: layout.shard_tensor(torch.from_numpy(v).to(dev), rows, mesh) for k, v in
             shard_batch(np, cfg.vocab_size, SHARD_TRAIN_ROWS, SHARD_TRAIN_SEQ, 2).items()}
    step = make_train_step(cfg, AdamWConfig(**SHARD_FULL_OPT), dp=SHARD_MESH[0],
                           global_rows=SHARD_TRAIN_ROWS)
    params = dict(model.named_parameters())
    start = {k: params[k].detach().clone() for k in checked}
    before = C.counts()
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    state, met = step(state, batch)
    loss = float(met["loss"])
    rep = {"train_s": time.perf_counter() - t0,
           "train_collectives": collective_delta(C.counts(), before),
           "loss": loss, "twin_loss": twin["loss"],
           "loss_rel": abs(loss - twin["loss"]) / abs(twin["loss"])}
    rep["train"] = shard_train_errors(torch, cfg, checked, params, start, state, met,
                                      twin["train"], torch.load(twin_train, mmap=True), mesh)
    rep["train_peak"] = torch.cuda.max_memory_allocated()
    rep["local_params"] = sum(p.numel() for p in model.parameters())
    del model, state, step, batch, params, start
    torch.cuda.empty_cache()
    return rep


def shard_rank(root: Path, rank: int) -> dict:
    """One rank of the 2 x 2 mesh (gloo, every rank on ``cuda:0``): the
    small qwen2-moe model under each of ``SHARD_SMALL_CASES`` and the small
    Mamba-2 and hybrid models under FSDP off and on (a train step, a
    prefill and decode steps; for the latter also greedy generation and an
    elastic restore); then the full-width qwen2-moe model (a train step
    with FSDP, then a prefill and 16 decode steps fed the twin's tokens,
    and the same calls sub-layer by sub-layer on the twin's inputs) and
    full-width mamba2-2.7b (a train step with FSDP, a prefill and 16
    decode steps fed the twin's tokens, greedy generation on the mesh),
    each held against the twin's results by rank 0 (the greedy tokens and
    restores by every rank); returns the rank's launches, collective
    counts, walls and peak memory."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.serve import greedy_generate
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding import layout, strategy
    from repro_torch.sharding.context import mesh_context
    from repro_torch import models

    dev = torch.device("cuda")
    torch.cuda.set_device(0)
    store = dist.FileStore(str(root / "store"), SHARD_WORLD)
    dist.init_process_group(C.backend_for(dev, ranks_per_card=SHARD_WORLD), store=store,
                            rank=rank, world_size=SHARD_WORLD)
    mesh = make_local_mesh(*SHARD_MESH)
    small, full = shard_cfgs()
    ssm_small, mamba = shard_ssm_cfgs()
    dpx = strategy.dp_axes(mesh)
    report = {"rank": rank, "backend": dist.get_backend(), "coords": mesh.coords()}

    def gen():
        return torch.Generator(device=dev).manual_seed(SHARD_SEED)

    rows = slice(mesh.axis_index(dpx) * SHARD_SERVE_BATCH // SHARD_MESH[0],
                 (mesh.axis_index(dpx) + 1) * SHARD_SERVE_BATCH // SHARD_MESH[0])

    def whole(t, rows_only=False):
        spec = strategy.P(dpx, *([None] * (t.dim() - 1))) if rows_only else \
            strategy.P(dpx, "model")
        return layout.gather_tensor(t, spec, mesh)

    ops.reset_launches()
    C.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    with mesh_context(mesh):
        # -- the small models, f32, drop-free
        whole_batch = shard_batch(np, small.vocab_size, SHARD_SMALL_ROWS, SHARD_SMALL_SEQ, 1)
        batch = {k: layout.shard_tensor(torch.from_numpy(v).to(dev), strategy.P(dpx, None),
                                        mesh) for k, v in whole_batch.items()}
        tok = torch.from_numpy(whole_batch["tokens"][:4]).to(dev)   # the twin serves rows 0-3
        twin = wait_for(torch, root / "twin_small.pt")
        report["small"], bad = {}, []
        for fsdp, impl in SHARD_SMALL_CASES:
            cfg = dataclasses.replace(small, fsdp_params=fsdp, moe_impl=impl)
            err, _ = rank_small(torch, models, cfg, twin, batch, tok, gen, mesh, dev)
            report["small"][f"fsdp={fsdp},{impl}"] = err
        twin = wait_for(torch, root / "twin_ssm_small.pt")
        for base in ssm_small:
            for fsdp in (False, True):
                cfg = dataclasses.replace(base, fsdp_params=fsdp)
                err, checks = rank_small(torch, models, cfg, twin[base.name], batch, tok, gen,
                                         mesh, dev, ckpt=root / f"ckpt_{base.name}")
                report["small"][f"{base.name},fsdp={fsdp}"] = dict(err, **checks)
                bad += [f"{base.name} fsdp={fsdp} {k}" for k, ok in checks.items() if not ok]
        if bad:   # every rank holds these
            raise AssertionError(f"shard: rank {rank}: {bad}")
        if rank == 0:
            over = {k: e for k, e in report["small"].items()
                    if max(v for v in e.values() if not isinstance(v, bool)) > SHARD_SMALL_TOL}
            if over:
                raise AssertionError(f"shard: small {over} over {SHARD_SMALL_TOL}")
        del twin

        # -- full width, bf16: one FSDP train step
        twin = wait_for(torch, root / "twin_full.pt")
        report.update(rank_full_train(torch, np, full, SHARD_CHECKED, twin,
                                      root / "twin_train.pt", gen, mesh, dev))

        # -- full width: prefill and decode on the TP x DP layout, fed the twin's tokens
        cfg = dataclasses.replace(full, fsdp_params=False)
        with torch.inference_mode():
            model = layout.init_sharded_params(cfg, gen(), mesh, dev)
            prompt, fed = twin["prompt"][rows].to(dev), twin["fed"][:, rows].to(dev)
            before = C.counts()
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            free = shard_serve(torch, models, cfg, model, prompt, fed, dev, gather=whole)
            torch.cuda.synchronize()
            report["serve_s"] = time.perf_counter() - t0
            report["prefill_s"] = free["walls"][0]
            report["decode_ms"] = [w * 1e3 for w in free["walls"][1:]]
            report["serve_collectives"] = collective_delta(C.counts(), before)
            # each sub-layer and the head on the twin's own inputs
            feed = [[{k: t[rows] for k, t in sub.items()} for sub in call]
                    for call in twin["record"]]
            forced = shard_serve(torch, models, cfg, model, prompt, fed, dev, record=[],
                                 feed=feed, gather=whole)
        report["prefill_rel"] = rel_norm(torch, free["logits"][0], twin["logits"][0])
        report["decode_rel"] = rel_norm(torch, free["logits"][1:], twin["logits"][1:])
        report["dropped"], report["twin_dropped"] = free["dropped"], twin["dropped"]
        report["routing"] = routing_match(torch, free["routing"], twin["routing"], strict=False)
        worst = {"y": 0.0, "f": 0.0}
        for call, want_call in zip(forced["record"], twin["record"]):
            for sub, want in zip(call, want_call):
                for k in worst:
                    worst[k] = max(worst[k], rel_norm(torch, sub[k], want[k]))
        worst["logits"] = rel_norm(torch, forced["logits"], twin["logits"])
        report["forced"] = worst
        report["forced_routing"] = routing_match(torch, forced["routing"],
                                                 twin["record_routing"])
        report["forced_dropped"] = forced["dropped"]
        report["peak"] = torch.cuda.max_memory_allocated()
        del model, twin, free, forced, feed
        torch.cuda.empty_cache()

        # -- full-width mamba2-2.7b, bf16: one FSDP train step
        twin = wait_for(torch, root / "twin_mamba.pt")
        mrep = rank_full_train(torch, np, mamba, SHARD_MAMBA_CHECKED, twin,
                               root / "twin_train_mamba.pt", gen, mesh, dev)
        # -- prefill and decode on the TP x DP layout fed the twin's tokens, then
        # greedy_generate on the mesh from the global prompt
        torch.cuda.reset_peak_memory_stats()
        cfg = dataclasses.replace(mamba, fsdp_params=False)
        with torch.inference_mode():
            model = layout.init_sharded_params(cfg, gen(), mesh, dev)
            prompt, fed = twin["prompt"][rows].to(dev), twin["fed"][:, rows].to(dev)
            before = C.counts()
            torch.cuda.synchronize()
            dist.barrier()
            forced = shard_serve(torch, models, cfg, model, prompt, fed, dev, gather=whole)
            mrep["serve_collectives"] = collective_delta(C.counts(), before)
            mrep["prefill_s"] = forced["walls"][0]
            mrep["decode_ms"] = [w * 1e3 for w in forced["walls"][1:]]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tokens = greedy_generate(cfg, model, twin["prompt"].to(dev), SHARD_SERVE_NEW, dev)
            torch.cuda.synchronize()
            mrep["greedy_s"] = time.perf_counter() - t0
        mrep["logits_rel"] = rel_norm(torch, forced["logits"], twin["logits"])
        mrep["prefill_rel"] = rel_norm(torch, forced["logits"][0], twin["logits"][0])
        mrep["greedy_same_tokens"] = int((tokens.cpu() == twin["fed"].T).sum())
        mrep["greedy_tokens"] = tokens.numel()
        mrep["peak"] = torch.cuda.max_memory_allocated()
        report["mamba"] = mrep
        report["launches"] = {**ops.launches, **ops.variant_launches}
        report["collectives"] = C.counts()
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        bad = [k for k, v in report["forced"].items() if v > SHARD_FULL_TOL]
        for label, rep in (("", report), ("mamba ", report["mamba"])):
            if rep["loss_rel"] > SHARD_FULL_TOL:
                bad.append(f"{label}loss_rel")
            train = rep["train"]
            bad += [f"{label}train {k}" for k in ("grad_norm",) if train[k] > SHARD_TRAIN_TOL[k]]
            bad += [f"{label}train {key} {k}" for key in ("m_norm", "update")
                    for k, v in train[key].items() if v > SHARD_TRAIN_TOL[key]]
        if report["mamba"]["logits_rel"] > SHARD_FULL_TOL:
            bad.append("mamba logits_rel")
        r = report["forced_routing"]
        if r["tokens_other_topk"] > SHARD_SWAP_SHARE * r["tokens"]:
            bad.append("forced_routing")
        if bad:
            raise AssertionError(f"shard: full width {bad} out of bounds: {report}")
    return report


def run_shard_children(args_list, timeout) -> tuple[list[dict], float, int]:
    """Start ``chip_smoke.py --shard-child`` once for each JSON argument,
    all at once, polling the card's used memory every 0.25 s; kill the
    others as soon as one fails, or all at ``timeout``. Returns each
    child's report (its last output line), the wall seconds and the peak
    used memory (MiB, every process's)."""
    import threading

    peak, done = [card_memory_used_mib()], threading.Event()

    def poll():
        while not done.wait(0.25):
            peak[0] = max(peak[0], card_memory_used_mib())

    poller = threading.Thread(target=poll, daemon=True)
    poller.start()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(HERE / "chip_smoke.py"), "--shard-child", a],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for a in args_list]
    outs = [("", "")] * len(procs)

    def read(i):
        outs[i] = procs[i].communicate()

    readers = [threading.Thread(target=read, args=(i,), daemon=True) for i in range(len(procs))]
    for r in readers:
        r.start()
    failed = None
    try:
        while any(r.is_alive() for r in readers):
            if time.perf_counter() - t0 > timeout:
                failed = f"still running after {timeout} s"
                break
            if any(not r.is_alive() and p.returncode for r, p in zip(readers, procs)):
                failed = "a child failed"
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for r in readers:
            r.join(30)
        done.set()
        poller.join()
    wall = time.perf_counter() - t0
    codes = [p.returncode for p in procs]
    if failed or any(codes):
        raise AssertionError(f"shard children ({failed or 'exit codes'} {codes}):\n" + "\n".join(
            f"--- child {i}: {o[0][-3000:]}\n{o[1][-6000:]}" for i, o in enumerate(outs)))
    return [json.loads(o[0].strip().splitlines()[-1]) for o in outs], wall, peak[0]


def card_smi() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def shard_phase(torch) -> dict:
    """Phase 15: the twin's unsharded runs on the card and four ranks of a
    2 x 2 mesh sharing the card (``SHARD_WORLD`` interpreters meeting
    through a ``FileStore``, gloo: NCCL refuses ranks that share a device),
    the ranks reading the twin's results as it writes them; returns the
    model kernels' launches summed over the ranks."""
    import gc

    from repro_torch.sharding import collectives as C

    smi = card_smi()
    gc.collect()
    torch.cuda.empty_cache()
    root = HERE / "build" / "chip_smoke_shard"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    small, full = shard_cfgs()
    mamba = shard_ssm_cfgs()[1]
    log(f"shard: card {smi}; before the phase: this process holds "
        f"{torch.cuda.memory_allocated()} B, the card {card_memory_used_mib()} MiB used")
    log(f"shard: {SHARD_WORLD} ranks share cuda:0 as a {SHARD_MESH[0]} x {SHARD_MESH[1]} data x "
        f"model mesh: backend {C.backend_for('cuda', ranks_per_card=SHARD_WORLD)} (NCCL refuses "
        "two ranks on one device; gloo moves every collective through host memory)")
    # the twin and the ranks start together: the ranks' start-up and small
    # runs overlap the twin's, and they lay the full-width model out only
    # once the twin has written its results and given the card's memory back
    args = [json.dumps({"role": "rank", "root": str(root), "rank": r}) for r in range(SHARD_WORLD)]
    (twin, *reports), wall, peak = run_shard_children(
        [json.dumps({"role": "twin", "root": str(root)})] + args, SHARD_TIMEOUT)
    shutil.rmtree(root, ignore_errors=True)
    log(f"shard: unsharded twin: full-width "
        f"{full.name} {full.n_layers} layers bf16 train step {twin['train_s']:.3f}s loss "
        f"{twin['loss']} peak {twin['train_peak']} B; prefill {SHARD_SERVE_BATCH} x "
        f"{SHARD_SERVE_PROMPT} {twin['prefill_s']:.4f}s + {SHARD_SERVE_NEW} greedy decode "
        f"steps, ms {[round(x, 3) for x in twin['decode_ms']]}, dropped {twin['dropped']} of "
        f"{twin['routed']} pairs; train step grad_norm {twin['train']['grad_norm']}, norms of "
        f"m {twin['train']['m_norm']} and of the update {twin['train']['update_norm']}; "
        f"launches {twin['launches']}; card {smi}")
    tm = twin["mamba"]
    log(f"shard: unsharded twin: full-width {mamba.name} {mamba.n_layers} layers bf16 train "
        f"step {tm['train_s']:.3f}s loss {tm['loss']} peak {tm['train_peak']} B, grad_norm "
        f"{tm['train']['grad_norm']}, norms of m {tm['train']['m_norm']} and of the update "
        f"{tm['train']['update_norm']}; prefill {SHARD_SERVE_BATCH} x {SHARD_SERVE_PROMPT} "
        f"{tm['prefill_s']:.4f}s + {SHARD_SERVE_NEW} greedy decode steps, ms "
        f"{[round(x, 3) for x in tm['decode_ms']]}; peak {tm['peak']} B; launches "
        f"{tm['launches']}; card {smi}")
    for rep in reports:
        log(f"shard: rank {rep['rank']} {rep['coords']} ({rep['backend']}): small f32 "
            f"{SHARD_SMALL_CASES} errors {rep['small']}; full width train step "
            f"{rep['train_s']:.3f}s loss {rep['loss']} (twin {rep['twin_loss']}, rel "
            f"{rep['loss_rel']:.3e}), against the twin's (rel; update: ||got - want|| / "
            f"||want - before||) {rep['train']} (limits {SHARD_TRAIN_TOL}), local "
            f"parameters {rep['local_params']}, train peak "
            f"{rep['train_peak']} B; prefill {rep['prefill_s']:.3f}s, decode ms "
            f"{[round(x, 3) for x in rep['decode_ms']]}; free-running logits rel (logged, "
            f"not held) prefill {rep['prefill_rel']:.3e} decode {rep['decode_rel']:.3e}; dropped "
            f"{rep['dropped']} (twin {rep['twin_dropped']}), routing {rep['routing']}; each "
            f"sub-layer and the head on the twin's inputs: rel {rep['forced']}, routing "
            f"{rep['forced_routing']}, dropped {rep['forced_dropped']}; peak {rep['peak']} B; "
            f"card {smi}")
        log(f"shard: rank {rep['rank']} collectives: train step {rep['train_collectives']}; "
            f"serving {rep['serve_collectives']}; whole run {rep['collectives']}; "
            f"launches {rep['launches']}")
        m = rep["mamba"]
        log(f"shard: rank {rep['rank']} {mamba.name} {mamba.n_layers} layers: FSDP train step "
            f"{m['train_s']:.3f}s loss {m['loss']} (twin {m['twin_loss']}, rel "
            f"{m['loss_rel']:.3e}), against the twin's {m['train']} (limits "
            f"{SHARD_TRAIN_TOL}), local parameters {m['local_params']}, train peak "
            f"{m['train_peak']} B; prefill {m['prefill_s']:.3f}s, decode ms "
            f"{[round(x, 3) for x in m['decode_ms']]} fed the twin's tokens: logits rel "
            f"{m['logits_rel']:.3e} (prefill {m['prefill_rel']:.3e}; limit {SHARD_FULL_TOL}); "
            f"greedy_generate on the mesh {m['greedy_s']:.3f}s, {m['greedy_same_tokens']} of "
            f"{m['greedy_tokens']} tokens the twin's (logged); serve peak {m['peak']} B; "
            f"collectives: train step {m['train_collectives']}; serving (the gated norm's "
            f"gather under tags) {m['serve_collectives']}; card {smi}")
    kernels = ("rmsnorm", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "ssd_scan")
    first = reports[0]["launches"]
    if any(first[k] <= 0 for k in kernels) or any(
            rep["launches"][k] != first[k] for rep in reports for k in kernels):
        raise AssertionError("shard: the ranks' launches of "
                             f"{kernels}: {[rep['launches'] for rep in reports]}")
    if peak > SHARD_PEAK_MIB:
        raise AssertionError(f"shard: the card's peak {peak} MiB over {SHARD_PEAK_MIB} MiB")
    log(f"shard: twin and {SHARD_WORLD} ranks {wall:.1f}s; the card's peak over every process "
        f"{peak} MiB (limit {SHARD_PEAK_MIB}); every rank launched {kernels} alike; card {smi}")
    return {k: sum(rep["launches"][k] for rep in reports) for k in first}


# The phases ``--only`` can run on their own (after the card and build
# phases): those that need no other phase's state.
ONLY_PHASES = ("lint", "kernels", "multihost", "mqo", "examples", "serve", "moe",
               "mamba", "train", "shard")


def parse_only(argv) -> tuple[str, ...] | None:
    """The phases ``--only a,b`` names (``--only build``: the card and build
    phases alone), or None to run them all."""
    if not argv:
        return None
    only = tuple(p for p in argv[1].split(",") if p != "build") if len(argv) == 2 else None
    if argv[0] != "--only" or only is None or any(p not in ONLY_PHASES for p in only):
        raise SystemExit(f"usage: chip_smoke.py [--only PHASE,...] (phases: build, "
                         f"{', '.join(ONLY_PHASES)})")
    return only


def fresh_train_root() -> Path:
    """An empty ``build/chip_smoke_train`` for the train phase (removed by it
    at its end), with the disk's free bytes logged."""
    root = HERE / "build" / "chip_smoke_train"
    shutil.rmtree(root, ignore_errors=True)
    root.parent.mkdir(parents=True, exist_ok=True)
    log(f"disk free under {root.parent}: {shutil.disk_usage(root.parent).free:.3e} B")
    return root


def run_only(torch, np, dp, dev, bw, inst_rate, per_row, only, t_start) -> int:
    """The phases of ``only``, in the script's order, each as the full run
    gives it; no kernels line and no result line (they need every phase)."""
    import repro_torch.core as core
    import repro_torch.mv as mv

    if "lint" in only:
        t_phase = time.perf_counter()
        lint_phase(dev)
        log(f"phase lint {time.perf_counter() - t_phase:.1f}s")
    if "kernels" in only:
        t_phase = time.perf_counter()
        kernel_phase(torch, np, dp, dev, bw, inst_rate, per_row)
        model_kernel_phase(torch, dev, bw)
        log(f"phase kernels {time.perf_counter() - t_phase:.1f}s")
    for name, run in (("multihost", lambda: multihost_phase(torch, core, mv)),
                      ("mqo", lambda: mqo_phase(torch, core, mv, dp)),
                      ("examples", examples_phase),
                      ("serve", lambda: serve_phase(torch, np, dev)),
                      ("moe", lambda: moe_phase(torch, np, dev)),
                      ("mamba", lambda: mamba_phase(torch, np, dev)),
                      ("train", lambda: train_phase(torch, np, dev, fresh_train_root())),
                      ("shard", lambda: shard_phase(torch))):
        if name in only:
            t_phase = time.perf_counter()
            run()
            log(f"phase {name} {time.perf_counter() - t_phase:.1f}s")
    log(f"--only {','.join(only) or 'build'}: total {time.perf_counter() - t_start:.1f}s; "
        "no kernels line and no result without every phase")
    return 0


def main() -> int:
    if not (HERE / "src" / "repro_torch" / "mv" / "dataplane.py").is_file():
        print("chip_smoke: the port (src/repro_torch) is not beside this script",
              file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--multihost-child"] and len(sys.argv) == 3:
        return multihost_child(sys.argv[2])
    if sys.argv[1:2] == ["--shard-child"] and len(sys.argv) == 3:
        return shard_child(sys.argv[2])
    only = parse_only(sys.argv[1:])
    sys.path.insert(0, str(HERE / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import repro_torch.core as core
    import repro_torch.mv as mv
    from repro_torch import native
    from repro_torch.mv import dataplane as dp
    from repro_torch.mv import tableops as T

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    # -- 1. card --------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    bw = hbm_bytes_per_s(kind)
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind} "
        f"count {torch.cuda.device_count()} hbm_rate {bw:.3e} B/s")

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    for name in native.SOURCES:   # build from the checkout's sources, ptxas -v logged
        native.library_path(name).unlink(missing_ok=True)
    logs = native.build()
    log(f"build: {sorted(logs)} in {time.perf_counter() - t0:.1f}s; nvcc seconds by source "
        f"(units {native.PARTS} in parallel, then a link): "
        + ", ".join(f"{k} {v:.1f}" for k, v in native.build_seconds().items()))
    for name in native.PARTS:
        log(f"  {name}: " + ", ".join(line.strip("[]") for line in logs[name].splitlines()
                                      if line.startswith("[unit ")))
    for name, out in logs.items():
        for line in out.splitlines():
            # the tensor-core library's lines also name each instantiation
            if "registers" in line or "spill" in line or "error" in line or (
                    name.startswith("flash_attention") and "Compiling entry" in line):
                log(f"  {name}: {line.strip()}")
    for source, wants in NO_SPILL.items():
        entries = ptxas_entries(logs[source])
        for want in wants:
            found = {fn: e for fn, e in entries.items() if want in fn}
            if not found or any(e.get("spill_stores", 1) or e.get("spill_loads", 1)
                                for e in found.values()):
                raise AssertionError(f"{want}: spills or not built: {found}")
            log(f"ptxas: {want}*: {list(found.values())} (no spills)")
    inst_rate = issue_rate(torch)
    per_row = sass_per_row(native.library_path("dataplane"), HASH_SASS)
    log(f"issue rate {inst_rate:.4e} instructions/s; SASS instructions per row "
        f"{per_row}")
    mma_loops = mma_main_loops(native.library_path("flash_attention_mma"), MMA_SASS)
    log(f"tensor-core flash kernels, main loop (SASS, head dim 80; dk/dv also 160 and "
        f"256): {mma_loops}")
    f32_loops = cuda_core_main_loops(native.library_path("flash_attention"), CUDA_CORE_SASS)
    log(f"f32 flash backward, main loop (SASS; no tensor-core instruction): {f32_loops}")

    if only is not None:
        return run_only(torch, np, dp, dev, bw, inst_rate, per_row, only, t_start)

    # -- 3. lint ----------------------------------------------------------------
    t_phase = time.perf_counter()
    lint_phase(dev)
    log(f"phase lint {time.perf_counter() - t_phase:.1f}s")

    # -- 4. kernels -------------------------------------------------------------
    t_phase = time.perf_counter()
    rows = kernel_phase(torch, np, dp, dev, bw, inst_rate, per_row)
    rows += model_kernel_phase(torch, dev, bw)
    log(f"phase kernels {time.perf_counter() - t_phase:.1f}s")

    # -- 5. main path -----------------------------------------------------------
    t_phase = time.perf_counter()
    store_root = HERE / "build" / "chip_smoke_store"
    shutil.rmtree(store_root, ignore_errors=True)
    store_root.mkdir(parents=True)
    log(f"disk free under {store_root}: {shutil.disk_usage(store_root).free:.3e} B")
    torch.cuda.reset_peak_memory_stats()
    main = refresh_round(torch, core, mv, store_root / "main",
                         MAIN_BYTES_PER_ROOT, MAIN_BUDGET, "cuda")
    peak_mem = torch.cuda.max_memory_allocated()
    sc_rep, serial_rep = main["sc_rep"], main["serial_rep"]
    with cf.ThreadPoolExecutor(2) as pool:   # the two stores' reads side by side
        for name in main["names"]:
            a, b = pool.map(lambda store, n=name: store.read(n), (main["serial"], main["sc"]))
            T.assert_tables_bitwise(a, b, f"serial vs S/C {name}")
            check_finite(torch, name, b)
            del a, b
    unlaunched = [k for k in ROUND_KERNELS if main["launches"][k] <= 0]
    if main["variants"]["probe_sorted/build"] <= 0:
        unlaunched.append("probe_sorted/build")
    if unlaunched:
        raise AssertionError(f"kernels never launched on the main path: {unlaunched}")
    total_bytes = sum(main["graph"].sizes)
    log(f"main: 12 MVs, {total_bytes:.4e} B of MV output, budget {MAIN_BUDGET:.3e} B, "
        f"flagged {sorted(main['plan'].flagged)}")
    log(f"main: serial (the calibration run) {serial_rep.elapsed:.3f}s "
        f"S/C {sc_rep.elapsed:.3f}s speedup {serial_rep.elapsed / sc_rep.elapsed:.3f}x "
        f"catalog_hits {sc_rep.catalog_hits} peak_catalog {sc_rep.peak_catalog_bytes:.0f} B "
        f"max_memory_allocated {peak_mem} B")
    log(f"main: serial read {serial_rep.read_seconds:.3f}s write "
        f"{serial_rep.write_seconds:.3f}s; S/C read {sc_rep.read_seconds:.3f}s "
        f"write {sc_rep.write_seconds:.3f}s")
    log("main: S/C node seconds " + json.dumps(
        {k: round(v, 4) for k, v in sc_rep.node_seconds.items()}))
    log(f"main: launches (serial+S/C) {main['launches']} {main['variants']}; "
        f"S/C round alone {main['sc_launches']}")
    log_probe_shapes("main", main["probe_shapes"], main["launches"]["probe_sorted"])
    log("main: S/C output bitwise equal to serial; every kernel of the round "
        "launched; peak catalog within budget")
    shutil.rmtree(store_root / "main")
    profiled_round(torch, mv, main["wl"], main["plan"], MAIN_BUDGET,
                   store_root / "profiled")
    shutil.rmtree(store_root / "profiled")
    log(f"phase main {time.perf_counter() - t_phase:.1f}s")

    # -- 6. the partitioned incremental scenario -----------------------------------
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    part = run_scenarios(torch, core, mv, dp, main["wl"], store_root,
                         MAIN_BUDGET, "cuda", MAIN_SCENARIO_ROUNDS)
    part_mem = torch.cuda.max_memory_allocated()
    for label in ("partitioned", "unpartitioned"):
        run = part[label]
        log_rounds(label, run["rep"])
        log(f"part: {label} scenario {run['seconds']:.3f}s launches "
            f"{run['launches']} {run['variants']}")
        log_probe_shapes(f"part: {label}", run["probe_shapes"], run["launches"]["probe_sorted"])
    part_launches = part["partitioned"]["launches"]
    part_variants = part["partitioned"]["variants"]
    unlaunched = [k for k in (*ROUND_KERNELS, "pid_hist") if part_launches[k] <= 0]
    if part["partitioned"]["variants"]["fixed_point_encode/weighted"] <= 0:
        unlaunched.append("fixed_point_encode/weighted")
    if unlaunched:
        raise AssertionError(
            f"kernels never launched on the partitioned path: {unlaunched}")
    log(f"part: P={N_PARTITIONS} stores reassemble bitwise to the unpartitioned "
        f"scenario (verify {part['verify_seconds']:.3f}s); every round within "
        f"budget; max_memory_allocated {part_mem} B")
    # the probe at the partitioned path's commonest shape, beside the main one
    (p_uniq, p_n), _ = part["partitioned"]["probe_shapes"].most_common(1)[0]
    # the P=8 store stays as the multi-host phase's oracle
    oracle = part["partitioned"]["store"]
    part_rounds = [r.elapsed for r in part["partitioned"]["rep"].rounds]
    del part
    shutil.rmtree(store_root / "unpartitioned_cuda")
    rows.append(kernel_row(torch, dp, bw, inst_rate, *probe_case(
        torch, dp, dev, p_uniq, p_n, f"{p_n}_into_{p_uniq}_P{N_PARTITIONS}")))
    log(f"phase part {time.perf_counter() - t_phase:.1f}s")

    # -- 7. multi-host: 4 forked hosts on the card -----------------------------------
    t_phase = time.perf_counter()
    mh_launches = multihost_phase(torch, core, mv, main["wl"], oracle, part_rounds)
    del oracle
    shutil.rmtree(store_root, ignore_errors=True)
    log(f"phase multihost {time.perf_counter() - t_phase:.1f}s")

    # -- 8. the MQO shared-prefix path ---------------------------------------------
    t_phase = time.perf_counter()
    mqo_launches, mqo_variants = mqo_phase(torch, core, mv, dp)
    log(f"phase mqo {time.perf_counter() - t_phase:.1f}s")

    # -- 9. card against CPU ------------------------------------------------------
    t_phase = time.perf_counter()
    small_budget = MAIN_BUDGET * SMALL_BYTES_PER_ROOT / MAIN_BYTES_PER_ROOT
    on_card = refresh_round(torch, core, mv, store_root / "small_cuda",
                            SMALL_BYTES_PER_ROOT, small_budget, "cuda")
    on_cpu = refresh_round(torch, core, mv, store_root / "small_cpu",
                           SMALL_BYTES_PER_ROOT, small_budget, "cpu")
    if on_card["plan"].order != on_cpu["plan"].order or \
            on_card["plan"].flagged != on_cpu["plan"].flagged:
        raise AssertionError("card and CPU rounds solved different plans")
    for name in on_card["names"]:
        T.assert_tables_bitwise(on_cpu["sc"].read(name), on_card["sc"].read(name),
                                f"cpu vs card {name}")
    log(f"cpu: 4 MiB/root round, 12 MVs bitwise equal card vs CPU "
        f"(card S/C {on_card['sc_rep'].elapsed:.3f}s, CPU S/C "
        f"{on_cpu['sc_rep'].elapsed:.3f}s)")
    small = {dev_: run_scenarios(torch, core, mv, dp, r["wl"], store_root / "small",
                                 small_budget, dev_, SCENARIO["n_rounds"])["partitioned"]
             for dev_, r in (("cuda", on_card), ("cpu", on_cpu))}
    card_store, cpu_store = small["cuda"]["store"], small["cpu"]["store"]
    if card_store.manifest() != cpu_store.manifest():
        raise AssertionError("card and CPU partitioned stores hold other entries")
    for name in card_store.manifest():
        T.assert_tables_bitwise(cpu_store.read(name), card_store.read(name),
                                f"cpu vs card {name}")
    full = mv.DiskStore(store_root / "small_full", device="cuda")
    mv.run_scenario(on_card["wl"], full, small_budget,
                    mv.UpdateSpec(**dict(SCENARIO, mode="full")), core.PAPER_COST_MODEL)
    for store in (card_store, cpu_store):
        mv.verify_partitioned_equivalence(on_card["wl"], store, N_PARTITIONS, full)
    log(f"cpu: 4 MiB/root P={N_PARTITIONS} incremental scenario, "
        f"{len(card_store.manifest())} partition entries bitwise equal card vs "
        f"CPU; both reassemble to the full-recompute scenario "
        f"(card {small['cuda']['seconds']:.3f}s, CPU {small['cpu']['seconds']:.3f}s)")
    mqo_card_vs_cpu(core, mv, store_root, small_budget)
    shutil.rmtree(store_root, ignore_errors=True)
    log(f"phase cpu {time.perf_counter() - t_phase:.1f}s")

    # -- 10. the examples -------------------------------------------------------
    t_phase = time.perf_counter()
    examples_phase()
    log(f"phase examples {time.perf_counter() - t_phase:.1f}s")

    # -- 11. serving -----------------------------------------------------------------
    t_phase = time.perf_counter()
    serve_launches, oracle_launches = serve_phase(torch, np, dev)
    log(f"phase serve {time.perf_counter() - t_phase:.1f}s")

    # -- 12. MoE and hybrid serving -----------------------------------------------
    t_phase = time.perf_counter()
    moe_launches = moe_phase(torch, np, dev)
    log(f"phase moe {time.perf_counter() - t_phase:.1f}s")

    # -- 13. Mamba-2 serving ------------------------------------------------------
    t_phase = time.perf_counter()
    mamba_launches = mamba_phase(torch, np, dev)
    log(f"phase mamba {time.perf_counter() - t_phase:.1f}s")

    # -- 14. training ----------------------------------------------------------------
    t_phase = time.perf_counter()
    train_launches = train_phase(torch, np, dev, fresh_train_root())
    log(f"phase train {time.perf_counter() - t_phase:.1f}s")

    # -- 15. sharded steps on a mesh of ranks sharing the card -----------------------
    t_phase = time.perf_counter()
    shard_launches = shard_phase(torch)
    log(f"phase shard {time.perf_counter() - t_phase:.1f}s")

    # -- 16. kernels line -----------------------------------------------------------
    # Each kernel reports the times of the case its path's calls take (the
    # data plane's 16.7M-row columns, RMSNorm on the bf16 serving prefill,
    # the flash kernels on the bf16 training shape, the SSD scan on the bf16
    # Mamba-2 serving prefill) and the worst error over all its cases. The
    # model kernels' launches are those of every model path (stablelm
    # serving and its oracle, qwen2-moe and jamba-8L serving and their
    # oracles, jamba-8L's dense oracle, Mamba-2 serving, long prefill and oracle, training,
    # the sharded steps' four ranks). The residual and the scalar RMSNorm's launches are their
    # variants' shares of the RMSNorm count (no model path passes a
    # residual or a row off 16 bytes); the vector RMSNorm's are the rest.
    model_runs = (serve_launches, oracle_launches, *moe_launches, *mamba_launches,
                  train_launches, shard_launches)
    model_launches = {k: sum(run[k] for run in model_runs) for k in serve_launches}
    model_launches["rmsnorm_residual"] = model_launches.pop("rmsnorm/residual")
    model_launches["rmsnorm_scalar"] = model_launches.pop("rmsnorm/scalar")
    model_launches["rmsnorm"] -= (model_launches["rmsnorm_residual"]
                                  + model_launches["rmsnorm_scalar"])
    # The flash kernels report their tensor-core kernels (bf16, the
    # training path's); *_cuda_core the CUDA-core kernels, at the f32 case
    # their paths take (the serving oracle's forward; dq and dk/dv at the
    # training shape, which no main path launches in f32).
    row_of = {f"{k}{suffix}": (k, variant)
              for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
              for suffix, variant in (("", "mma"), ("_cuda_core", "cuda_core"))}
    for name, (kernel, variant) in row_of.items():
        model_launches[name] = model_launches.pop(f"{kernel}/{variant}")
    # The data-plane kernels' launches: the main path's, the partitioned
    # path's, the multi-host path's (shipped by its forked hosts, both runs)
    # and the MQO path's (its unshared and merged scenarios); the scalar
    # compare's are its variant's share of filter_gt's. The multi-host
    # path's share is also listed alone (``multihost_launches``).
    dp_launches = {k: main["launches"][k] + part_launches[k] + mh_launches.get(k, 0)
                   + mqo_launches[k] for k in main["launches"]}
    dp_launches["filter_gt_scalar"] = (main["variants"]["filter_gt/scalar"]
                                       + part_variants["filter_gt/scalar"]
                                       + mh_launches.get("filter_gt/scalar", 0)
                                       + mqo_variants["filter_gt/scalar"])
    if dp_launches["filter_gt_scalar"]:   # every column of these paths has a vector
        raise AssertionError(f"{dp_launches['filter_gt_scalar']} FILTER launches of the "
                             "main, P=8, multi-host and MQO paths took the scalar compare")
    dp_launches["filter_gt"] -= dp_launches["filter_gt_scalar"]
    mh_only = dict(mh_launches, filter_gt_scalar=0)
    row_of["filter_gt_scalar"] = ("filter_gt", None)
    headline = {"filter_gt": "f32", "filter_gt_scalar": "f32_unaligned_scalar",
                "map_derived": "two_f32",
                "fixed_point_encode": "f32", "probe_sorted": "16.7M_into_4.2M",
                "hash64": "uniform", "pid_hist": "uniform_P8",
                "rmsnorm": "2048x5120_bfloat16",
                "rmsnorm_residual": "2048x5120_bfloat16",
                "rmsnorm_scalar": "2048x5120_bfloat16_unaligned",
                "flash_fwd": "2x32/32x4096x4096x80_causal_bfloat16",
                "flash_fwd_cuda_core": "4x32/8x544x544x160_causal_float32",
                "flash_bwd_dq": "2x32/32x4096x4096x80_causal_bfloat16",
                "flash_bwd_dq_cuda_core": "2x32/32x4096x4096x80_causal_float32",
                "flash_bwd_dkv": "2x32/32x4096x4096x80_causal_bfloat16",
                "flash_bwd_dkv_cuda_core": "2x32/32x4096x4096x80_causal_float32",
                "ssd_scan": f"4x{MAMBA_PROMPT}x80x64x128_L64_bfloat16"}
    kernels = []
    for name, case in headline.items():
        kernel, variant = row_of.get(name, (name, None))
        own = [r for r in rows if r["kernel"] == kernel and r.get("variant") == variant]
        row = next(r for r in own if r["case"] == case)
        launches = (model_launches[name] if name in model_launches
                    else dp_launches[name])
        kernels.append(dict(
            name=name, route="cuda", source=MODEL_SOURCES.get(name, SOURCE),
            replaces=REPLACES[name], launches=launches,
            max_abs_err=max(r["max_abs_err"] for r in own),
            ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            device_ms=row["device_ms"], library_device_ms=row["library_device_ms"],
            multihost_launches=mh_only.get(name, 0),
        ))
    log(f"launches: main path {main['launches']}; partitioned path {part_launches}; "
        f"multi-host path (forked hosts) {mh_launches}; MQO path {mqo_launches}; "
        f"serving {serve_launches}; serving oracle {oracle_launches}; qwen2-moe serving, "
        f"oracle, jamba-8L serving, oracle, dense oracle {moe_launches}; Mamba-2 serving, "
        f"long prefill, oracle {list(mamba_launches)}; training {train_launches}; sharded "
        f"(4 ranks) {shard_launches}")
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
