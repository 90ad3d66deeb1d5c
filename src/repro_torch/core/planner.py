"""Beyond-paper integration: S/C Opt as an activation-memory planner.

Training-step remat is the same problem shape the paper solves for MV refresh:
a DAG of artifacts (named per-layer activations), observed per-artifact
metrics (bytes; recompute-seconds saved if kept), and a bounded fast-memory
budget (HBM activation headroom). "Flagging" an activation = saving it for
the backward pass instead of rematerializing.

Degeneracy note (documented, DESIGN.md §3): for a scanned layer stack every
saved forward activation is co-resident at the forward/backward boundary, so
the resident-set constraints collapse to a single capacity constraint and
S/C Opt Order is fixed by autodiff — SimplifiedMKP (Algorithm 1) remains the
exact solver for the save-set choice. We encode it with the same MVGraph
machinery (all candidates feed a boundary sink node).

The chosen names drive ``cfg.remat_policy == "planner"``: the model cuts
each layer into ``torch.utils.checkpoint`` regions at them
(``models/transformer.py``).

The counterpart of ``repro.core.planner``. Its recompute scores are
seconds at a device's dense bf16 rate: the JAX package prices them at a
TPU v5e chip's 197 TFLOP/s, the port at the NVIDIA H100's 989 TFLOP/s
(NVIDIA's data sheet, SXM part, dense). Scores scale uniformly, so the
save sets and bytes are the reference's and ``recompute_seconds_saved`` is
the reference's times 197/989.
"""
from __future__ import annotations

import dataclasses

from ..configs.base import ModelConfig, ShapeSpec
from .graph import MVGraph
from .mkp import simplified_mkp

H100_PEAK_BF16_FLOPS = 989e12  # dense bf16, one H100 SXM


@dataclasses.dataclass(frozen=True)
class ActivationPlan:
    save_names: tuple[str, ...]
    budget_bytes: float
    used_bytes: float
    recompute_seconds_saved: float
    candidates: dict


def _per_group_costs(cfg: ModelConfig, tokens_per_device: int, seq_len: int):
    """(bytes_per_device, recompute_seconds) per candidate name, per group."""
    d, hd = cfg.d_model, cfg.head_dim_
    hp, kv = cfg.n_heads_padded, cfg.n_kv_heads
    t = tokens_per_device
    act_bytes = t * d * 2  # bf16 residual-stream-sized tensor

    mixer_flops = 0.0
    ffn_flops = 0.0
    for mixer, mlp in cfg.pattern:
        if mixer == "attn":
            proj = 2 * t * (d * hp * hd + 2 * d * kv * hd + hp * hd * d)
            attn = 4 * t * seq_len * hp * hd / 2  # causal half
            mixer_flops += proj + attn
        else:
            di, n = cfg.ssm_d_inner, cfg.ssm_state
            proj = 2 * t * d * (2 * di + 2 * n + cfg.ssm_heads) + 2 * t * di * d
            ssd = 2 * t * di * (2 * n + 64)  # chunked intra+inter, chunk=64
            mixer_flops += proj + ssd
        if mlp == "moe":
            ffe = cfg.moe_d_ff
            ffn_flops += 2 * t * 3 * d * ffe * cfg.moe_top_k
            if cfg.moe_shared_experts:
                ffn_flops += 2 * t * 3 * d * cfg.moe_shared_experts * ffe
            if cfg.moe_dense_residual:
                ffn_flops += 2 * t * 3 * d * cfg.d_ff
        elif mlp is not None:
            ffn_flops += 2 * t * 3 * d * cfg.d_ff

    n_sub = len(cfg.pattern)
    n_mlp = sum(1 for _, m in cfg.pattern if m is not None)
    return {
        "mixer_out": (act_bytes * n_sub, mixer_flops / H100_PEAK_BF16_FLOPS),
        "ffn_out": (act_bytes * n_mlp, ffn_flops / H100_PEAK_BF16_FLOPS),
    }


def plan_remat(
    cfg: ModelConfig,
    shape: ShapeSpec,
    dp: int = 16,
    hbm_activation_budget: float = 4e9,
) -> ActivationPlan:
    """Choose which named activations to save under an HBM budget."""
    rows_per_dev = max(shape.global_batch // max(dp, 1), 1)
    micro_rows = min(cfg.microbatch_size, rows_per_dev)
    tokens = micro_rows * shape.seq_len
    per_group = _per_group_costs(cfg, tokens, shape.seq_len)
    g = cfg.n_groups

    names = sorted(per_group)
    sizes = [per_group[n][0] * g for n in names]
    scores = [per_group[n][1] * g for n in names]
    # encode "all co-resident at the fwd/bwd boundary" with a sink node
    sink = len(names)
    graph = MVGraph(
        n=len(names) + 1,
        edges=tuple((i, sink) for i in range(len(names))),
        sizes=tuple(sizes) + (0.0,),
        scores=tuple(scores) + (0.0,),
        names=tuple(names) + ("bwd_boundary",),
    )
    order = list(range(len(names) + 1))
    chosen = simplified_mkp(graph, hbm_activation_budget, order)
    save = tuple(names[i] for i in sorted(chosen) if i < len(names))
    used = sum(sizes[i] for i in chosen if i < len(names))
    saved_s = sum(scores[i] for i in chosen if i < len(names))
    return ActivationPlan(
        save_names=save,
        budget_bytes=hbm_activation_budget,
        used_bytes=used,
        recompute_seconds_saved=saved_s,
        candidates={
            n: {"bytes": per_group[n][0] * g, "recompute_s": per_group[n][1] * g}
            for n in names
        },
    )
