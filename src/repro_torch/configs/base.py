"""Model/shape configuration system.

Every assigned architecture is one ``ModelConfig``; the unified decoder stack
(`repro_torch.models.transformer`) is entirely config-driven. Block structure is a
repeated ``pattern`` of (mixer, mlp) sub-layers — dense archs repeat a single
("attn", "glu") entry, Mamba-2 repeats ("ssm", None), Jamba scans 8-sub-layer
hybrid superblocks — so scan-over-layers stays homogeneous and the lowered
HLO stays small enough for the 512-device dry-run compiles.

TP divisibility adaptations (see DESIGN.md §5) are explicit config fields:
``pad_heads_to`` (56→64 for llava/arctic) and ``pad_vocab_to`` (mamba2's
50280→50304); padded slices are zero-initialized and masked in the loss.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense|ssm|hybrid|moe|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None       # explicit for gemma (256); else d//H
    mlp_kind: str = "glu"             # glu (SwiGLU) | geglu
    # block pattern: tuple of (mixer, mlp) per sub-layer of a scanned group.
    pattern: tuple[tuple[str, str | None], ...] = (("attn", "mlp"),)
    # -- MoE --------------------------------------------------------------
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_shared_experts: int = 0
    moe_d_ff: int = 0                 # per-expert hidden dim
    moe_dense_residual: bool = False  # arctic: dense FFN in parallel with MoE
    moe_capacity_factor: float = 1.25
    # "gather": GSPMD sort/scatter dispatch (baseline; GSPMD inserts heavy
    # all-gathers). "shard_map_ep": explicit expert-parallel dispatch with a
    # local capacity buffer + psum combine (beyond-paper §Perf optimization;
    # needs moe_experts_padded % TP == 0 and a mesh context).
    moe_impl: str = "gather"
    # §Perf: pad the expert count (qwen's 60 ∤ 16 → 64) with zero-weight,
    # router-masked experts so EP sharding becomes available.
    pad_experts_to: int = 0
    # -- SSM (Mamba-2 / SSD) ------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_conv_kernel: int = 4
    ssm_expand: int = 2
    # -- embeddings / loss -----------------------------------------------------
    tie_embeddings: bool = False
    pad_vocab_to: int = 0             # 0 = auto (next multiple of 128)
    pad_heads_to: int = 0             # 0 = no padding
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    # -- modality frontend (stub per task spec) -----------------------------
    frontend: str = "tokens"          # tokens | vlm (patch embeds) | audio
    vlm_patches: int = 576            # patch positions prepended for vlm
    # -- training knobs -------------------------------------------------------
    dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"  # bf16 on 405B-class so state fits HBM
    microbatch_size: int = 4          # per-device rows per grad-accum step
    remat_policy: str = "block"       # none|block|dots|planner
    fsdp_params: bool = False         # shard weights over the data axis too
    # -- attention flavour -----------------------------------------------------
    attn_window: int = 0              # 0 = full causal
    # scan-over-groups unroll factor. 1 = rolled (small HLO, fast compiles —
    # the production setting). The dry-run's cost-accurate pass sets it to
    # n_groups because XLA cost analysis counts while-loop bodies ONCE.
    scan_unroll: int = 1
    # §Perf beyond-paper knobs (see EXPERIMENTS.md):
    # sequence-parallel residual stream: shard (b,s,d) activations over the
    # model axis between blocks (Korthikanti-style SP) — training only.
    seq_shard_activations: bool = False
    # decode KV cache sharded over the sequence dim when kv_heads < TP
    # (fits-proof fix for llama3-405b decode_32k).
    shard_cache_seq: bool = False
    notes: str = ""

    # ---- derived ----------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def n_heads_padded(self) -> int:
        return max(self.n_heads, self.pad_heads_to or 0)

    @property
    def vocab_padded(self) -> int:
        mult = self.pad_vocab_to or 128
        return math.ceil(self.vocab_size / mult) * mult

    @property
    def moe_experts_padded(self) -> int:
        return max(self.moe_experts, self.pad_experts_to or 0)

    @property
    def n_groups(self) -> int:
        assert self.n_layers % len(self.pattern) == 0, (
            self.n_layers,
            len(self.pattern),
        )
        return self.n_layers // len(self.pattern)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    def has_mixer(self, kind: str) -> bool:
        return any(m == kind for m, _ in self.pattern)

    @property
    def supports_long_context(self) -> bool:
        """long_500k runs only for sub-quadratic (SSM/hybrid) archs."""
        return self.has_mixer("ssm")

    def shapes(self) -> list[ShapeSpec]:
        out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
        if self.supports_long_context:
            out.append(SHAPES["long_500k"])
        return out

    def param_count(self) -> int:
        """Total parameters (analytic, incl. embeddings)."""
        from ..models.transformer import count_params_analytic

        return count_params_analytic(self)

    def active_param_count(self) -> int:
        from ..models.transformer import count_params_analytic

        return count_params_analytic(self, active_only=True)

    def reduced(self, **overrides) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        pat = self.pattern
        small = dict(
            n_layers=len(pat) * 2,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads else 4,
            d_ff=128,
            vocab_size=256,
            head_dim=16,
            moe_experts=min(self.moe_experts, 8),
            moe_top_k=min(self.moe_top_k, 2),
            moe_shared_experts=min(self.moe_shared_experts, 1),
            moe_d_ff=64 if self.moe_d_ff else 0,
            pad_experts_to=0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16,
            pad_heads_to=0,
            pad_vocab_to=0,
            vlm_patches=8,
            microbatch_size=2,
            name=self.name + "-reduced",
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)


_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        load_all()
    return _REGISTRY[name]


def all_configs() -> dict[str, ModelConfig]:
    if not _REGISTRY:
        load_all()
    return dict(_REGISTRY)


ARCH_IDS = (
    "llama3-405b",
    "gemma-7b",
    "stablelm-3b",
    "stablelm-12b",
    "mamba2-2.7b",
    "jamba-v0.1-52b",
    "llava-next-34b",
    "qwen2-moe-a2.7b",
    "arctic-480b",
    "musicgen-large",
)


def load_all() -> None:
    import importlib

    for arch in ARCH_IDS:
        importlib.import_module(f"repro_torch.configs.{arch.replace('-', '_').replace('.', '_')}")
