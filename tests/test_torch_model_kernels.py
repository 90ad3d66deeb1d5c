"""The port's model kernels and model configuration against the JAX package,
on the CPU.

The port's plain versions (what a CPU tensor takes) are held against the
JAX package's Pallas kernels run in interpret mode, over the JAX kernel
tests' grids plus the serving path's head dim (160) with GQA and causal
attention with sq != sk. Tolerances are those of ``tests/kernels/``:
RMSNorm 1e-5 in f32 and 2e-2 in bf16 (one bf16 rounding of the output);
attention 2e-5 in f32 and 3e-2 in bf16, for ``o`` and ``lse``. Inputs are
made with numpy from a seed; bf16 inputs are the same f32 values rounded to
nearest even by each framework, so both packages see the same bits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.kernels import flash_attention_fwd as jax_flash_fwd
from repro.kernels import rmsnorm as jax_rmsnorm
from repro.models import init_params as jax_init_params
from repro_torch import configs as tcfg
from repro_torch import convert
from repro_torch.kernels import flash_attention_fwd, ops
from repro_torch.kernels.ops import rmsnorm
from repro_torch.models import count_params_analytic

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
RMS_TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=2e-2, rtol=2e-2)}
ATTN_TOL = {"float32": dict(atol=2e-5, rtol=2e-5), "bfloat16": dict(atol=3e-2, rtol=3e-2)}


def both(a: np.ndarray, dtype: str):
    """The same f32 values as a JAX array and a torch tensor of ``dtype``."""
    jdt, tdt = DTYPES[dtype]
    a = a.astype(np.float32)
    return jnp.asarray(a, dtype=jdt), torch.from_numpy(a).to(tdt)


def as_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(8, 64), (3, 5, 128), (300, 256)])
@pytest.mark.parametrize("with_residual", [False, True])
def test_rmsnorm_matches_pallas_interpret(shape, dtype, with_residual):
    rng = np.random.default_rng(sum(shape))
    xj, xt = both(rng.standard_normal(shape), dtype)
    wj, wt = both(rng.standard_normal(shape[-1:]) * 0.1 + 1.0, dtype)
    rj, rt = both(rng.standard_normal(shape), dtype) if with_residual else (None, None)
    expect = jax_rmsnorm(xj, wj, residual=rj, block_rows=64, interpret=True)
    got = rmsnorm(xt, wt, residual=rt)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    np.testing.assert_allclose(as_f32(got), as_f32(expect), **RMS_TOL[dtype])


FLASH_CASES = [
    (1, 2, 2, 64, 64, 32, True),       # MHA, square
    (2, 4, 2, 32, 32, 16, True),       # GQA group=2
    (1, 4, 1, 48, 48, 32, False),      # MQA, non-causal, pad to block
    (1, 2, 2, 40, 72, 16, False),      # ragged q/k, both padded
    (1, 8, 2, 128, 128, 64, True),     # block-sized
    (1, 8, 2, 72, 72, 160, True),      # the serving path's head dim, GQA group=4
    (1, 4, 2, 40, 72, 32, True),       # causal, sq < sk (top-left diagonal)
    (1, 4, 2, 72, 40, 32, True),       # causal, sq > sk
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal", FLASH_CASES)
def test_flash_fwd_matches_pallas_interpret(b, hq, hkv, sq, sk, d, causal, dtype):
    rng = np.random.default_rng(sq * 1000 + sk + d)
    qj, qt = both(rng.standard_normal((b, hq, sq, d)), dtype)
    kj, kt = both(rng.standard_normal((b, hkv, sk, d)), dtype)
    vj, vt = both(rng.standard_normal((b, hkv, sk, d)), dtype)
    o_ref, lse_ref = jax_flash_fwd(qj, kj, vj, causal=causal, block_q=32,
                                   block_k=32, interpret=True)
    o, lse = flash_attention_fwd(qt, kt, vt, causal=causal)
    assert o.dtype == qt.dtype and lse.dtype == torch.float32
    assert lse.shape == (b, hq, sq)
    np.testing.assert_allclose(as_f32(o), as_f32(o_ref), **ATTN_TOL[dtype])
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), **ATTN_TOL[dtype])
    assert np.isfinite(lse.numpy()).all()


def test_flash_fwd_strided_inputs_match_contiguous():
    """The model hands the kernel transposed views; the plain version must
    give what it gives on contiguous copies."""
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((2, 24, 8, 16)).astype(np.float32))
    kv = torch.from_numpy(rng.standard_normal((2, 24, 2, 16)).astype(np.float32))
    o, lse = flash_attention_fwd(q.transpose(1, 2), kv.transpose(1, 2), kv.transpose(1, 2))
    o2, lse2 = flash_attention_fwd(q.transpose(1, 2).contiguous(),
                                   *[kv.transpose(1, 2).contiguous()] * 2)
    torch.testing.assert_close(o, o2, atol=0, rtol=0)
    torch.testing.assert_close(lse, lse2, atol=0, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_fully_masked_rows_give_zero_output_and_inf_lse(causal):
    """With no key at all every row is masked: the Pallas kernel's finalize
    gives o = 0 and lse = +inf (torch.logsumexp alone would give -inf)."""
    q = torch.ones(1, 4, 5, 16)
    kv = torch.ones(1, 2, 0, 16)
    o, lse = flash_attention_fwd(q, kv, kv, causal=causal)
    assert torch.equal(o, torch.zeros_like(o))
    assert torch.isposinf(lse).all()


def test_kernel_entry_points_validate_shapes():
    q = torch.ones(1, 3, 4, 8)
    with pytest.raises(ValueError, match="does not fit"):
        flash_attention_fwd(q, torch.ones(1, 2, 4, 8), torch.ones(1, 2, 4, 8))
    with pytest.raises(ValueError, match="device"):
        rmsnorm(torch.ones(2, 8, device="meta"), torch.ones(8))


def test_cpu_tensors_launch_no_model_kernel():
    ops.reset_launches()
    x = torch.ones(3, 16)
    ops.rmsnorm(x, torch.ones(16), residual=x)
    ops.flash_attention(torch.ones(1, 2, 4, 8), torch.ones(1, 1, 4, 8), torch.ones(1, 1, 4, 8))
    assert ops.launches == dict.fromkeys(ops.KERNELS, 0)
    assert all(v == 0 for v in ops.variant_launches.values())


def test_rmsnorm_vector_kernel_rule():
    """The vector RMSNorm takes rows on 16 bytes whose length is a multiple
    of 8 and whose w and two row buffers fit its shared memory; any other
    row takes the scalar kernel."""
    from repro_torch.kernels.rmsnorm import VECTOR_MAX_SMEM, vector_ok

    def case(d, dtype=torch.bfloat16, wdtype=None, residual=False, offset=0):
        x = torch.zeros(2 * d + 8, dtype=dtype)[offset:offset + 2 * d].view(2, d)
        w = torch.zeros(d, dtype=wdtype or dtype)
        return vector_ok(x, w, x.clone() if residual else None, torch.empty_like(x))

    assert case(5120) and case(5120, torch.float32) and case(8)
    assert case(5120, torch.float32, torch.bfloat16, residual=True)
    assert not case(100) and not case(5124, torch.float32)       # d not a multiple of 8
    assert not case(5120, offset=1) and case(5120, offset=8)    # the base off / on 16 bytes
    widest = VECTOR_MAX_SMEM // (2 + 2 * 2)                    # bf16 w and rows
    assert case(widest // 8 * 8) and not case(widest // 8 * 8 + 8)
    assert not case(widest // 8 * 8, residual=True)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

DERIVED = ("head_dim_", "n_heads_padded", "vocab_padded", "moe_experts_padded",
           "n_groups", "ssm_d_inner", "ssm_heads", "supports_long_context")


@pytest.mark.parametrize("arch", jcfg.base.ARCH_IDS)
def test_config_matches_reference(arch):
    assert tcfg.base.ARCH_IDS == jcfg.base.ARCH_IDS
    j, t = jcfg.get_config(arch), tcfg.get_config(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for name in DERIVED:
        assert getattr(t, name) == getattr(j, name), name
    assert [dataclasses.asdict(s) for s in t.shapes()] == [dataclasses.asdict(s) for s in j.shapes()]
    assert t.param_count() == j.param_count() == count_params_analytic(t)
    assert t.active_param_count() == j.active_param_count()
    assert dataclasses.asdict(t.reduced(n_heads=8, n_kv_heads=2)) == dataclasses.asdict(
        j.reduced(n_heads=8, n_kv_heads=2))
    assert set(tcfg.all_configs()) == set(jcfg.all_configs())


# ---------------------------------------------------------------------------
# weights carried across
# ---------------------------------------------------------------------------

def _bits(a: np.ndarray) -> bytes:
    return np.ascontiguousarray(a).view(np.uint8).tobytes()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["stablelm-12b", "gemma-7b"])
def test_params_from_reference_round_trips_bitwise(arch, dtype):
    cfg = jcfg.get_config(arch).reduced(dtype=dtype, n_heads=8, n_kv_heads=2)
    tree = jax.tree.map(np.asarray, jax_init_params(cfg, jax.random.PRNGKey(0)))
    model = convert.params_from_reference(tcfg.get_config(arch).reduced(
        dtype=dtype, n_heads=8, n_kv_heads=2), tree, device="cpu")
    state = model.state_dict()
    expected = {"embed": tree["embed"], "final_norm": tree["final_norm"]}
    if not cfg.tie_embeddings:
        expected["lm_head"] = tree["lm_head"]
    sub = tree["blocks"]["sub0"]
    for g in range(cfg.n_groups):
        expected[f"layers.{g}.norm1"] = sub["norm1"][g]
        expected[f"layers.{g}.norm2"] = sub["norm2"][g]
        for k in ("wq", "wk", "wv", "wo"):
            expected[f"layers.{g}.mixer.{k}"] = sub["mixer"][k][g]
        for k in ("wi", "wo"):
            expected[f"layers.{g}.ffn.{k}"] = sub["ffn"][k][g]
    assert set(state) == set(expected)
    for name, ref in expected.items():
        got = state[name]
        assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == ref.shape, name
        assert _bits(got.view(torch.uint16 if dtype == "bfloat16" else torch.float32)
                     .numpy()) == _bits(ref), name
