"""The tensor-core flash kernels (``csrc/flash_attention_mma.cu``) as far as
the CPU can hold them.

The wrapper's choice of kernel (``variant``: dtype and head width to
``mma`` or ``cuda_core``) and its rule for 16-byte copies
(``cp_async_aligned``) are pure functions, tested here directly. The
kernels themselves run only on the card; what they change in the numbers
is emulated here in PyTorch: the forward's online softmax over 64-column
kv tiles with P rounded to bf16 before P·V (the normaliser sums the
unrounded p), the dk/dv backward with Pᵀ and dSᵀ rounded to bf16 before
Pᵀ·dO and dSᵀ·Q (also at head dims 160 and 256, where the kernel's two
warps per 16 kv rows exchange them already rounded), and the dq backward with dS rounded to bf16 before dS·K,
every product on bf16 operands with f32 sums. The emulation is held
against the JAX package's Pallas forward and ``jax.grad`` of its custom VJP
in interpret mode, on bf16 inputs made with numpy from a seed, within the
bounds the card is held to (3e-2 elementwise and 1e-2 of ‖want‖), causal
and ragged, with GQA group 4.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_attention import flash_attention_fwd as jax_flash_fwd
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

TOL = dict(atol=3e-2, rtol=3e-2)   # bf16: one rounding of each output
REL_TOL = 1e-2                     # ||got - want|| / ||want||
BN = 64                            # kv rows per forward tile (the kernel's at d <= 160)
CASES = [  # b, hq, hkv, sq, sk, d, causal
    (1, 4, 1, 63, 63, 80, True),
    (1, 4, 1, 65, 65, 16, True),
    (1, 4, 1, 129, 129, 80, True),    # three kv tiles, the diagonal in the last
    (1, 4, 1, 1, 129, 80, False),     # one query
    (1, 4, 1, 129, 63, 16, True),     # causal, sq > sk
    (1, 4, 1, 65, 129, 80, False),    # ragged
    (2, 4, 1, 63, 65, 16, True),      # causal, sq < sk
    (1, 4, 1, 129, 1, 80, False),     # one key
]
# With one key, o = v and every gradient but dv is zero up to rounding: no
# relative bound can hold there, so the backward takes the other cases.
BWD_CASES = [c for c in CASES if c[4] > 1]
# dk/dv at the wide heads (stablelm-12b's 160, gemma-7b's 256), where two
# warps share each 16 kv rows and exchange Pᵀ and dSᵀ in bf16: the tile
# edges 63 / 65 / 129, GQA, ragged and causal sq != sk.
WIDE_DKV_CASES = [
    (1, 4, 1, 63, 63, 160, True),
    (1, 4, 1, 65, 65, 256, True),
    (1, 4, 1, 129, 129, 160, True),
    (1, 8, 2, 65, 129, 256, False),   # ragged, GQA
    (2, 4, 1, 63, 129, 160, True),    # causal, sq < sk
    (1, 4, 2, 129, 65, 256, True),    # causal, sq > sk, GQA
]


def mma_forward(q, k, v, causal, scale=None):
    """``(o, lse)`` rounded as ``flash_fwd_mma_kernel`` rounds: S = Q·Kᵀ on
    bf16 operands in f32, an online softmax over BN-column tiles, P rounded
    to bf16 for P·V with f32 sums, the normaliser from the f32 p."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qf = q.float().reshape(b, hkv, hq // hkv, sq, d)
    m = torch.full(qf.shape[:-1], -math.inf)
    l = torch.zeros(qf.shape[:-1])
    acc = torch.zeros(qf.shape)
    rows = torch.arange(sq)
    for k0 in range(0, sk, BN):
        kt, vt = k[:, :, k0:k0 + BN].float(), v[:, :, k0:k0 + BN].float()
        s = torch.einsum("bkgqd,bktd->bkgqt", qf, kt) * scale
        if causal:
            cols = torch.arange(k0, k0 + kt.shape[2])
            s = s.masked_fill(cols[None, :] > rows[:, None], -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        base = m_new.masked_fill(m_new == -math.inf, 0.0)    # no inf - inf
        corr = torch.exp(m - base)
        p = torch.exp(s - base[..., None])
        l = l * corr + p.sum(-1)
        pv = torch.einsum("bkgqt,bktd->bkgqd", p.bfloat16().float(), vt)
        acc = acc * corr[..., None] + pv
        m = m_new
    keyed = l > 0
    o = torch.where(keyed[..., None], acc / l.clamp_min(1e-30)[..., None], 0.0)
    lse = torch.where(keyed, m + torch.log(l.clamp_min(1e-30)), math.inf)
    return o.reshape(b, hq, sq, d).to(q.dtype), lse.reshape(b, hq, sq)


def mma_dkv(q, k, v, o, lse, do, causal, scale=None):
    """``(dk, dv)`` rounded as ``flash_bwd_dkv_mma_kernel`` rounds: Sᵀ and
    dPᵀ on bf16 operands in f32, Pᵀ = exp(Sᵀ·scale − lse) and
    dSᵀ = Pᵀ ⊙ (dPᵀ − δ)·scale in f32, each rounded to bf16 for its second
    product, f32 sums over the group's query heads."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qf = q.float().reshape(b, hkv, g, sq, d)
    dof = do.float().reshape(b, hkv, g, sq, d)
    s = torch.einsum("bkgqd,bktd->bkgqt", qf, k.float()) * scale
    p = torch.exp(s - lse.reshape(b, hkv, g, sq, 1))
    if causal:
        p = p.masked_fill(torch.arange(sk)[None, :] > torch.arange(sq)[:, None], 0.0)
    delta = (dof * o.float().reshape(b, hkv, g, sq, d)).sum(-1, keepdim=True)
    dp = torch.einsum("bkgqd,bktd->bkgqt", dof, v.float())
    ds = p * (dp - delta) * scale
    dv = torch.einsum("bkgqt,bkgqd->bktd", p.bfloat16().float(), dof)
    dk = torch.einsum("bkgqt,bkgqd->bktd", ds.bfloat16().float(), qf)
    return dk.to(k.dtype), dv.to(v.dtype)


def mma_dq(q, k, v, o, lse, do, causal, scale=None):
    """dq rounded as ``flash_bwd_dq_mma_kernel`` rounds: S and dP on bf16
    operands in f32, P = exp(S·scale − lse) and dS = P ⊙ (dP − δ)·scale in
    f32, dS rounded to bf16 for dS·K with f32 sums, dq rounded once."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qf = q.float().reshape(b, hkv, g, sq, d)
    dof = do.float().reshape(b, hkv, g, sq, d)
    s = torch.einsum("bkgqd,bktd->bkgqt", qf, k.float()) * scale
    p = torch.exp(s - lse.reshape(b, hkv, g, sq, 1))
    if causal:
        p = p.masked_fill(torch.arange(sk)[None, :] > torch.arange(sq)[:, None], 0.0)
    delta = (dof * o.float().reshape(b, hkv, g, sq, d)).sum(-1, keepdim=True)
    dp = torch.einsum("bkgqd,bktd->bkgqt", dof, v.float())
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bkgqt,bktd->bkgqd", ds.bfloat16().float(), k.float())
    return dq.reshape(b, hq, sq, d).to(q.dtype)


def bf16_inputs(b, hq, hkv, sq, sk, d, seed=11):
    """q, k, v as the same bf16 bits in numpy f32, JAX and torch."""
    rng = np.random.default_rng(seed)
    arrays = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).bfloat16()
              for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))]
    return arrays, [jnp.asarray(a.float().numpy(), dtype=jnp.bfloat16) for a in arrays]


def hold(got, want, what):
    """Elementwise within TOL and within REL_TOL of ||want|| (finite
    entries: a keyless row's +inf lse is held apart by the elementwise
    check)."""
    got = got.float() if isinstance(got, torch.Tensor) else torch.from_numpy(
        np.array(got, np.float32))
    want = torch.from_numpy(np.array(want, np.float32))
    assert got.shape == want.shape, what
    torch.testing.assert_close(got, want, **TOL, msg=lambda m: f"{what}\n{m}")
    fin = torch.isfinite(want)
    norm = float(want[fin].double().norm())
    diff = float((got[fin] - want[fin]).double().norm())
    assert diff <= REL_TOL * norm, f"{what}: ||got - want|| {diff} > {REL_TOL} x {norm}"


# ---------------------------------------------------------------------------
# the wrapper's choices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [16, 64, 80, 96, 100, 128, 160, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_variant_by_dtype_and_head_width(dtype, d):
    """bf16 takes the tensor cores up to 256 in the forward, dq and dk/dv;
    f32 always keeps the CUDA cores (no TF32)."""
    bf16 = dtype == torch.bfloat16
    for kernel in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert fa.variant(kernel, dtype, d) == ("mma" if bf16 else "cuda_core"), kernel


def test_cp_async_alignment_rule():
    """16-byte copies need every row on 16 bytes: base address and the
    strides of the dimensions longer than 1."""
    x = torch.zeros(2, 4, 8, 80, dtype=torch.bfloat16)
    assert x.data_ptr() % 16 == 0
    assert fa.cp_async_aligned(x, x)
    assert fa.cp_async_aligned(torch.zeros(2, 8, 4, 80, dtype=torch.bfloat16).transpose(1, 2))
    assert not fa.cp_async_aligned(x, torch.zeros(1, 6, 33, 100, dtype=torch.bfloat16))
    shifted = torch.zeros(2 * 4 * 8 * 80 + 8, dtype=torch.bfloat16)
    assert fa.cp_async_aligned(shifted[8:].view(2, 4, 8, 80))
    assert not fa.cp_async_aligned(shifted[1:2 * 4 * 8 * 80 + 1].view(2, 4, 8, 80))
    # a dimension of length 1 is never stepped over: its stride does not count
    one_row = torch.zeros(1, 4, 1, 100, dtype=torch.bfloat16)[:, :, :, :96]
    assert one_row.stride()[2] == 100 and not fa.cp_async_aligned(one_row)
    assert fa.cp_async_aligned(torch.zeros(1, 1, 1, 100, dtype=torch.bfloat16)[..., :96])
    assert fa.cp_async_aligned(torch.zeros(1, 2, 5, 96, dtype=torch.bfloat16)[:, :1])


# ---------------------------------------------------------------------------
# the rounding points against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal", CASES)
def test_mma_forward_rounding_within_bounds_of_pallas(b, hq, hkv, sq, sk, d, causal):
    (q, k, v), (qj, kj, vj) = bf16_inputs(b, hq, hkv, sq, sk, d)
    o, lse = mma_forward(q, k, v, causal)
    want_o, want_lse = jax_flash_fwd(qj, kj, vj, causal, None, 64, 64, True)
    case = (b, hq, hkv, sq, sk, d, causal)
    hold(o, want_o, f"o {case}")
    hold(lse, want_lse, f"lse {case}")
    # and the rounding is the only change from the plain version
    plain_o, plain_lse = ref.attention_with_lse(q, k, v, causal=causal)
    hold(o, plain_o.float().numpy(), f"o vs plain {case}")
    hold(lse, plain_lse.numpy(), f"lse vs plain {case}")


@functools.lru_cache(maxsize=None)
def pallas_grad_case(b, hq, hkv, sq, sk, d, causal):
    """The loss of the JAX gradient test, sum(o·cos o) over the f32 output:
    JAX's (dq, dk, dv) through its Pallas custom VJP in interpret mode, and
    the emulated forward's q, k, v, o, lse and output gradient do."""
    (q, k, v), (qj, kj, vj) = bf16_inputs(b, hq, hkv, sq, sk, d)

    def loss(q, k, v):
        o = jax_flash(q, k, v, causal, None, 64, 64, True).astype(jnp.float32)
        return jnp.sum(o * jnp.cos(o))

    want = jax.grad(loss, argnums=(0, 1, 2))(qj, kj, vj)
    o, lse = mma_forward(q, k, v, causal)
    of = o.float()
    do = (torch.cos(of) - of * torch.sin(of)).bfloat16()   # d sum(o·cos o) / do
    return want, (q, k, v, o, lse, do)


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal", BWD_CASES + WIDE_DKV_CASES)
def test_mma_dkv_rounding_within_bounds_of_pallas_grad(b, hq, hkv, sq, sk, d, causal):
    """JAX's dq, dk, dv against the emulated forward and dk/dv (dq here from
    the plain version; the dq kernel's rounding is held below), at the
    training widths and the wide heads."""
    want, (q, k, v, o, lse, do) = pallas_grad_case(b, hq, hkv, sq, sk, d, causal)
    dq = ref.attention_bwd(q, k, v, o, lse, do, causal=causal)[0]
    dk, dv = mma_dkv(q, k, v, o, lse, do, causal)
    case = (b, hq, hkv, sq, sk, d, causal)
    for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert got.dtype == torch.bfloat16
        hold(got, w.astype(jnp.float32), f"{name} {case}")


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal", BWD_CASES)
def test_mma_dq_rounding_within_bounds_of_pallas_grad(b, hq, hkv, sq, sk, d, causal):
    """JAX's dq against the emulated dq kernel (dS in bf16 before dS·K), from
    the emulated forward's o and lse; and the rounding is the only change
    from the plain version."""
    want, (q, k, v, o, lse, do) = pallas_grad_case(b, hq, hkv, sq, sk, d, causal)
    dq = mma_dq(q, k, v, o, lse, do, causal)
    case = (b, hq, hkv, sq, sk, d, causal)
    assert dq.dtype == torch.bfloat16
    hold(dq, want[0].astype(jnp.float32), f"dq {case}")
    plain = ref.attention_bwd(q, k, v, o, lse, do, causal=causal)[0]
    hold(dq, plain.float().numpy(), f"dq vs plain {case}")
