"""The port's attention and RMSNorm gradients against the JAX package, on
the CPU.

The plain flash backward (``ref.attention_bwd``, what a CPU tensor takes)
and the ``FlashAttention`` autograd Function are held against ``jax.grad``
of the reference's ``flash_attention`` custom VJP with its Pallas kernels
in interpret mode, on the loss ``sum(o·cos o)`` of the JAX gradient test
(``tests/kernels/test_flash_attention.py``), within its 2e-4, causal and
not, MHA and GQA, plus a ragged case. RMSNorm's gradient (the Function's
closed form) is held against ``jax.grad`` of ``repro.kernels.ref.rmsnorm``
(the reference's Pallas RMSNorm has no gradient) within 1e-5, with and
without a residual. Inputs are made with numpy from a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels import flash_attention_bwd, flash_attention_fwd, ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.rmsnorm import rmsnorm_bwd

GRAD_TOL = dict(atol=2e-4, rtol=2e-4)
RMS_GRAD_TOL = dict(atol=1e-5, rtol=1e-5)
CASES = [  # b, hq, hkv, sq, sk, d, causal
    (1, 2, 2, 64, 64, 32, True),
    (1, 2, 2, 64, 64, 32, False),
    (1, 4, 2, 64, 64, 32, True),
    (1, 4, 2, 64, 64, 32, False),
    (2, 4, 2, 40, 72, 16, False),    # ragged q/k, both padded to the block
    (1, 4, 1, 48, 48, 24, True),     # MQA, padded rows
]


def inputs(b, hq, hkv, sq, sk, d, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))]


def jax_grads(q, k, v, causal):
    def loss(q, k, v):
        o = jax_flash(q, k, v, causal, None, 32, 32, True)
        return jnp.sum(o * jnp.cos(o))
    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))]


def check(got, want, tol, what=""):
    for g, w, name in zip(got, want, "qkv"):
        assert tuple(g.shape) == w.shape, (name, what)
        np.testing.assert_allclose(g.detach().numpy(), w, err_msg=f"d{name} {what}", **tol)


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal", CASES)
def test_plain_backward_matches_pallas_interpret(b, hq, hkv, sq, sk, d, causal):
    q, k, v = inputs(b, hq, hkv, sq, sk, d)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    o, lse = flash_attention_fwd(tq, tk, tv, causal=causal)
    do = torch.cos(o) - o * torch.sin(o)       # d sum(o·cos o) / do
    check(tref.attention_bwd(tq, tk, tv, o, lse, do, causal=causal),
          jax_grads(q, k, v, causal), GRAD_TOL)


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal", CASES)
def test_autograd_function_matches_pallas_interpret(b, hq, hkv, sq, sk, d, causal):
    q, k, v = inputs(b, hq, hkv, sq, sk, d)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    o = ops.flash_attention(*leaves, causal=causal)
    torch.sum(o * torch.cos(o)).backward()
    check([t.grad for t in leaves], jax_grads(q, k, v, causal), GRAD_TOL)


def test_backward_wrapper_returns_kv_layout_and_launches_nothing_on_cpu():
    q, k, v = (torch.from_numpy(a) for a in inputs(2, 8, 2, 20, 20, 16))
    o, lse = flash_attention_fwd(q, k, v)
    ops.reset_launches()
    dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, torch.ones_like(o))
    assert dq.shape == q.shape and dk.shape == k.shape and dv.shape == v.shape
    assert ops.launches == dict.fromkeys(ops.KERNELS, 0)
    with pytest.raises(ValueError, match="do not fit"):
        flash_attention_bwd(q, k, v, o, lse[:, :, :3], o)


@pytest.mark.parametrize("causal", [True, False])
def test_keyless_rows_give_zero_gradients(causal):
    """A key set of length 0: every row has lse = +inf, so dq = 0 and dk,
    dv are empty."""
    q = torch.randn(1, 2, 5, 8)
    empty = torch.zeros(1, 1, 0, 8)
    o, lse = flash_attention_fwd(q, empty, empty, causal=causal)
    dq, dk, dv = tref.attention_bwd(q, empty, empty, o, lse, torch.ones_like(o),
                                    causal=causal)
    assert not dq.any() and dk.shape == (1, 1, 0, 8) and dv.shape == dk.shape


@pytest.mark.parametrize("with_residual", [False, True])
@pytest.mark.parametrize("shape", [(8, 64), (3, 5, 128)])
def test_rmsnorm_gradient_matches_reference(shape, with_residual):
    rng = np.random.default_rng(7)
    x, r, dy = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    w = (rng.standard_normal(shape[-1]) * 0.1 + 1.0).astype(np.float32)

    def loss(x, w, r):
        y = jref.rmsnorm(x, w, eps=1e-6, residual=r if with_residual else None)
        return jnp.sum(y * jnp.asarray(dy))

    want = [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (x, w, r)))]
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, w, r)]
    y = ops.rmsnorm(leaves[0], leaves[1], residual=leaves[2] if with_residual else None)
    torch.sum(y * torch.from_numpy(dy)).backward()
    np.testing.assert_allclose(leaves[0].grad.numpy(), want[0], **RMS_GRAD_TOL)
    np.testing.assert_allclose(leaves[1].grad.numpy(), want[1], **RMS_GRAD_TOL)
    if with_residual:
        np.testing.assert_allclose(leaves[2].grad.numpy(), want[2], **RMS_GRAD_TOL)
    else:
        assert leaves[2].grad is None
    dx, dw = rmsnorm_bwd(*(torch.from_numpy(a) for a in (x, w, dy)),
                         residual=torch.from_numpy(r) if with_residual else None)
    np.testing.assert_allclose(dx.numpy(), want[0], **RMS_GRAD_TOL)
    np.testing.assert_allclose(dw.numpy(), want[1], **RMS_GRAD_TOL)
