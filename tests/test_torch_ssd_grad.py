"""The SSD scan's gradient in the port against the JAX package, on the CPU.

The JAX package differentiates its scan only under its XLA dispatch, as
``jax.vjp`` of ``repro.kernels.ref.ssd_scan_chunked`` (its Pallas scan has
no gradient). The port's closed-form VJP (``ssd_scan_bwd``) and its
autograd Function (``SSDScan``, reached through ``ssd_scan`` when an input
requires grad) are held against it: the five gradients (x, dt, a, B, C)
for one output gradient, the inputs and the output gradient made with
numpy from a seed. Tolerances are the scan's own: in f32 2e-4 elementwise
(sums taken in another order) and 1e-4 of ||want||; in bf16 5e-2 and 1e-2
of ||want|| (one bf16 rounding of each gradient). ``gradcheck`` in f64
holds the VJP against finite differences of the exact recurrence.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ssd_scan as mod
from repro_torch.kernels.ssd_scan import SSDScan, ssd_scan, ssd_scan_bwd

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": (2e-4, 1e-4), "bfloat16": (5e-2, 1e-2)}   # elementwise, of ||want||
NAMES = ("x", "dt", "a", "B", "C")
SHAPES = [  # b, s, h, p, n, chunk
    (1, 128, 2, 16, 8, 32),    # four chunks
    (2, 192, 3, 8, 16, 64),    # three chunks, state 16
    (2, 20, 8, 16, 16, 64),    # one chunk: the reduced configs' s = chunk = 20
    (1, 64, 2, 8, 8, 64),      # one chunk of exactly 64
    (1, 128, 2, 64, 128, 64),  # mamba2-2.7b's head dim and state 128
]


def inputs(b, s, h, p, n, seed=11, dt_scale=0.1):
    """x, dt (softplus'd, times ``dt_scale``), a (negative), B, C and the
    output gradient dy, f32 numpy, the distributions of
    ``tests/kernels/test_ssd_scan.py``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p))
    dt = np.logaddexp(rng.standard_normal((b, s, h)), 0.0) * dt_scale
    a = -np.exp(rng.standard_normal(h) * 0.5)
    bm = rng.standard_normal((b, s, n)) / np.sqrt(n)
    cm = rng.standard_normal((b, s, n)) / np.sqrt(n)
    dy = rng.standard_normal((b, s, h, p))
    return [t.astype(np.float32) for t in (x, dt, a, bm, cm, dy)]


def jax_grads(arrays, dtype, chunk):
    """``jax.vjp`` of the reference's chunked scan: the five gradients as
    f32 numpy (a stays f32, the rest in ``dtype``)."""
    jdt = DTYPES[dtype][0]
    *args, dy = [jnp.asarray(t, dtype=jnp.float32 if i == 2 else jdt)
                 for i, t in enumerate(arrays)]
    s = args[0].shape[1]

    @jax.jit
    def grads(args, dy):
        _, vjp = jax.vjp(lambda *xs: jref.ssd_scan_chunked(*xs, chunk=min(chunk, s)), *args)
        return vjp(dy)

    return [np.asarray(g, np.float32) for g in grads(args, dy)]


def torch_inputs(arrays, dtype):
    tdt = DTYPES[dtype][1]
    return [torch.from_numpy(t).to(torch.float32 if i == 2 else tdt)
            for i, t in enumerate(arrays)]


def close(got, want, dtype, what=""):
    """``got`` (torch, in its input's type) within the elementwise and the
    relative tolerance of ``want`` (f32 numpy)."""
    atol, rel = TOL[dtype]
    g = got.float().numpy()
    np.testing.assert_allclose(g, want, atol=atol, rtol=atol, err_msg=what)
    norm = float(np.linalg.norm(want))
    assert float(np.linalg.norm(g - want)) <= rel * norm, (what, norm)


def autograd_grads(args, chunk):
    """The five gradients through ``ssd_scan``'s autograd Function."""
    leaves = [t.clone().requires_grad_(True) for t in args[:5]]
    y = ssd_scan(*leaves, chunk=chunk)
    assert y.grad_fn is not None and "SSDScan" in type(y.grad_fn).__name__
    return torch.autograd.grad(y, leaves, args[5])


@pytest.mark.parametrize("via", ["ssd_scan_bwd", "autograd"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SHAPES)
def test_gradients_match_jax_f32(b, s, h, p, n, chunk, via):
    arrays = inputs(b, s, h, p, n)
    want = jax_grads(arrays, "float32", chunk)
    args = torch_inputs(arrays, "float32")
    got = (ssd_scan_bwd(*args, chunk=chunk) if via == "ssd_scan_bwd"
           else autograd_grads(args, chunk))
    for name, g, w, t in zip(NAMES, got, want, args):
        assert g.dtype == t.dtype and g.shape == t.shape, name
        close(g, w, "float32", name)


@pytest.mark.parametrize("b,s,h,p,n,chunk", [SHAPES[1], SHAPES[4]])
def test_gradients_match_jax_bf16(b, s, h, p, n, chunk):
    arrays = inputs(b, s, h, p, n)
    want = jax_grads(arrays, "bfloat16", chunk)
    args = torch_inputs(arrays, "bfloat16")
    for name, g, w, t in zip(NAMES, autograd_grads(args, chunk), want, args):
        assert g.dtype == t.dtype, name
        close(g, w, "bfloat16", name)


def test_strided_b_and_c_take_their_gradients_through_one_tensor():
    """The model hands B and C as the two halves of one (b, s, 2n) tensor;
    their gradients land in that tensor's two halves."""
    b, s, h, p, n, chunk = 2, 128, 2, 16, 16, 64
    arrays = inputs(b, s, h, p, n)
    want = jax_grads(arrays, "float32", chunk)
    x, dt, a, bm, cm, dy = torch_inputs(arrays, "float32")
    bc = torch.cat([bm, cm], dim=-1).requires_grad_(True)
    assert not bc[..., :n].is_contiguous()
    y = ssd_scan(x, dt, a, bc[..., :n], bc[..., n:], chunk=chunk)
    (g,) = torch.autograd.grad(y, [bc], dy)
    close(g[..., :n], want[3], "float32", "B")
    close(g[..., n:], want[4], "float32", "C")


def test_overflowing_masked_exponents_give_finite_gradients():
    """dt·a large enough that cum_i - cum_j above the diagonal overflows
    exp in f32 (past 88.7; here up to ~190): the masked exponents are
    clamped before the exp, so every gradient is finite and equal to JAX's.
    (Much larger steps make the gradient of ``a`` a sum of large terms that
    cancel, which neither package keeps to 2e-4 in f32.)"""
    b, s, h, p, n, chunk = 1, 128, 2, 8, 8, 64
    arrays = inputs(b, s, h, p, n, dt_scale=2.0)
    x, dt, a = arrays[:3]
    cum = np.cumsum((dt * a)[:, :chunk], axis=1)
    assert float((cum[:, :1] - cum[:, -1:]).max()) > 100.0   # exp(>88) is inf in f32
    want = jax_grads(arrays, "float32", chunk)
    assert all(np.isfinite(w).all() for w in want)
    for name, g, w in zip(NAMES, autograd_grads(torch_inputs(arrays, "float32"), chunk), want):
        assert bool(torch.isfinite(g).all()), name
        close(g, w, "float32", name)


def sequential_f64(x, dt, a, bm, cm):
    """The exact recurrence in the inputs' type (f64 here), for
    ``gradcheck``'s finite differences."""
    state = torch.zeros(x.shape[0], x.shape[2], x.shape[3], bm.shape[-1], dtype=x.dtype)
    ys = []
    for t in range(x.shape[1]):
        decay = torch.exp(dt[:, t] * a)[..., None, None]
        upd = torch.einsum("bhp,bn->bhpn", x[:, t] * dt[:, t, :, None], bm[:, t])
        state = state * decay + upd
        ys.append(torch.einsum("bhpn,bn->bhp", state, cm[:, t]))
    return torch.stack(ys, dim=1)


class _Sequential(torch.autograd.Function):
    """The exact recurrence forward, ``ssd_scan_bwd`` backward."""

    @staticmethod
    def forward(ctx, x, dt, a, bm, cm, chunk):
        ctx.save_for_backward(x, dt, a, bm, cm)
        ctx.chunk = chunk
        return sequential_f64(x, dt, a, bm, cm)

    @staticmethod
    def backward(ctx, dy):
        return (*ssd_scan_bwd(*ctx.saved_tensors, dy, ctx.chunk), None)


def test_gradcheck_f64():
    """Three chunks of 4 positions: the closed-form VJP (computed in f64
    for f64 inputs) against finite differences of the exact recurrence."""
    args = [torch.from_numpy(t).double().requires_grad_(True)
            for t in inputs(1, 12, 2, 3, 4, seed=3)[:5]]
    assert torch.autograd.gradcheck(lambda *xs: _Sequential.apply(*xs, 4), args,
                                    eps=1e-6, atol=1e-7, rtol=1e-5)


@pytest.mark.parametrize("rows_cut,chunks_cut", [(True, False), (True, True)],
                         ids=["groups", "segments"])
def test_workspace_groups_and_segments_give_the_same_gradients(monkeypatch, rows_cut,
                                                               chunks_cut):
    """With ``WORKSPACE_BYTES`` cut so that rows go in groups of one and,
    for ``segments``, a row in segments of two chunks, the gradients are
    those of the uncut plan within f32 rounding."""
    b, s, h, p, n, chunk = 3, 256, 2, 16, 16, 32
    args = torch_inputs(inputs(b, s, h, p, n), "float32")
    whole = ssd_scan_bwd(*args, chunk=chunk)
    assert mod.bwd_plan(b, s, h, p, n, chunk) == (b, s // chunk)
    per_chunk = 4 * (h * mod.bwd_floats(p, n, chunk) + 4 * chunk * n + 2 * chunk * chunk)
    limit = per_chunk * (2 if chunks_cut else s // chunk)
    monkeypatch.setattr(mod, "WORKSPACE_BYTES", limit)
    plan = mod.bwd_plan(b, s, h, p, n, chunk)
    assert plan == ((1, 2) if chunks_cut else (1, s // chunk))
    for name, g, w in zip(NAMES, ssd_scan_bwd(*args, chunk=chunk), whole):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-5, msg=name)


def test_final_state_takes_no_gradient_and_no_grad_records_nothing():
    args = torch_inputs(inputs(1, 64, 2, 8, 8), "float32")
    leaves = [t.clone().requires_grad_(True) for t in args[:5]]
    y, h_final = ssd_scan(*leaves, chunk=32, return_state=True)
    assert y.requires_grad and not h_final.requires_grad
    with torch.no_grad():
        y0, h0 = ssd_scan(*leaves, chunk=32, return_state=True)
    assert y0.grad_fn is None
    assert torch.equal(y0, y.detach()) and torch.equal(h0, h_final)
    assert SSDScan.apply(*args[:5], 32)[0].grad_fn is None   # nothing requires grad
