"""The port's SSD chunked scan against the JAX package, on the CPU.

The port's two plain versions (``ref.ssd_scan_sequential``, the exact
recurrence, and ``ref.ssd_scan_chunked``, what a CPU tensor takes) are held
against ``repro.kernels.ref``'s, and the wrapper's CPU path against the
JAX Pallas kernel in interpret mode, over the shapes of
``tests/kernels/test_ssd_scan.py`` plus the reduced Mamba-2 configs' (s =
chunk = 20, 8 heads of 16, state 16) and mamba2-2.7b's head and state
widths at a short length. Tolerances are those of that file: 2e-4 in f32
(sums in another order) and 5e-2 in bf16 (one bf16 rounding of the output).
Inputs are made with numpy from a seed; bf16 inputs are the same f32 values
rounded to nearest even by each framework, so both packages see the same
bits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels import ssd_scan as jax_ssd_scan
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.ssd_scan import ssd_scan

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(atol=2e-4, rtol=2e-4), "bfloat16": dict(atol=5e-2, rtol=5e-2)}
SHAPES = [  # b, s, h, p, n, chunk
    (1, 64, 2, 16, 8, 16),
    (2, 128, 1, 32, 16, 32),
    (1, 96, 3, 8, 8, 32),     # a chunk count that is not a power of two
    (2, 20, 8, 16, 16, 64),   # the reduced configs: chunk = min(64, s) = 20
    (1, 128, 2, 64, 128, 64),  # mamba2-2.7b's head dim and state
]


def inputs(b, s, h, p, n, seed=7):
    """x, dt (softplus'd, scaled by 0.1), a (negative), B, C as f32 numpy,
    the distributions of ``tests/kernels/test_ssd_scan.py``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p))
    dt = np.logaddexp(rng.standard_normal((b, s, h)), 0.0) * 0.1
    a = -np.exp(rng.standard_normal(h) * 0.5)
    bm = rng.standard_normal((b, s, n)) / np.sqrt(n)
    cm = rng.standard_normal((b, s, n)) / np.sqrt(n)
    return [t.astype(np.float32) for t in (x, dt, a, bm, cm)]


def both(arrays, dtype):
    """The same inputs for JAX and for torch: x, dt, B, C in ``dtype``, a in
    f32."""
    jdt, tdt = DTYPES[dtype]
    j = [jnp.asarray(t, dtype=jnp.float32 if i == 2 else jdt) for i, t in enumerate(arrays)]
    t = [torch.from_numpy(v).to(torch.float32 if i == 2 else tdt)
         for i, v in enumerate(arrays)]
    return j, t


def close(got: torch.Tensor, expect, dtype, msg=""):
    assert got.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(expect, np.float32),
                               err_msg=msg, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SHAPES)
def test_plain_versions_match_reference(b, s, h, p, n, chunk, dtype):
    (jx, jdt, ja, jb, jc), (x, dt, a, bm, cm) = both(inputs(b, s, h, p, n), dtype)
    chunk = min(chunk, s)
    close(tref.ssd_scan_chunked(x, dt, a, bm, cm, chunk=chunk),
          jref.ssd_scan_chunked(jx, jdt, ja, jb, jc, chunk=chunk), dtype, "chunked")
    close(tref.ssd_scan_sequential(x, dt, a, bm, cm),
          jref.ssd_scan_sequential(jx, jdt, ja, jb, jc), dtype, "sequential")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SHAPES)
def test_wrapper_matches_pallas_interpret(b, s, h, p, n, chunk, dtype):
    (jx, jdt, ja, jb, jc), (x, dt, a, bm, cm) = both(inputs(b, s, h, p, n), dtype)
    expect = jax_ssd_scan(jx, jdt, ja, jb, jc, chunk=chunk, interpret=True)
    ops.reset_launches()
    close(ssd_scan(x, dt, a, bm, cm, chunk=chunk), expect, dtype)
    close(ops.ssd_scan(x, dt, a, bm, cm, chunk=chunk), expect, dtype)
    assert ops.launches["ssd_scan"] == 0


def test_chunked_matches_sequential():
    """The chunked closed form against the exact recurrence, on the port
    alone (``test_chunked_ref_matches_sequential_ref`` of the JAX tests)."""
    x, dt, a, bm, cm = map(torch.from_numpy, inputs(2, 128, 2, 16, 8, seed=0))
    torch.testing.assert_close(tref.ssd_scan_chunked(x, dt, a, bm, cm, chunk=32),
                               tref.ssd_scan_sequential(x, dt, a, bm, cm),
                               atol=2e-4, rtol=2e-4)


def test_state_carries_across_chunks():
    """A single impulse at t = 0 reaches the last chunk's outputs."""
    b, s, h, p, n = 1, 64, 1, 4, 4
    x = torch.zeros(b, s, h, p)
    x[0, 0] = 1.0
    dt = torch.full((b, s, h), 0.05)
    a = torch.tensor([-0.1])
    ones = torch.ones(b, s, n)
    y = ssd_scan(x, dt, a, ones, ones, chunk=16)
    assert float(y[0, -1].abs().sum()) > 0, "decayed state lost across chunks"
    torch.testing.assert_close(y, tref.ssd_scan_sequential(x, dt, a, ones, ones),
                               atol=1e-5, rtol=0)


def test_strided_b_and_c_views_match_contiguous():
    """The model hands B and C as the two halves of one (b, s, 2n) tensor."""
    x, dt, a, bm, cm = map(torch.from_numpy, inputs(2, 40, 3, 16, 8))
    bc = torch.cat([bm, cm], dim=-1)
    assert not bc[..., :8].is_contiguous()
    torch.testing.assert_close(ssd_scan(x, dt, a, bc[..., :8], bc[..., 8:], chunk=20),
                               ssd_scan(x, dt, a, bm, cm, chunk=20), atol=0, rtol=0)


def test_refuses_chunks_that_do_not_divide_the_sequence():
    x, dt, a, bm, cm = map(torch.from_numpy, inputs(1, 96, 2, 8, 8))
    with pytest.raises(ValueError, match="chunks"):
        ssd_scan(x, dt, a, bm, cm, chunk=64)
    with pytest.raises(ValueError, match="chunks"):
        tref.ssd_scan_chunked(x, dt, a, bm, cm, chunk=64)


def test_refuses_mixed_and_unsupported_dtypes():
    x, dt, a, bm, cm = map(torch.from_numpy, inputs(1, 32, 2, 8, 8))
    with pytest.raises(TypeError, match="share"):
        ssd_scan(x, dt.bfloat16(), a, bm, cm)
    with pytest.raises(TypeError, match="share"):
        ssd_scan(x.half(), dt.half(), a, bm.half(), cm.half())
    with pytest.raises(TypeError, match="a is"):
        ssd_scan(x, dt, a.bfloat16(), bm, cm)
    with pytest.raises(ValueError, match="do not fit"):
        ssd_scan(x, dt, a[:1], bm, cm)


@pytest.mark.parametrize("which", range(5))
def test_each_input_takes_its_gradient(which):
    """With only one input requiring grad, the scan records a graph and
    that input's gradient is ``jax.vjp``'s of the reference's chunked scan
    within 2e-4 (``tests/test_torch_ssd_grad.py`` holds all five at once);
    without grad mode it records nothing and gives the same output."""
    arrays = inputs(1, 64, 2, 8, 8)
    dy = np.random.default_rng(3).standard_normal((1, 64, 2, 8)).astype(np.float32)
    jargs, args = both(arrays, "float32")
    _, vjp = jax.vjp(lambda *xs: jref.ssd_scan_chunked(*xs, chunk=32), *jargs)
    want = vjp(jnp.asarray(dy))[which]
    args[which].requires_grad_(True)
    y = ssd_scan(*args, chunk=32)
    (got,) = torch.autograd.grad(y, [args[which]], torch.from_numpy(dy))
    close(got, want, "float32")
    with torch.no_grad():
        y0 = ssd_scan(*args, chunk=32)
    assert y0.grad_fn is None and torch.equal(y0, y.detach())
