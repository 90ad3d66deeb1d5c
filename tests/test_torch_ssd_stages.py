"""The SSD scan's three stages and its final state, and the FILTER compare's
head / vector split, modelled in plain PyTorch on the CPU.

``csrc/ssd_scan.cu`` computes the chunked SSD as three kernels: chunk state,
state passing, chunk output. ``kernels/ref.py`` holds the same three stages
as plain functions; composed they must give today's ``ssd_scan_chunked``
bit for bit (a frozen copy of the unsplit version is kept here), and they
are held against the JAX package's ``ref.ssd_scan_chunked`` and its Pallas
kernel in interpret mode within 2e-4 (f32) and 5e-2 (bf16). The state after
the last chunk, which the model now takes as its decode state, is held
within 1e-4 of ||want|| against the JAX ``_ssm_state_after_prefill`` (the
whole-prefix sum), the exact recurrence's last state (numpy, f64) and the
port's f64 closed form. A PyTorch model of kernel 3's bf16 rounding (C·Bᵀ
⊙ decay ⊙ dt rounded once to bf16 against x; H rounded once to bf16 against
C) is held within the bf16 tolerances, 5e-2 elementwise and 1e-2 of
||want||, at shapes up to mamba2-2.7b's serving prefill.

The FILTER split (``dataplane.filter_head``) is a pure function of the
column's address and element size: it is checked at every byte offset in
0-15, and a model of the split (head rows one by one, 16-byte vectors, tail)
is held bitwise against the plain compare. Inputs are made with numpy from
a seed. The card runs the kernels in ``tests/test_torch_cuda.py``.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels import ssd_scan as jax_ssd_scan
from repro.models import layers as jl
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.mv import dataplane as dp

TOL = {torch.float32: dict(atol=2e-4, rtol=2e-4), torch.bfloat16: dict(atol=5e-2, rtol=5e-2)}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}   # of ||want||
STATE_REL_TOL = 1e-4
SHAPES = [  # b, s, h, p, n, chunk: 1, 2 and 9 chunks, s < 64, n = 16, p < 64
    (2, 64, 3, 16, 16, 64),
    (1, 128, 2, 32, 16, 64),
    (2, 576, 2, 64, 128, 64),   # the serving oracle's 512 + 64 positions
    (2, 20, 8, 16, 16, 64),     # the reduced configs: chunk = s = 20
    (1, 48, 3, 40, 100, 16),    # widths that are not powers of two
]


def inputs(b, s, h, p, n, seed=7):
    """x, dt (softplus'd, scaled by 0.1), a (negative), a_log with a =
    -exp(a_log), B and C as f32 numpy, the distributions of
    ``tests/kernels/test_ssd_scan.py``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p))
    dt = np.logaddexp(rng.standard_normal((b, s, h)), 0.0) * 0.1
    a_log = (rng.standard_normal(h) * 0.5).astype(np.float32)
    a = -np.exp(a_log)
    bm = rng.standard_normal((b, s, n)) / np.sqrt(n)
    cm = rng.standard_normal((b, s, n)) / np.sqrt(n)
    return [t.astype(np.float32) for t in (x, dt, a, bm, cm)] + [a_log]


def torch_inputs(arrays, dtype):
    """x, dt, B, C in ``dtype`` (bf16: rounded to nearest even), a in f32."""
    x, dt, a, bm, cm = (torch.from_numpy(t) for t in arrays[:5])
    return x.to(dtype), dt.to(dtype), a, bm.to(dtype), cm.to(dtype)


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm())


def unsplit_chunked(x, dt, a, bmat, cmat, chunk):
    """``ref.ssd_scan_chunked`` as it stood before its three stages were
    split out, kept verbatim as the bitwise yardstick of the split."""
    bsz, s, h, p = x.shape
    n = bmat.shape[-1]
    nc = s // chunk
    xf = x.float().reshape(bsz, nc, chunk, h, p)
    dtf = dt.float().reshape(bsz, nc, chunk, h)
    bf = bmat.float().reshape(bsz, nc, chunk, n)
    cf = cmat.float().reshape(bsz, nc, chunk, n)
    af = a.float()
    cum = torch.cumsum(dtf * af, dim=2)
    total = cum[:, :, -1, :]
    cum_h = cum.permute(0, 1, 3, 2)
    rel_ = cum_h[..., :, None] - cum_h[..., None, :]
    mask = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    decay = torch.where(mask, torch.exp(torch.where(mask, rel_, 0.0)), 0.0)
    cb = torch.einsum("bcin,bcjn->bcij", cf, bf)
    xdt = xf * dtf[..., None]
    xdt_h = xdt.permute(0, 1, 3, 2, 4)
    y_intra = torch.matmul(cb[:, :, None] * decay, xdt_h)
    w = torch.exp(total[:, :, :, None] - cum_h)
    state = torch.matmul((xdt_h * w[..., None]).transpose(-1, -2), bf[:, :, None])
    hstate = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    hpre = torch.empty_like(state)
    for c in range(nc):
        hpre[:, c] = hstate
        hstate = hstate * torch.exp(total[:, c])[..., None, None] + state[:, c]
    y_inter = torch.matmul(cf[:, :, None], hpre.transpose(-1, -2)) * torch.exp(cum_h)[..., None]
    y = (y_intra + y_inter).permute(0, 1, 3, 2, 4).reshape(bsz, s, h, p)
    return y.to(x.dtype)


def bf16_chunk_output(x, dt, bmat, cmat, cum, hpre):
    """Kernel 3's arithmetic for bf16 inputs: C·Bᵀ exact in f32; the
    intra-chunk operand P = (C·Bᵀ ⊙ exp(cum_i - cum_j) ⊙ dt_j)[j <= i]
    rounded once to bf16 and multiplied by x itself; H_{c-1} rounded once
    to bf16 and multiplied by C; f32 sums; y in bf16."""
    bsz, s, h, p = x.shape
    nc, chunk = cum.shape[1], cum.shape[2]
    n = bmat.shape[-1]
    xf = x.float().reshape(bsz, nc, chunk, h, p).permute(0, 1, 3, 2, 4)
    dtf = dt.float().reshape(bsz, nc, chunk, h).permute(0, 1, 3, 2)    # (b, nc, h, L)
    bf = bmat.float().reshape(bsz, nc, chunk, n)
    cf = cmat.float().reshape(bsz, nc, chunk, n)
    cum_h = cum.permute(0, 1, 3, 2)
    mask = torch.ones(chunk, chunk, dtype=torch.bool).tril()
    rel_ = cum_h[..., :, None] - cum_h[..., None, :]
    decay = torch.where(mask, torch.exp(torch.where(mask, rel_, 0.0)), 0.0)
    cb = torch.einsum("bcin,bcjn->bcij", cf, bf)
    pm = (cb[:, :, None] * decay * dtf[..., None, :]).bfloat16().float()
    y_intra = torch.matmul(pm, xf)
    hq = hpre.bfloat16().float()
    y_inter = torch.matmul(cf[:, :, None], hq.transpose(-1, -2)) * torch.exp(cum_h)[..., None]
    return (y_intra + y_inter).permute(0, 1, 3, 2, 4).reshape(bsz, s, h, p).bfloat16()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SHAPES)
def test_stages_compose_bitwise_to_the_unsplit_scan(b, s, h, p, n, chunk, dtype):
    x, dt, a, bm, cm = torch_inputs(inputs(b, s, h, p, n), dtype)
    chunk = min(chunk, s)
    cum, state = tref.ssd_chunk_state(x, dt, a, bm, chunk)
    hpre, h_final = tref.ssd_state_passing(state, cum[:, :, -1, :])
    y = tref.ssd_chunk_output(x, dt, bm, cm, cum, hpre).to(dtype)
    want = unsplit_chunked(x, dt, a, bm, cm, chunk)
    assert torch.equal(y, want)
    got, got_state = tref.ssd_scan_chunked(x, dt, a, bm, cm, chunk=chunk, return_state=True)
    assert torch.equal(got, want) and torch.equal(got_state, h_final)
    assert torch.equal(tssd.ssd_scan(x, dt, a, bm, cm, chunk=chunk), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SHAPES)
def test_stages_match_jax_chunked_and_pallas_interpret(b, s, h, p, n, chunk, dtype):
    arrays = inputs(b, s, h, p, n)
    x, dt, a, bm, cm = torch_inputs(arrays, dtype)
    j = [jnp.asarray(t, dtype=jnp.float32 if i == 2 else JNP[dtype])
         for i, t in enumerate(arrays[:5])]
    chunk = min(chunk, s)
    got = tref.ssd_scan_chunked(x, dt, a, bm, cm, chunk=chunk).float().numpy()
    for want in (jref.ssd_scan_chunked(*j, chunk=chunk),
                 jax_ssd_scan(*j, chunk=chunk, interpret=True)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32), **TOL[dtype])


def sequential_final_state(x, dt, a, bm):
    """The exact recurrence's last state, in numpy f64."""
    x, dt, bm = (np.asarray(t, np.float64) for t in (x, dt, bm))
    b, s, h, p = x.shape
    state = np.zeros((b, h, p, bm.shape[-1]))
    for t in range(s):
        decay = np.exp(dt[:, t] * a[None, :])
        state = state * decay[..., None, None] + np.einsum(
            "bhp,bn->bhpn", x[:, t] * dt[:, t, :, None], bm[:, t])
    return torch.from_numpy(state)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SHAPES)
def test_final_state_matches_the_reference_state_after_prefill(b, s, h, p, n, chunk, dtype):
    """The state after the last chunk, summed chunk by chunk, against the
    JAX ``_ssm_state_after_prefill`` (the whole-prefix sum in f32), the
    exact recurrence in f64 and the port's f64 closed form, within 1e-4 of
    ||want||, on the same (bf16-rounded) inputs."""
    arrays = inputs(b, s, h, p, n)
    x, dt, a, bm, cm = torch_inputs(arrays, dtype)
    _, got = tssd.ssd_scan(x, dt, a, bm, cm, chunk=min(chunk, s), return_state=True)
    assert got.dtype == torch.float32 and got.shape == (b, h, p, n)
    cfg = types.SimpleNamespace(ssm_conv_kernel=4)
    xr = jnp.zeros((b, s, h * p), jnp.float32)
    bc = jnp.zeros((b, s, 2 * n), jnp.float32)
    j = [jnp.asarray(t.float().numpy()) for t in (x, dt, bm, cm)]
    jax_state = jl._ssm_state_after_prefill(cfg, {"a_log": jnp.asarray(arrays[5])},
                                            j[0], j[1], j[2], j[3], xr, bc)["ssm"]
    wants = {"jax": torch.from_numpy(np.array(jax_state)),
             "sequential": sequential_final_state(x.float(), dt.float(), a.double().numpy(),
                                                  bm.float()),
             "closed form": tref.ssd_final_state(x, dt, a, bm)}
    for name, want in wants.items():
        assert rel(got, want) <= STATE_REL_TOL, (name, rel(got, want))


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    *SHAPES,
    (4, 512, 80, 64, 128, 64),   # mamba2-2.7b's serving prefill
])
def test_bf16_policy_of_the_chunk_output_kernel(b, s, h, p, n, chunk):
    """Kernel 3's two bf16 roundings stay within the bf16 tolerances of the
    plain f32 arithmetic: 5e-2 elementwise, 1e-2 of ||want||."""
    x, dt, a, bm, cm = torch_inputs(inputs(b, s, h, p, n, seed=11), torch.bfloat16)
    chunk = min(chunk, s)
    cum, state = tref.ssd_chunk_state(x, dt, a, bm, chunk)
    hpre, _ = tref.ssd_state_passing(state, cum[:, :, -1, :])
    got = bf16_chunk_output(x, dt, bm, cm, cum, hpre)
    want = tref.ssd_chunk_output(x, dt, bm, cm, cum, hpre).bfloat16()
    torch.testing.assert_close(got.float(), want.float(), **TOL[torch.bfloat16])
    assert rel(got, want) <= REL_TOL[torch.bfloat16]


def test_workspace_plan_stays_within_its_bound(monkeypatch):
    """Groups of batch rows, or segments of one row's chunks, keep the
    workspace at or under ``WORKSPACE_BYTES``; the long prefill's row fits
    whole, and so does the serving batch."""
    limit = tssd.WORKSPACE_BYTES
    cases = {  # (b, s, bf16): (group_rows, seg_chunks)
        (1, 32768, True): (1, 512),
        (32, 32768, True): (1, 512),
        (4, 512, True): (4, 8),
        (4, 512, False): (4, 8),
        (64, 4096, False): (12, 64),
        (2, 131072, True): (1, 543),   # a row in segments of 543 chunks
    }
    for (b, s, bf16), plan in cases.items():
        got = tssd.workspace_plan(b, s, 80, 64, 128, 64, bf16)
        assert got == plan, (b, s, bf16, got)
        rows, seg = got
        assert 4 * tssd.workspace_floats(rows * seg * 80, 64, 128, 64, bf16) <= limit
    # one row, one chunk when nothing fits
    monkeypatch.setattr(tssd, "WORKSPACE_BYTES", 1)
    assert tssd.workspace_plan(3, 256, 80, 64, 128, 64, False) == (1, 1)


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("offset", range(16))
def test_filter_head_split_at_every_byte_offset(itemsize, offset):
    """The head is the rows before the first 16-byte boundary; after it the
    vectors start on 16 bytes; a column off its element size, or with
    fewer rows after the head than a vector holds, takes the scalar
    kernel."""
    rows = 16 // itemsize
    addr = 4096 + offset
    for n in range(0, 3 * rows + 1):
        head = dp.filter_head(addr, itemsize, n)
        if offset % itemsize:
            assert head is None
            continue
        want = (16 - offset) % 16 // itemsize
        if n - want < rows:
            assert head is None, (n, head)
        else:
            assert head == want and (addr + head * itemsize) % 16 == 0
            assert 0 <= head < rows


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.int64])
@pytest.mark.parametrize("k", range(4))
def test_filter_split_model_matches_the_plain_compare(dtype, k):
    """The vector kernel's split of a view ``col[k:]`` (head rows compared
    one by one, 16-byte vectors of 4 or 2 rows, tail rows) gives the plain
    compare's mask bit for bit, NaN and +-inf rows included."""
    rng = np.random.default_rng(k)
    col = torch.from_numpy(rng.standard_normal(1003) * 100).to(dtype)
    if dtype.is_floating_point:
        col[5:8] = torch.tensor([float("nan"), float("inf"), -float("inf")], dtype=dtype)
    view = col[k:]
    n, size = len(view), view.element_size()
    head = dp.filter_head(view.data_ptr(), size, n)
    assert head is not None
    rows = 16 // size
    nv = (n - head) // rows
    parts = [dp._filter_plain(view[:head], 0.1),
             dp._filter_plain(view[head:head + nv * rows].reshape(nv, rows), 0.1).reshape(-1),
             dp._filter_plain(view[head + nv * rows:], 0.1)]
    assert torch.equal(torch.cat(parts), dp._filter_plain(view, 0.1))
    assert torch.equal(dp.filter_mask(view, 0.1), dp._filter_plain(view, 0.1))
