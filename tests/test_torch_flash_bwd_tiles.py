"""The f32 flash backward's tile schedule, modelled in plain PyTorch on the
CPU.

``csrc/flash_attention.cu``'s ``flash_bwd_dq_kernel`` and
``flash_bwd_dkv_kernel`` walk tiles in an order and mask them by rules that
the card alone runs. This file holds a PyTorch f32 model of both kernels'
loops at their real block sizes (restated below from the source): which
(query tile, kv tile) pairs each block visits, the causal start of each kv
block, which tiles compute the mask (diagonal and ragged only; every other
tile relies on lse = +inf for a padded query row), dk/dv's flat loop over
its kv head's query heads, dq's longest-first order, and the base-2
exponent with lse converted once a row. The model is held three ways:
against the port's plain backward ``ref.attention_bwd`` within 2e-4 and
1e-4 of ||want||; against ``jax.grad`` of the JAX package's
``flash_attention`` custom VJP with its Pallas kernels in interpret mode,
as ``tests/test_torch_flash_bwd.py`` runs it, within 2e-4; and by counting
that each causal (query, key) pair of each query head is computed exactly
once for dq and exactly once for dk/dv. The card holds the kernels
themselves against the plain backward in ``tests/test_torch_cuda.py``.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels import ref

TOL = dict(atol=2e-4, rtol=2e-4)
REL_TOL = 1e-4
LOG2E = 1.4426950408889634
BK = BQ = 64   # kv rows of a dq tile; query rows of a dk/dv tile


def padded_dim(d):
    """The kernels' head dim: d up to a multiple of 16 below 128, then 160, 256."""
    return (d + 15) // 16 * 16 if d <= 128 else (160 if d <= 160 else 256)


def dq_rows(dp):
    """Query rows of a dq block (256 threads up to 112, 128 above)."""
    return 128 if dp <= 112 else 64


def dkv_rows(dp):
    """kv rows of a dk/dv block."""
    return 64 if dp <= 160 else 32


def rows(t, r0, n, dp):
    """Rows [r0, r0 + n) of (..., s, d) zero-padded past s and to dp columns,
    as the kernels' tiles hold them."""
    out = t.new_zeros((*t.shape[:-2], n, dp))
    part = t[..., r0:r0 + n, :]
    out[..., :part.shape[-2], :t.shape[-1]] = part
    return out


def allowed(sq, sk, causal):
    """(sq, sk) pairs the forward attends: col <= row from the top left."""
    if not causal:
        return torch.ones(sq, sk, dtype=torch.int64)
    return (torch.arange(sk)[None, :] <= torch.arange(sq)[:, None]).to(torch.int64)


def dq_model(q, k, v, do, lse, delta, causal, scale):
    """dq as the kernel computes it, the order its blocks start in (q0 by
    blockIdx.y) with their kv tile counts, and the count of every (head,
    query, key) pair it computed."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    dp = padded_dim(d)
    bm = dq_rows(dp)
    group = hq // hkv
    nq = -(-sq // bm)
    kx, vx = (t.repeat_interleave(group, dim=1) for t in (k, v))  # head h reads h / group
    dq = q.new_zeros((b, hq, nq * bm, dp))
    counts = torch.zeros((b, hq, sq, sk), dtype=torch.int64)
    order = []
    for y in range(nq):
        q0 = (nq - 1 - y) * bm                      # the longest causal rows first
        kend = min(sk, q0 + bm) if causal else sk
        order.append((q0, -(-kend // BK)))
        qr = q0 + torch.arange(bm)
        Q, dO = rows(q, q0, bm, dp), rows(do, q0, bm, dp)
        inside = qr < sq
        lse2 = torch.where(inside, rows(lse[..., None], q0, bm, 1)[..., 0] * LOG2E, math.inf)
        dl = rows(delta[..., None], q0, bm, 1)[..., 0]
        acc = q.new_zeros((b, hq, bm, dp))
        for k0 in range(0, kend, BK):
            K, V = rows(kx, k0, BK, dp), rows(vx, k0, BK, dp)
            dP = dO @ V.transpose(-1, -2)
            S = Q @ K.transpose(-1, -2)
            p = torch.exp2(S * (scale * LOG2E) - lse2[..., None])
            kc = k0 + torch.arange(BK)
            keep = torch.ones(bm, BK, dtype=torch.bool)
            if k0 + BK > sk or (causal and k0 + BK - 1 > q0):   # ragged or diagonal
                keep = (kc[None, :] < sk) & (~torch.tensor(causal) | (kc[None, :] <= qr[:, None]))
            dS = torch.where(keep, p * (dP - dl[..., None]) * scale, 0.0)
            acc += dS @ K
            r, c = min(bm, sq - q0), min(BK, sk - k0)
            counts[..., q0:q0 + r, k0:k0 + c] += keep[:r, :c]
        dq[..., q0:q0 + bm, :] = acc
    return dq[..., :sq, :d], order, counts


def dkv_model(q, k, v, do, lse, delta, causal, scale):
    """dk, dv as the kernel computes them, each block's tile sequence (query
    head, q0), and the count of every (head, query, key) pair computed."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    dp = padded_dim(d)
    bkv = dkv_rows(dp)
    group = hq // hkv
    nk = -(-sk // bkv)
    dk, dv = (k.new_zeros((b, hkv, nk * bkv, dp)) for _ in range(2))
    counts = torch.zeros((b, hq, sq, sk), dtype=torch.int64)
    sequences = []
    for y in range(nk):
        k0 = y * bkv
        K, V = rows(k, k0, bkv, dp), rows(v, k0, bkv, dp)
        kr = k0 + torch.arange(bkv)
        qstart = (k0 // BQ) * BQ if causal else 0   # tiles above the block's first row see none of it
        ntq = -(-(sq - qstart) // BQ) if qstart < sq else 0
        acc_k, acc_v = torch.zeros_like(K), torch.zeros_like(V)
        seq = []
        for n in range(group * ntq):
            g, q0 = n // ntq, qstart + (n % ntq) * BQ
            heads = torch.arange(hkv) * group + g
            seq.append((g, q0))
            Q, dO = rows(q[:, heads], q0, BQ, dp), rows(do[:, heads], q0, BQ, dp)
            qc = q0 + torch.arange(BQ)
            L = rows(lse[:, heads, :, None], q0, BQ, 1)[..., 0]    # zeros past sq, as copied
            D = rows(delta[:, heads, :, None], q0, BQ, 1)[..., 0]
            St = K @ Q.transpose(-1, -2)
            P = torch.exp2(St * (scale * LOG2E) - L[..., None, :] * LOG2E)
            keep = torch.ones(bkv, BQ, dtype=torch.bool)
            if q0 + BQ > sq or (causal and k0 + bkv - 1 > q0):    # ragged or diagonal
                keep = (qc[None, :] < sq) & (~torch.tensor(causal) | (kr[:, None] <= qc[None, :]))
            P = torch.where(keep, P, 0.0)
            dSt = P * (V @ dO.transpose(-1, -2) - D[..., None, :]) * scale
            acc_v += P @ dO
            acc_k += dSt @ Q
            r, c = min(BQ, sq - q0), min(bkv, sk - k0)
            counts[:, heads, q0:q0 + r, k0:k0 + c] += keep[:c, :r].T
        dk[..., k0:k0 + bkv, :], dv[..., k0:k0 + bkv, :] = acc_k, acc_v
        sequences.append((k0, qstart, seq))
    return dk[..., :sk, :d], dv[..., :sk, :d], sequences, counts


# Tile edges at 63/64/65, 127/128/129 (the 128-row dq blocks) and 257;
# sq != sk both ways; GQA 4/1 and 8/2; head dims on and between the padded
# widths (16, 80, 100 -> 112, 160, 256 with its 32-row dk/dv blocks).
CASES = [  # b, hq, hkv, sq, sk, d, causal
    (1, 4, 1, 63, 63, 80, True),
    (1, 4, 1, 64, 64, 16, True),
    (1, 8, 2, 65, 65, 100, True),
    (1, 4, 1, 127, 127, 160, True),
    (1, 8, 2, 128, 128, 256, True),
    (1, 4, 1, 129, 129, 80, True),
    (1, 8, 2, 257, 257, 80, True),
    (2, 4, 1, 257, 257, 160, False),
    (1, 8, 2, 65, 129, 256, True),     # causal, sq < sk
    (1, 4, 1, 257, 63, 100, True),     # causal, sq > sk
    (1, 8, 2, 129, 65, 16, False),     # ragged
    (1, 4, 1, 63, 257, 80, False),
    (1, 4, 1, 128, 129, 160, True),
    (1, 8, 2, 257, 129, 256, True),
]
PALLAS_CASES = [CASES[i] for i in (2, 5, 8, 9, 12)]


def inputs(b, hq, hkv, sq, sk, d, causal, seed=5):
    """q, k, v, do (do = d sum(o·cos o) / do, the JAX gradient test's loss),
    and the forward's o and lse from the plain version."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))
    o, lse = ref.attention_with_lse(q, k, v, causal=causal, scale=1.0 / d**0.5)
    do = torch.cos(o) - o * torch.sin(o)
    return q, k, v, do, o, lse


def model(q, k, v, do, o, lse, causal):
    scale = 1.0 / q.shape[-1] ** 0.5
    delta = (do * o).sum(-1)
    dq, order, dq_counts = dq_model(q, k, v, do, lse, delta, causal, scale)
    dk, dv, sequences, dkv_counts = dkv_model(q, k, v, do, lse, delta, causal, scale)
    return (dq, dk, dv), order, sequences, dq_counts, dkv_counts


def hold(got, want, what):
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.shape == w.shape, (name, what)
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=f"{name} {what}", **TOL)
        assert float((g - w).norm()) <= REL_TOL * float(w.norm()), (name, what)


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal", CASES)
def test_tile_model_matches_plain_backward(b, hq, hkv, sq, sk, d, causal):
    q, k, v, do, o, lse = inputs(b, hq, hkv, sq, sk, d, causal)
    got, *_ = model(q, k, v, do, o, lse, causal)
    hold(got, ref.attention_bwd(q, k, v, o, lse, do, causal=causal, scale=1.0 / d**0.5),
         (b, hq, hkv, sq, sk, d, causal))


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal", CASES)
def test_every_causal_pair_is_computed_once(b, hq, hkv, sq, sk, d, causal):
    """Each (head, query, key) pair the forward attends is computed exactly
    once by dq's tiles and exactly once by dk/dv's, and no other pair is;
    dq's blocks start with the most kv tiles; each dk/dv block walks its
    group's heads in turn, every one over the same query tiles from the
    block's causal start."""
    q, k, v, do, o, lse = inputs(b, hq, hkv, sq, sk, d, causal)
    _, order, sequences, dq_counts, dkv_counts = model(q, k, v, do, o, lse, causal)
    want = allowed(sq, sk, causal).expand(b, hq, sq, sk)
    assert torch.equal(dq_counts, want)
    assert torch.equal(dkv_counts, want)
    tiles = [n for _, n in order]
    assert tiles == sorted(tiles, reverse=True) and [q0 for q0, _ in order] == sorted(
        (q0 for q0, _ in order), reverse=True)
    group = hq // hkv
    for k0, qstart, seq in sequences:
        # causal: the first query tile is the one that holds row k0
        assert qstart <= k0 < qstart + BQ if causal else qstart == 0
        per_head = [[q0 for g, q0 in seq if g == h] for h in range(group)]
        assert [g for g, _ in seq] == sorted(g for g, _ in seq)
        assert all(t == per_head[0] for t in per_head)
        assert per_head[0] == list(range(qstart, sq, BQ))


def test_keyless_rows_give_zero_dq_and_no_kv_block():
    """No key at all: every row's lse is +inf, dq is 0 and there is no dk/dv
    block to run."""
    b, hq, hkv, sq, sk, d = 1, 4, 2, 8, 0, 80
    q, k, v, do, o, lse = inputs(b, hq, hkv, sq, sk, d, True)
    assert torch.isposinf(lse).all()
    (dq, dk, dv), order, sequences, dq_counts, dkv_counts = model(q, k, v, do, o, lse, True)
    assert not dq.any() and dk.shape == k.shape and dv.shape == v.shape
    assert order == [(0, 0)] and sequences == []
    assert not dq_counts.any() and not dkv_counts.any()
    hold((dq, dk, dv), ref.attention_bwd(q, k, v, o, lse, do, causal=True, scale=1.0 / d**0.5),
         "keyless")


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal", PALLAS_CASES)
def test_tile_model_matches_pallas_interpret(b, hq, hkv, sq, sk, d, causal):
    """Against ``jax.grad`` of the reference's custom VJP, its Pallas
    kernels in interpret mode, on the loss sum(o·cos o)."""
    q, k, v, do, o, lse = inputs(b, hq, hkv, sq, sk, d, causal)

    def loss(q, k, v):
        out = jax_flash(q, k, v, causal, None, 64, 64, True)
        return jnp.sum(out * jnp.cos(out))

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(t.numpy()) for t in (q, k, v)))
    got, *_ = model(q, k, v, do, o, lse, causal)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)
