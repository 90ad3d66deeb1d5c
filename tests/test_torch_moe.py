"""The port's MoE layers, and the models built on them, against the JAX
package on the CPU.

Weights cross with ``convert.params_from_reference``; inputs and tokens are
made with numpy from a seed. The MoE layer (``layers.moe_forward``: top-k
routing, capacity, the stable sort, the drop bin, the f32 combine, the
shared and dense MLPs, the aux loss) is held against
``repro.models.layers.moe_forward`` at reduced qwen2-moe-a2.7b (4 shared
experts' MLP) and arctic-480b (the dense residual), in f32 within the
kernel tests' f32 tolerance scaled to the layer (1e-5) and in bf16 within
3e-2 (one bf16 rounding of the experts' products apart), drop-free and at
the configs' capacity factor 1.25, where tokens are dropped. The models
(reduced qwen2-moe-a2.7b, jamba-v0.1-52b, arctic-480b) are held in f32
within the serving tests' 1e-4: the forward, ``lm_loss`` with its aux
term, and prefill plus decode call for call at 1.25 (each call drops what
its own token count drops); prefill plus teacher-forced decode against the
port's own forward at 16.0 (drop-free) within 2e-2, as
``tests/models/test_decode.py``. Padded experts mirror
``tests/models/test_moe_padding.py``.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as jm
import repro.models.layers as jl
import repro.serve as js
import repro.train as jt
from repro import configs as jcfg
from repro_torch import configs as tcfg
from repro_torch import convert
from repro_torch import models as tm
from repro_torch import serve as ts
from repro_torch.models import layers as tl

LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
LAYER_TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=3e-2, rtol=3e-2)}
MOE_ARCHS = ["qwen2-moe-a2.7b", "jamba-v0.1-52b", "arctic-480b"]
B, PROMPT, NEW = 2, 12, 5


def configs(arch, **over):
    over = {"dtype": "float32", **over}
    return jcfg.get_config(arch).reduced(**over), tcfg.get_config(arch).reduced(**over)


def models(arch, **over):
    jc, tc = configs(arch, **over)
    jparams = jm.init_params(jc, jax.random.PRNGKey(0))
    tmodel = convert.params_from_reference(tc, jax.tree.map(np.asarray, jparams),
                                           device="cpu")
    return jc, jparams, tc, tmodel


def tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def first_moe(cfg):
    """(group, sub-layer, layer) of the first MoE layer."""
    n = next(i for i, (_, mlp) in enumerate(tm.transformer.layer_kinds(cfg))
             if mlp == "moe")
    return (*divmod(n, len(cfg.pattern)), n)


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("capacity", [16.0, 1.25], ids=["drop_free", "dropping"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "arctic-480b"])
def test_moe_layer_matches_reference(arch, dtype, capacity):
    jc, jparams, tc, tmodel = models(arch, dtype=dtype, moe_capacity_factor=capacity)
    g, i, n = first_moe(tc)
    jp = jax.tree.map(lambda a: a[g], jparams["blocks"][f"sub{i}"]["ffn"])
    tp = tmodel.layers[n].ffn
    assert (tp.shared is not None) == bool(tc.moe_shared_experts)
    assert (tp.dense is not None) == tc.moe_dense_residual
    x = np.random.default_rng(2).standard_normal((2, 16, tc.d_model)).astype(np.float32)
    want_y, want_aux = jl.moe_forward(jc, jp, jnp.asarray(x, dtype=jc.dtype), jc.mlp_kind)
    stats = {}
    got_y, got_aux = tl.moe_forward(tc, tp, torch.from_numpy(x).to(getattr(torch, dtype)),
                                    tc.mlp_kind, stats)
    assert got_y.dtype == getattr(torch, dtype) and got_aux.dtype == torch.float32
    np.testing.assert_allclose(got_y.float().numpy(), np.asarray(want_y, np.float32),
                               **LAYER_TOL[dtype])
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-5)
    assert stats["routed"] == 2 * 16 * tc.moe_top_k
    if capacity == 16.0:
        assert stats["dropped"] == 0
    else:   # cap = ceil(32 * 2 * 1.25 / 8) = 10 slots an expert: some overflow
        assert tl.moe_capacity(tc, 32) == 10
        assert stats["dropped"] > 0


def test_capacity_is_per_call():
    """ceil(T·k·factor / E): a served decode step of 4 tokens has one slot
    an expert, a 4 x 512-token prefill 171 (qwen2-moe) and 320 (jamba); the
    drop-free factor 16.0 gives 5 a step."""
    qwen, jamba = (tcfg.get_config(a) for a in ("qwen2-moe-a2.7b", "jamba-v0.1-52b"))
    assert tl.moe_capacity(qwen, 4) == tl.moe_capacity(jamba, 4) == 1
    assert tl.moe_capacity(qwen, 2048) == 171 and tl.moe_capacity(jamba, 2048) == 320
    assert tl.moe_capacity(dataclasses.replace(qwen, moe_capacity_factor=16.0), 4) == 5
    _, small = configs("qwen2-moe-a2.7b")
    assert tl.moe_capacity(small, B) == 1 and tl.moe_capacity(small, 2048) == 640


def test_padded_experts_never_routed_and_change_nothing():
    """Mirrors ``tests/models/test_moe_padding.py``: the padded experts'
    weights are zero, and even given random weights they change no logit
    (the router never picks them), within 2e-5 of the unpadded model."""
    _, cfg0 = configs("qwen2-moe-a2.7b", moe_experts=6, moe_capacity_factor=16.0)
    cfg1 = dataclasses.replace(cfg0, pad_experts_to=8)
    padded = tm.init_params(cfg1, torch.Generator().manual_seed(0), device="cpu")
    stripped = copy.deepcopy(padded)
    for layer in padded.layers:
        assert layer.ffn.router.shape[-1] == 8
        assert not layer.ffn.w_in[6:].any() and not layer.ffn.w_out[6:].any()
        layer.ffn.w_in[6:] = torch.randn_like(layer.ffn.w_in[6:])
        layer.ffn.w_out[6:] = torch.randn_like(layer.ffn.w_out[6:])
    for layer in stripped.layers:
        f = layer.ffn
        f.router, f.w_in, f.w_out = (tl.weight(w.clone()) for w in
                                     (f.router[:, :6], f.w_in[:6], f.w_out[:6]))
    tok = torch.from_numpy(tokens(cfg0, (2, 16)))
    with torch.no_grad():
        a = tm.forward(cfg0, stripped, tok)[0]
        b = tm.forward(cfg1, padded, tok)[0]
    torch.testing.assert_close(a, b, atol=2e-5, rtol=2e-5)


def test_padded_model_matches_reference():
    jc, jparams, tc, tmodel = models("qwen2-moe-a2.7b", moe_experts=6, pad_experts_to=8)
    tok = tokens(jc, (B, PROMPT))
    want, want_aux, _ = jm.forward(jc, jparams, jnp.asarray(tok))
    with torch.no_grad():
        got, aux, _ = tm.forward(tc, tmodel, torch.from_numpy(tok))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_and_lm_loss_match_reference(arch):
    jc, jparams, tc, tmodel = models(arch)
    tok = tokens(jc, (B, PROMPT + NEW))
    labels = np.where(np.arange(PROMPT + NEW) < 3, -1, tokens(jc, (B, PROMPT + NEW), 2))
    want, want_aux, _ = jm.forward(jc, jparams, jnp.asarray(tok))
    want_loss, want_parts = jm.lm_loss(jc, jparams, dict(tokens=jnp.asarray(tok),
                                                          labels=jnp.asarray(labels)))
    with torch.no_grad():
        got, aux, _ = tm.forward(tc, tmodel, torch.from_numpy(tok))
        loss, parts = tm.lm_loss(tc, tmodel, dict(tokens=torch.from_numpy(tok),
                                                   labels=torch.from_numpy(labels)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    assert float(aux) > 0.0
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    np.testing.assert_allclose(float(parts["moe_aux"]), float(want_parts["moe_aux"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(float(parts["nll"]), float(want_parts["nll"]), rtol=1e-5)


@pytest.mark.parametrize("policy", tm.REMAT_POLICIES)
def test_every_remat_policy_gives_the_same_aux(policy):
    """Under grad each layer runs in its checkpoint regions; the logits and
    the summed aux loss are those of the forward without a graph."""
    _, tc = configs("qwen2-moe-a2.7b", remat_policy=policy)
    model = tm.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    tok = torch.from_numpy(tokens(tc, (B, PROMPT)))
    with torch.no_grad():
        want, want_aux, _ = tm.forward(tc, model, tok)
    model.requires_grad_(True)
    got, aux, _ = tm.forward(tc, model, tok)
    assert aux.requires_grad
    torch.testing.assert_close(got.detach(), want, atol=0, rtol=0)
    assert float(aux.detach()) == float(want_aux) > 0.0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_and_decode_match_reference_with_drops(arch):
    """At the configs' capacity factor 1.25 each call drops what its own
    token count drops (a decode step of 2 tokens has 1 slot an expert):
    the port's prefill and every decode step against the reference's, call
    for call."""
    jc, jparams, tc, tmodel = models(arch)
    tok = tokens(jc, (B, PROMPT + NEW))
    jcache = jm.make_cache(jc, B, PROMPT + NEW)
    tcache = tm.make_cache(tc, B, PROMPT + NEW, device="cpu")
    stats = {}
    expect, jcache = jm.prefill(jc, jparams, jnp.asarray(tok[:, :PROMPT]), jcache)
    with torch.no_grad():
        got, tcache = tm.prefill(tc, tmodel, torch.from_numpy(tok[:, :PROMPT]), tcache,
                                 moe_stats=stats)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), err_msg="prefill",
                               **LOGIT_TOL)
    for t in range(PROMPT, PROMPT + NEW):
        expect, jcache = jm.decode_step(jc, jparams, jnp.asarray(tok[:, t]), jcache,
                                        jnp.int32(t))
        with torch.no_grad():
            got, tcache = tm.decode_step(tc, tmodel, torch.from_numpy(tok[:, t]), tcache,
                                         t, moe_stats=stats)
        np.testing.assert_allclose(got.numpy(), np.asarray(expect),
                                   err_msg=f"decode step {t}", **LOGIT_TOL)
    assert stats["dropped"] > 0


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "jamba-v0.1-52b"])
def test_greedy_generate_matches_reference(arch):
    jc, jparams, tc, tmodel = models(arch)
    prompt = tokens(jc, (B, PROMPT), seed=3)
    expect = js.greedy_generate(jc, jparams, jnp.asarray(prompt), NEW)
    got = ts.greedy_generate(tc, tmodel, torch.from_numpy(prompt), NEW, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(expect))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_plus_decode_matches_own_forward_drop_free(arch):
    _, tc = configs(arch, moe_capacity_factor=16.0)
    model = tm.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    tok = torch.from_numpy(tokens(tc, (B, PROMPT + NEW)))
    stats = {}
    with torch.no_grad():
        full, _, _ = tm.forward(tc, model, tok, moe_stats=stats)
        cache = tm.make_cache(tc, B, PROMPT + NEW, device="cpu")
        last, cache = ts.make_prefill_step(tc)(model, tok[:, :PROMPT], cache)
        torch.testing.assert_close(last, full[:, PROMPT - 1], atol=2e-2, rtol=2e-2)
        step = ts.make_decode_step(tc)
        for t in range(PROMPT, PROMPT + NEW):
            logits, cache = step(model, tok[:, t], cache, t)
            torch.testing.assert_close(logits, full[:, t], atol=2e-2, rtol=2e-2,
                                       msg=f"decode step {t} diverged from forward")
    assert stats["dropped"] == 0 and stats["routed"] > 0


# ---------------------------------------------------------------------------
# weights and train state across
# ---------------------------------------------------------------------------

def _bits(a):
    """An array's or tensor's values as unsigned integers of its width."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        a = a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
    return a.view({2: np.uint16, 4: np.uint32, 8: np.uint64}[a.dtype.itemsize])


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_weights_and_moments_cross_bit_for_bit(arch):
    jc, tc = configs(arch, dtype="bfloat16")
    state = jt.init_train_state(jc, jm.init_params(jc, jax.random.PRNGKey(0)))
    state = jax.tree.map(np.asarray, state)
    # moments start at zero: give every moment tensor distinct seeded values,
    # so one carried to the wrong name of the same shape shows
    rng = np.random.default_rng(5)
    for mom in ("m", "v"):
        state["opt"][mom] = jax.tree.map(
            lambda a: rng.standard_normal(a.shape).astype(a.dtype), state["opt"][mom])
    state["opt"]["step"] = np.asarray(7, dtype=np.int32)
    port = convert.train_state_from_reference(tc, state, device="cpu")
    names = dict(port["params"].named_parameters())
    ref = convert.named_reference_arrays(tc, state["params"])
    assert set(names) == set(ref) == set(port["opt"]["m"]) == set(port["opt"]["v"])
    moe = [k for k in names if ".ffn.router" in k or ".ffn.w_" in k]
    assert moe and all(names[k].requires_grad for k in moe)
    for k, p in names.items():
        np.testing.assert_array_equal(_bits(p), _bits(ref[k]), err_msg=k)
    for mom in ("m", "v"):
        want = convert.named_reference_arrays(tc, state["opt"][mom])
        for k, got in port["opt"][mom].items():
            np.testing.assert_array_equal(_bits(got), _bits(want[k]), err_msg=f"{mom} {k}")
    assert int(port["opt"]["step"]) == 7
