"""The port's serving path against the JAX package, on the CPU.

Reduced stablelm-12b is overridden to grouped-query attention (8 query heads
over 2 kv heads: ``reduced()`` alone gives 4 over 4) and run in f32, so the
comparison checks the logic, not bf16 rounding. The JAX side runs under its
default XLA dispatch and under Pallas interpret mode (its flash-attention
and RMSNorm kernels), restored afterwards. Weights cross with
``convert.params_from_reference``; tokens are made with numpy from a seed.
Logits agree within 1e-4 (f32 products summed in another order by XLA and
by torch, over two layers; observed ~3e-6 at magnitudes ~4); greedy tokens
agree exactly. The forward also runs the other architectures, reduced the
same way: the hybrid and the MoE models (their aux loss within 1e-5), the
VLM frontend with seeded patch embeddings and the audio one.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as jm
import repro.serve as js
from repro import configs as jcfg
from repro.kernels import dispatch
from repro_torch import configs as tcfg
from repro_torch import convert
from repro_torch import models as tm
from repro_torch import serve as ts
from repro_torch.kernels import ops

ROOT = Path(__file__).resolve().parents[1]
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
GQA = dict(dtype="float32", n_heads=8, n_kv_heads=2)
B, PROMPT, NEW = 2, 12, 5


def configs(arch="stablelm-12b", **overrides):
    over = {**GQA, **overrides}
    return jcfg.get_config(arch).reduced(**over), tcfg.get_config(arch).reduced(**over)


def models(arch="stablelm-12b", **overrides):
    jc, tc = configs(arch, **overrides)
    jparams = jm.init_params(jc, jax.random.PRNGKey(0))
    tmodel = convert.params_from_reference(tc, jax.tree.map(np.asarray, jparams),
                                           device="cpu")
    return jc, jparams, tc, tmodel


def tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


@pytest.fixture(params=["xla", "interpret"])
def jax_impl(request):
    prev = dispatch.set_kernel_impl(request.param)
    try:
        yield request.param
    finally:
        dispatch.set_kernel_impl(prev)


def close(got: torch.Tensor, expect, msg=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(expect, np.float32),
                               err_msg=msg, **LOGIT_TOL)


def patch_embeds(cfg, batch=B, seed=4):
    """Seeded patch embeddings (batch, vlm_patches, d) for the ``vlm``
    frontend, else None."""
    if cfg.frontend != "vlm":
        return None
    return np.random.default_rng(seed).standard_normal(
        (batch, cfg.vlm_patches, cfg.d_model)).astype(np.float32)


def as_jax(a):
    return None if a is None else jnp.asarray(a)


def as_torch(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("arch", ["stablelm-12b", "gemma-7b", "llama3-405b",
                                  "jamba-v0.1-52b", "qwen2-moe-a2.7b", "arctic-480b",
                                  "llava-next-34b", "musicgen-large"])
def test_forward_matches_reference(arch, jax_impl):
    """The cache-less forward (the flash-attention path); gemma adds GeGLU,
    tied embeddings and an explicit head dim, llama3 a padded vocabulary;
    jamba Mamba-2 and attention layers with dense and MoE feed-forwards,
    qwen2-moe shared experts, arctic a dense residual beside its experts
    and padded heads (their aux loss too); llava prepends its projected
    patch embeddings, musicgen reads EnCodec tokens."""
    jc, jparams, tc, tmodel = models(arch)
    tok = tokens(jc, (B, PROMPT + NEW))
    patches = patch_embeds(jc)
    expect, expect_aux, _ = jm.forward(jc, jparams, jnp.asarray(tok),
                                       patch_embeds=as_jax(patches))
    got, aux, cache = tm.forward(tc, tmodel, torch.from_numpy(tok),
                                 patch_embeds=as_torch(patches))
    seq = PROMPT + NEW + (0 if patches is None else tc.vlm_patches)
    assert got.shape == (B, seq, tc.vocab_padded) and cache is None
    assert (float(aux) > 0.0) == any(mlp == "moe" for _, mlp in tc.pattern)
    np.testing.assert_allclose(float(aux), float(expect_aux), rtol=1e-5)
    close(got, expect)


def test_vlm_prefill_with_patches_matches_reference(jax_impl):
    """llava's prompt carries its patch embeddings: the prefill step (patches
    projected by the adapter, then the tokens) and the decode steps after
    it, whose positions count the patches, against the reference's; and
    ``greedy_generate(patch_embeds=)``'s tokens."""
    jc, jparams, tc, tmodel = models("llava-next-34b")
    patches = patch_embeds(jc)
    n = jc.vlm_patches
    tok = tokens(jc, (B, PROMPT + NEW))
    jcache = jm.make_cache(jc, B, n + PROMPT + NEW)
    tcache = tm.make_cache(tc, B, n + PROMPT + NEW, device="cpu")
    expect, jcache = js.make_prefill_step(jc)(jparams, jnp.asarray(tok[:, :PROMPT]), jcache,
                                              patch_embeds=jnp.asarray(patches))
    got, tcache = ts.make_prefill_step(tc)(tmodel, torch.from_numpy(tok[:, :PROMPT]), tcache,
                                           patch_embeds=torch.from_numpy(patches))
    close(got, expect, "prefill with patches")
    for t in range(PROMPT, PROMPT + NEW):
        expect, jcache = jm.decode_step(jc, jparams, jnp.asarray(tok[:, t]), jcache,
                                        jnp.int32(n + t))
        got, tcache = tm.decode_step(tc, tmodel, torch.from_numpy(tok[:, t]), tcache, n + t)
        close(got, expect, f"decode step {t}")
    # greedy generation after the patches, against the reference's prefill
    # and decode steps with the argmax fed back
    jcache = jm.make_cache(jc, B, n + PROMPT + NEW)
    logits, jcache = jm.prefill(jc, jparams, jnp.asarray(tok[:, :PROMPT]), jcache,
                                patch_embeds=jnp.asarray(patches))
    want = [jnp.argmax(logits[..., :jc.vocab_size], axis=-1)]
    for i in range(NEW - 1):
        logits, jcache = jm.decode_step(jc, jparams, want[-1], jcache,
                                        jnp.int32(n + PROMPT + i))
        want.append(jnp.argmax(logits[..., :jc.vocab_size], axis=-1))
    got = ts.greedy_generate(tc, tmodel, torch.from_numpy(tok[:, :PROMPT]), NEW, "cpu",
                             patch_embeds=torch.from_numpy(patches))
    np.testing.assert_array_equal(got.numpy(), np.stack([np.asarray(w) for w in want], 1))
    with pytest.raises(ValueError, match="no patch"):
        _, mc = configs("musicgen-large")
        music = tm.init_params(mc, torch.Generator().manual_seed(0), device="cpu")
        tm.forward(mc, music, torch.from_numpy(tokens(mc, (B, PROMPT))),
                   patch_embeds=torch.zeros(B, 2, mc.d_model))


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "qwen2-moe-a2.7b", "arctic-480b",
                                  "llava-next-34b", "musicgen-large"])
def test_count_params_analytic_equals_the_built_model(arch):
    """The formula counts every tensor the port builds (the MoE router,
    experts, shared and dense MLPs, the patch adapter), as the reference's
    formula counts the reference's."""
    jc, tc = configs(arch)
    model = tm.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    built = sum(p.numel() for p in model.parameters())
    assert built == tm.count_params_analytic(tc) == jm.count_params_analytic(jc)
    jparams = jm.init_params(jc, jax.random.PRNGKey(0))
    assert built == sum(a.size for a in jax.tree.leaves(jparams))


def test_prefill_and_decode_match_reference(jax_impl):
    jc, jparams, tc, tmodel = models()
    tok = tokens(jc, (B, PROMPT + NEW))
    jcache = jm.make_cache(jc, B, PROMPT + NEW)
    tcache = tm.make_cache(tc, B, PROMPT + NEW, device="cpu")
    expect, jcache = jm.prefill(jc, jparams, jnp.asarray(tok[:, :PROMPT]), jcache)
    got, tcache = tm.prefill(tc, tmodel, torch.from_numpy(tok[:, :PROMPT]), tcache)
    close(got, expect, "prefill")
    for t in range(PROMPT, PROMPT + NEW):
        expect, jcache = jm.decode_step(jc, jparams, jnp.asarray(tok[:, t]), jcache,
                                        jnp.int32(t))
        got, tcache = tm.decode_step(tc, tmodel, torch.from_numpy(tok[:, t]), tcache, t)
        close(got, expect, f"decode step {t}")
    for layer in range(tc.n_layers):  # the caches hold the same k/v
        for name in ("k", "v"):
            np.testing.assert_allclose(tcache[layer][name].numpy(),
                                       np.asarray(jcache["sub0"][name][layer]),
                                       **LOGIT_TOL)


def test_greedy_generate_matches_reference(jax_impl):
    jc, jparams, tc, tmodel = models()
    prompt = tokens(jc, (B, PROMPT), seed=3)
    expect = js.greedy_generate(jc, jparams, jnp.asarray(prompt), NEW)
    got = ts.greedy_generate(tc, tmodel, torch.from_numpy(prompt), NEW, device="cpu")
    assert got.shape == (B, NEW)
    np.testing.assert_array_equal(got.numpy(), np.asarray(expect))


def test_prefill_plus_decode_matches_own_forward():
    """Mirrors ``tests/models/test_decode.py`` on the port: prefill and
    teacher-forced decode against the cache-less forward, 2e-2 as there."""
    _, tc = configs()
    tmodel = tm.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    tok = torch.from_numpy(tokens(tc, (B, PROMPT + NEW)))
    full, _, _ = tm.forward(tc, tmodel, tok)
    cache = tm.make_cache(tc, B, PROMPT + NEW, device="cpu")
    last, cache = ts.make_prefill_step(tc)(tmodel, tok[:, :PROMPT], cache)
    torch.testing.assert_close(last, full[:, PROMPT - 1], atol=2e-2, rtol=2e-2)
    step = ts.make_decode_step(tc)
    for t in range(PROMPT, PROMPT + NEW):
        logits, cache = step(tmodel, tok[:, t], cache, t)
        torch.testing.assert_close(logits, full[:, t], atol=2e-2, rtol=2e-2,
                                   msg=f"decode step {t} diverged from forward")


def test_serving_on_cpu_launches_no_kernel():
    _, tc = configs()
    tmodel = tm.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    ops.reset_launches()
    ts.greedy_generate(tc, tmodel, torch.zeros(B, PROMPT, dtype=torch.int64), NEW,
                       device="cpu")
    assert ops.launches == dict.fromkeys(ops.KERNELS, 0)


def test_bf16_model_runs_and_keeps_its_dtype():
    _, tc = configs(dtype="bfloat16")
    tmodel = tm.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    logits, _, _ = tm.forward(tc, tmodel, torch.from_numpy(tokens(tc, (B, PROMPT))))
    assert logits.dtype == torch.bfloat16
    assert torch.isfinite(logits.float()).all()


def test_serve_cli_runs_on_cpu():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "stablelm-12b",
         "--reduced", "--batch", "2", "--prompt-len", "8", "--max-new", "4",
         "--device", "cpu"],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "generated 8 tokens" in res.stdout
