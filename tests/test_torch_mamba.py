"""The port's Mamba-2 serving path against the JAX package, on the CPU.

Reduced mamba2-2.7b (2 layers of ("ssm", None), d_model 64, d_inner 128, 8
SSD heads of 16, state 16, vocab 256) runs in f32, so the comparison checks
the logic, not bf16 rounding. The JAX side runs under its default XLA
dispatch and under Pallas interpret mode (its SSD scan and RMSNorm
kernels), restored afterwards. Weights cross with
``convert.params_from_reference``; tokens are made with numpy from a seed.
One mixer (``ssm_forward``: the forward, a prefill and decode steps) agrees
within 1e-4, as do the whole model's logits (f32 products summed in another
order by XLA and by torch); greedy tokens agree exactly; prefill plus
teacher-forced decode matches the cache-less forward within 2e-2, as
``tests/models/test_decode.py``.
"""
import dataclasses
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
from repro.models import layers as jl
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch import configs as tcfg
from repro_torch import convert
from repro_torch import models as tm
from repro_torch import serve as ts
from repro_torch.kernels import ops
from repro_torch.models import layers as tl
from repro_torch.train import optimizer as topt
from repro_torch.train import step as tstep

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-4, rtol=1e-4)
B, PROMPT, NEW = 2, 16, 4          # prompt: one chunk of 16; forward: one of 20
ARCH = "mamba2-2.7b"


def configs(**overrides):
    over = {"dtype": "float32", **overrides}
    return jcfg.get_config(ARCH).reduced(**over), tcfg.get_config(ARCH).reduced(**over)


def models(**overrides):
    jc, tc = configs(**overrides)
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
                               err_msg=msg, **TOL)


def mixer_pair(jc, tc, seed=0):
    """One Mamba-2 mixer's parameters in both packages, the same bits."""
    jp = jl.init_ssm(jc, jax.random.PRNGKey(seed))
    tp = tl.SSM(**{k: torch.from_numpy(np.array(v)) for k, v in jp.items()})
    return jp, tp


def test_ssm_mixer_matches_reference(jax_impl):
    """``ssm_forward`` without a cache, as a prefill with one, and as decode
    steps from that state: outputs and the conv and SSD states."""
    jc, tc = configs()
    jp, tp = mixer_pair(jc, tc)
    x = np.random.default_rng(2).standard_normal((B, PROMPT + NEW, jc.d_model))
    x = x.astype(np.float32)
    expect, none = jl.ssm_forward(jc, jp, jnp.asarray(x))
    got, empty = tl.ssm_forward(tc, tp, torch.from_numpy(x))
    assert none is None and empty is None
    close(got, expect, "forward")
    jcache = jl.make_ssm_cache(jc, B)
    tcache = tl.make_ssm_cache(tc, B, torch.device("cpu"))
    expect, jcache = jl.ssm_forward(jc, jp, jnp.asarray(x[:, :PROMPT]), cache=jcache)
    got, tcache = tl.ssm_forward(tc, tp, torch.from_numpy(x[:, :PROMPT]), cache=tcache)
    close(got, expect, "prefill")
    for t in range(PROMPT, PROMPT + NEW):
        expect, jcache = jl.ssm_forward(jc, jp, jnp.asarray(x[:, t:t + 1]), cache=jcache)
        got, tcache = tl.ssm_forward(tc, tp, torch.from_numpy(x[:, t:t + 1]), cache=tcache)
        close(got, expect, f"decode step {t}")
        for name in ("conv_x", "conv_bc", "ssm"):
            assert tcache[name].dtype == getattr(torch, str(jcache[name].dtype))
            close(tcache[name], jcache[name], f"{name} after step {t}")


def test_prefill_shorter_than_the_conv_pads_its_state():
    """A 2-token prompt leaves k - 1 = 3 conv inputs, the first zero."""
    jc, tc = configs()
    jp, tp = mixer_pair(jc, tc, seed=1)
    x = np.random.default_rng(3).standard_normal((B, 2, jc.d_model)).astype(np.float32)
    _, jcache = jl.ssm_forward(jc, jp, jnp.asarray(x), cache=jl.make_ssm_cache(jc, B))
    _, tcache = tl.ssm_forward(tc, tp, torch.from_numpy(x),
                               cache=tl.make_ssm_cache(tc, B, torch.device("cpu")))
    assert tcache["conv_x"].shape == (B, tc.ssm_conv_kernel - 1, tc.ssm_d_inner)
    assert not tcache["conv_x"][:, 0].any()
    for name in ("conv_x", "conv_bc", "ssm"):
        close(tcache[name], jcache[name], name)


def test_forward_matches_reference(jax_impl):
    jc, jparams, tc, tmodel = models()
    tok = tokens(jc, (B, PROMPT + NEW))
    expect, _, _ = jm.forward(jc, jparams, jnp.asarray(tok))
    got, aux, cache = tm.forward(tc, tmodel, torch.from_numpy(tok))
    assert got.shape == (B, PROMPT + NEW, tc.vocab_padded) and cache is None
    assert float(aux) == 0.0
    close(got, expect)


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
    for layer in range(tc.n_layers):  # the caches hold the same states
        for name in ("conv_x", "conv_bc", "ssm"):
            close(tcache[layer][name], jcache["sub0"][name][layer], f"{layer} {name}")


def test_greedy_generate_matches_reference(jax_impl):
    jc, jparams, tc, tmodel = models()
    prompt = tokens(jc, (B, PROMPT), seed=3)
    expect = js.greedy_generate(jc, jparams, jnp.asarray(prompt), NEW + 2)
    got = ts.greedy_generate(tc, tmodel, torch.from_numpy(prompt), NEW + 2, device="cpu")
    assert got.shape == (B, NEW + 2)
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


def test_model_weights_cross_bit_for_bit():
    """bf16 weights through ``params_from_reference``: every SSM tensor
    under its name, bit for bit, and no norm2/ffn on a layer without an
    MLP; the parameter count is the config's."""
    jc, tc = configs(dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jm.init_params(jc, jax.random.PRNGKey(4)))
    model = convert.params_from_reference(tc, tree, device="cpu")
    named = convert.named_reference_arrays(tc, tree)
    params = dict(model.named_parameters())
    assert set(params) == set(named)
    assert {f"layers.0.mixer.{k}" for k in tl.SSM_NAMES} <= set(params)
    assert not any(".norm2" in k or ".ffn." in k for k in params)
    for name, p in params.items():
        want = named[name]
        bits = want.view(np.uint16) if want.dtype.name == "bfloat16" else want
        got = p.detach().view(torch.int16).numpy().view(np.uint16) \
            if p.dtype == torch.bfloat16 else p.detach().numpy()
        np.testing.assert_array_equal(got, bits, err_msg=name)
    assert sum(p.numel() for p in model.parameters()) == tc.param_count()


def test_init_params_counts_and_caches():
    """The port's own init at the reference's scales: the config's count,
    the JAX package's fixed a_log, d_skip, dt_bias; a cache entry per
    layer of the reference's shapes and types."""
    _, tc = configs(dtype="bfloat16")
    model = tm.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    assert sum(p.numel() for p in model.parameters()) == tc.param_count()
    mixer = model.layers[0].mixer
    assert isinstance(mixer, tl.SSM) and model.layers[0].ffn is None
    assert mixer.a_log.dtype == torch.float32 and mixer.w_z.dtype == torch.bfloat16
    torch.testing.assert_close(mixer.a_log, torch.log(torch.linspace(1.0, 8.0, tc.ssm_heads)))
    cache = tm.make_cache(tc, 3, 10, device="cpu")
    jc = jcfg.get_config(ARCH).reduced(dtype="bfloat16")
    want = jl.make_ssm_cache(jc, 3)
    assert len(cache) == tc.n_layers
    for name, arr in want.items():
        assert tuple(cache[0][name].shape) == arr.shape
        assert cache[0][name].dtype == getattr(torch, str(arr.dtype))


def test_bf16_model_serves_and_keeps_its_dtype():
    _, tc = configs(dtype="bfloat16")
    tmodel = tm.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    logits, _, _ = tm.forward(tc, tmodel, torch.from_numpy(tokens(tc, (B, PROMPT))))
    assert logits.dtype == torch.bfloat16 and torch.isfinite(logits.float()).all()
    out = ts.greedy_generate(tc, tmodel, torch.from_numpy(tokens(tc, (B, PROMPT))), NEW,
                             device="cpu")
    assert out.shape == (B, NEW) and bool(((out >= 0) & (out < tc.vocab_size)).all())


def test_a_length_the_chunk_does_not_divide_raises():
    """68 positions: chunks of min(64, 68) = 64 do not divide them, as the
    reference asserts."""
    _, tc = configs()
    tmodel = tm.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="chunks"):
        tm.forward(tc, tmodel, torch.from_numpy(tokens(tc, (1, 68))))


def test_serving_on_cpu_launches_no_kernel():
    _, tc = configs()
    tmodel = tm.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    ops.reset_launches()
    ts.greedy_generate(tc, tmodel, torch.from_numpy(tokens(tc, (B, PROMPT))), NEW,
                       device="cpu")
    assert ops.launches == dict.fromkeys(ops.KERNELS, 0)


# ---------------------------------------------------------------------------
# training: the SSD scan's gradient through the model (tests/test_torch_train.py
# for the dense decoders)
# ---------------------------------------------------------------------------

TRAIN_SEQ = 128   # two chunks of 64: the state passes between them
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
LOSS_TOL = dict(rtol=1e-5, atol=0.0)
STATE_TOL = {"params": dict(atol=2e-4, rtol=0.0), "m": dict(atol=2e-6, rtol=0.0),
             "v": dict(atol=2e-8, rtol=0.0)}
OPT = dict(lr=1e-2, warmup_steps=2)


@pytest.fixture
def xla_dispatch():
    """The JAX package differentiates only its XLA dispatch (its Pallas
    scan and RMSNorm have no gradient)."""
    prev = dispatch.set_kernel_impl("xla")
    try:
        yield
    finally:
        dispatch.set_kernel_impl(prev)


def train_batch(cfg, rows=B, seed=1):
    """tokens and labels (rows, TRAIN_SEQ) int32, the first row's first
    labels masked (-1), for both packages."""
    seqs = tokens(cfg, (rows, TRAIN_SEQ + 1), seed)
    tok, lab = seqs[:, :-1].astype(np.int32), seqs[:, 1:].astype(np.int32)
    lab[0, :3] = -1
    return ({"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)},
            {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab)})


def close_named(cfg, jtree, tnamed, tol, what):
    want = convert.named_reference_arrays(cfg, jax.tree.map(np.asarray, jtree))
    assert set(want) == set(tnamed), what
    for k, w in want.items():
        np.testing.assert_allclose(tnamed[k].detach().numpy(), w, err_msg=f"{what} {k}", **tol)


def close_state(cfg, jstate, tstate, jmet, tmet, what=""):
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]), err_msg=f"{what} {key}",
                                   **LOSS_TOL)
    close_named(cfg, jstate["params"], dict(tstate["params"].named_parameters()),
                STATE_TOL["params"], f"{what} params")
    for key in ("m", "v"):
        close_named(cfg, jstate["opt"][key], tstate["opt"][key], STATE_TOL[key], f"{what} {key}")
    assert int(jstate["opt"]["step"]) == int(tstate["opt"]["step"])


@pytest.mark.parametrize("policy", ["none", "block", "dots", "planner"])
def test_lm_loss_and_gradients_match_reference(xla_dispatch, policy):
    """The loss and every parameter's gradient against ``jax.value_and_grad``
    of the reference's ``lm_loss``, under each remat policy (``planner``
    cutting at ``mixer_out``); no kernel launches on the CPU."""
    jc, jparams, tc, _ = models()
    tc = dataclasses.replace(tc, remat_policy=policy)
    model = convert.params_from_reference(tc, jax.tree.map(np.asarray, jparams), "cpu")
    model.requires_grad_(True)
    jb, tb = train_batch(jc)
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.lm_loss(jc, p, jb), has_aux=True))(jparams)
    ops.reset_launches()
    tloss, taux = tm.lm_loss(tc, model, tb, save_names=("mixer_out",))
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), **LOSS_TOL)
    for key in ("nll", "zloss", "ntok"):
        np.testing.assert_allclose(float(taux[key].detach()), float(jaux[key]), **LOSS_TOL)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(tloss, list(model.parameters()))
    assert ops.launches == dict.fromkeys(ops.KERNELS, 0)
    close_named(tc, jgrads, dict(zip(names, grads)), GRAD_TOL, "grad")


@pytest.mark.parametrize("microbatch", [B, B // 2], ids=["n_micro1", "n_micro2"])
def test_train_steps_match_reference(xla_dispatch, microbatch):
    """Two AdamW steps of one or two microbatches: loss, gradient norm,
    parameters and moments against ``repro.train.step``."""
    jc, jparams, tc, _ = models(microbatch_size=microbatch)
    jstate = jstep.init_train_state(jc, jparams)
    tstate = tstep.init_train_state(
        tc, convert.params_from_reference(tc, jax.tree.map(np.asarray, jparams), "cpu"))
    jfn = jax.jit(jstep.make_train_step(jc, jopt.AdamWConfig(**OPT), global_rows=B))
    tfn = tstep.make_train_step(tc, topt.AdamWConfig(**OPT), global_rows=B)
    assert tstep._num_microbatches(tc, B) == B // microbatch
    for i, seed in enumerate((1, 2)):
        jb, tb = train_batch(jc, seed=seed)
        jstate, jmet = jfn(jstate, jb)
        tstate, tmet = tfn(tstate, tb)
        close_state(tc, jstate, tstate, jmet, tmet, f"step {i + 1}")


def test_train_state_from_reference_continues_a_jax_run(xla_dispatch):
    """One step in JAX, the SSM model's parameters and moments carried
    across bit for bit, one more step on both."""
    jc, tc = configs()
    jstate = jstep.init_train_state(jc, jm.init_params(jc, jax.random.PRNGKey(4)))
    jfn = jax.jit(jstep.make_train_step(jc, jopt.AdamWConfig(**OPT), global_rows=B))
    jstate, _ = jfn(jstate, train_batch(jc, seed=5)[0])
    tstate = convert.train_state_from_reference(tc, jax.tree.map(np.asarray, jstate), "cpu")
    assert all(p.requires_grad for p in tstate["params"].parameters())
    assert any(".mixer.a_log" in k for k in tstate["opt"]["m"])
    for key in ("m", "v"):
        want = convert.named_reference_arrays(tc, jax.tree.map(np.asarray, jstate["opt"][key]))
        for k, w in want.items():
            assert tstate["opt"][key][k].numpy().tobytes() == w.tobytes(), (key, k)
    jb, tb = train_batch(jc, seed=6)
    jstate, jmet = jfn(jstate, jb)
    tstate, tmet = tstep.make_train_step(tc, topt.AdamWConfig(**OPT), global_rows=B)(tstate, tb)
    close_state(tc, jstate, tstate, jmet, tmet)
    assert int(tstate["opt"]["step"]) == 2


def test_train_cli_runs_on_cpu(tmp_path):
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH, "--reduced",
         "--device", "cpu", "--steps", "2", "--batch-size", "2", "--seq-len", "65",
         "--ckpt-dir", str(tmp_path / "ck"), "--data-dir", str(tmp_path / "d")],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "final loss" in res.stdout and "device=cpu" in res.stdout


def test_serve_cli_runs_on_cpu():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--reduced", "--batch", "2", "--prompt-len", "16", "--max-new", "4",
         "--device", "cpu"],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "generated 8 tokens" in res.stdout
