"""The port's int8 error-feedback gradient compression
(``repro_torch.sharding.compression``) and ``compress_grads`` training
against the JAX package, on the CPU.

``quantize_int8``, ``dequantize_int8`` and ``ef_compress_tree`` are held
bitwise: the same max, the same f32 division, half-to-even rounding and
clipping give the same int8 values, scales, dequantized gradients (in the
gradient's dtype, bf16 included) and f32 errors. The three single-device
tests of ``tests/train/test_compression.py`` have counterparts here. Train
steps with ``compress_grads=True`` run against the reference's
``make_train_step`` on reduced stablelm-3b (GQA 8/2, f32; the JAX side
under its XLA dispatch) within ``test_torch_train``'s state tolerances,
the errors within the same tolerance as the moments' scale allows (see
``EF_TOL``). Inputs are made with numpy from a seed.
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
from repro import configs as jcfg
from repro.kernels import dispatch
from repro.sharding import compression as jcomp
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch import configs as tcfg
from repro_torch import convert
from repro_torch import models as tm
from repro_torch.checkpoint import CheckpointManager
from repro_torch.sharding import compression as tcomp
from repro_torch.train import optimizer as topt
from repro_torch.train import step as tstep

ROOT = Path(__file__).resolve().parents[1]
GQA = dict(dtype="float32", n_heads=8, n_kv_heads=2)
ROWS, SEQ = 4, 16
OPT = dict(lr=1e-2, warmup_steps=2)
LOSS_TOL = dict(rtol=1e-5, atol=0.0)
STATE_TOL = {"params": dict(atol=2e-4, rtol=0.0), "m": dict(atol=2e-6, rtol=0.0),
             "v": dict(atol=2e-8, rtol=0.0)}
# The errors ``g + e - deq`` agree as the gradients do (test_torch_train's
# 1e-5), except where the two f32 sums round to neighbouring int8 grid
# points (observed: 1-4 of 123,200 elements a step); FLIP_SHARE bounds
# those. A scale taken over other tensors than the reference's leaf would
# move a third of them (observed 43,716).
EF_TOL = dict(atol=1e-5, rtol=0.0)
FLIP_SHARE = 1e-3


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def xla_dispatch():
    prev = dispatch.set_kernel_impl("xla")
    try:
        yield
    finally:
        dispatch.set_kernel_impl(prev)


def arrays(kind, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "normal": rng.standard_normal((257, 33)),
        "zeros": np.zeros((5, 7)),
        "tiny": rng.standard_normal(1000) * 1e-30,
        "wide": rng.standard_normal(4096) * np.exp(rng.uniform(-20, 20, 4096)),
        "ties": np.arange(-300, 301) / 2,
        "scalar": np.asarray(-3.25),
    }[kind].astype(np.float32)


KINDS = ["normal", "zeros", "tiny", "wide", "ties", "scalar"]


def bits(a) -> bytes:
    a = np.asarray(a)
    return (a.view(np.uint16) if a.dtype.name == "bfloat16" else a).tobytes()


def tbits(t: torch.Tensor) -> bytes:
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()


@pytest.mark.parametrize("kind", KINDS)
def test_quantize_and_dequantize_bitwise_the_reference(kind):
    a = arrays(kind)
    jq, js = jcomp.quantize_int8(jnp.asarray(a))
    tq, ts = tcomp.quantize_int8(torch.from_numpy(a))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32 and ts.shape == ()
    assert tq.numpy().tobytes() == np.asarray(jq).tobytes()
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()
    td = tcomp.dequantize_int8(tq, ts)
    assert td.dtype == torch.float32
    assert td.numpy().tobytes() == np.asarray(jcomp.dequantize_int8(jq, js)).tobytes()


def test_zero_tensor_quantizes_to_zero_on_the_epsilon_scale():
    q, s = tcomp.quantize_int8(torch.zeros(9))
    assert not q.any() and float(s) == np.float32(1e-12)
    assert not tcomp.dequantize_int8(q, s).any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ef_compress_tree_bitwise_the_reference(dtype):
    """Two rounds, the first's errors fed to the second, with an all-zero
    gradient among them; bf16 gradients come back bf16, errors f32."""
    names = ["a", "b", "zero", "ties"]
    grads = [{"a": arrays("normal", s), "b": arrays("wide", s), "zero": arrays("zeros"),
              "ties": arrays("ties")} for s in (1, 2)]
    jdt = getattr(jnp, dtype)
    jerr = jcomp.init_error_state({k: jnp.asarray(v, jdt) for k, v in grads[0].items()})
    terr = tcomp.init_error_state(
        {k: torch.from_numpy(v).to(getattr(torch, dtype)) for k, v in grads[0].items()})
    for k in names:
        assert terr[k].dtype == torch.float32 and not terr[k].any()
    for g in grads:
        jdeq, jerr = jcomp.ef_compress_tree({k: jnp.asarray(v, jdt) for k, v in g.items()},
                                            jerr)
        tdeq, terr = tcomp.ef_compress_tree(
            {k: torch.from_numpy(v).to(getattr(torch, dtype)) for k, v in g.items()}, terr)
        for k in names:
            assert tdeq[k].dtype == getattr(torch, dtype) and terr[k].dtype == torch.float32
            assert tbits(tdeq[k]) == bits(jdeq[k]), k
            assert tbits(terr[k]) == bits(jerr[k]), k


# ---------------------------------------------------------------------------
# counterparts of tests/train/test_compression.py's single-device tests
# ---------------------------------------------------------------------------

def test_quantize_roundtrip_error_bounded():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(256).astype(np.float32))
    q, s = tcomp.quantize_int8(x)
    err = (tcomp.dequantize_int8(q, s) - x).abs()
    assert float(err.max()) <= float(s) / 2 + 1e-9   # half a step of the int8 grid


def test_error_feedback_is_unbiased_over_time():
    g = {"w": torch.full((64,), 0.01)}
    err = tcomp.init_error_state(g)
    total = torch.zeros(64)
    for _ in range(100):
        deq, err = tcomp.ef_compress_tree(g, err)
        total = total + deq["w"]
    np.testing.assert_allclose(total.numpy(), 1.0, rtol=0.02)
    assert float(err["w"].abs().max()) < 0.01   # the residual stays under one step


def test_ef_compression_trains_quadratic():
    opt = topt.AdamWConfig(lr=0.05, weight_decay=0.0, warmup_steps=1)
    target = torch.linspace(-1, 1, 16)
    params = {"w": torch.zeros(16, requires_grad=True)}
    state = topt.init_opt_state(params)
    err = tcomp.init_error_state(params)

    def loss(p):
        return torch.sum((p["w"] - target) ** 2)

    for _ in range(300):
        grads = dict(zip(params, torch.autograd.grad(loss(params), list(params.values()))))
        grads, err = tcomp.ef_compress_tree(grads, err)
        _, state, _ = topt.adamw_update(opt, params, grads, state)
    assert float(loss(params).detach()) < 1e-3


# ---------------------------------------------------------------------------
# compress_grads training against the reference
# ---------------------------------------------------------------------------

def configs(**over):
    over = {**GQA, **over}
    return (jcfg.get_config("stablelm-3b").reduced(**over),
            tcfg.get_config("stablelm-3b").reduced(**over))


def batch(cfg, seed):
    seqs = np.random.default_rng(seed).integers(0, cfg.vocab_size, (ROWS, SEQ + 1))
    tok, lab = seqs[:, :-1].astype(np.int32), seqs[:, 1:].astype(np.int32)
    return ({"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)},
            {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab)})


def as_np(tree):
    return jax.tree.map(np.asarray, tree)


def close_named(cfg, jtree, tnamed, tol, what):
    want = convert.named_reference_arrays(cfg, as_np(jtree))
    assert set(want) == set(tnamed), what
    for k, w in want.items():
        np.testing.assert_allclose(tnamed[k].detach().numpy(), w, err_msg=f"{what} {k}", **tol)


def grid_flips(cfg, jstate, tstate, flipped, what):
    """Adds to ``flipped`` (name -> bool array) the elements whose error
    differs by more than ``EF_TOL``: where the f32 sums ``grad + error`` of
    the two packages (a few ulp apart) straddle a half step of the int8
    grid, they round to neighbouring grid points, and the errors differ by
    that step. Each such difference must be at most one step (twice the
    largest error of its tensor, which is at most half a step), and they
    must stay rare (``FLIP_SHARE``)."""
    want = convert.named_reference_arrays(cfg, as_np(jstate["ef_error"]))
    assert set(want) == set(tstate["ef_error"]), what
    n = off = 0
    for k, w in want.items():
        d = np.abs(tstate["ef_error"][k].numpy() - w)
        out = d > EF_TOL["atol"]
        step = 2 * np.abs(w).max() + EF_TOL["atol"]
        assert (d[out] <= step).all(), f"{what} ef_error {k}: {d.max()} over one step {step}"
        flipped[k] = flipped.get(k, np.zeros(w.shape, bool)) | out
        n, off = n + d.size, off + int(out.sum())
    assert off <= FLIP_SHARE * n, f"{what}: {off} of {n} errors differ"


def close_state(cfg, jstate, tstate, flipped, what):
    """Parameters, moments and errors within ``STATE_TOL`` / ``EF_TOL``,
    except on elements whose int8 grid point differed between the packages
    in this step or an earlier one (:func:`grid_flips`): Adam normalises
    the update, so one step of the grid there can move the parameter by up
    to the learning rate."""
    grid_flips(cfg, jstate, tstate, flipped, what)
    trees = [("params", jstate["params"], dict(tstate["params"].named_parameters()))] + [
        (key, jstate["opt"][key], tstate["opt"][key]) for key in ("m", "v")]
    for key, jtree, tnamed in trees:
        want = convert.named_reference_arrays(cfg, as_np(jtree))
        for k, w in want.items():
            got = tnamed[k].detach().numpy()
            bad = ~np.isclose(got, w, **STATE_TOL[key]) & ~flipped[k]
            assert not bad.any(), f"{what} {key} {k}: {np.abs(got - w)[bad].max()}"
    assert int(jstate["opt"]["step"]) == int(tstate["opt"]["step"])


def close_metrics(jmet, tmet, what):
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]), err_msg=f"{what} {key}",
                                   **LOSS_TOL)


def test_init_train_state_carries_zero_errors_keyed_as_the_moments():
    _, tc = configs()
    state = tstep.init_train_state(tc, tm.init_params(tc, torch.Generator().manual_seed(0),
                                                      "cpu"), compress_grads=True)
    assert set(state["ef_error"]) == set(state["opt"]["m"])
    for k, e in state["ef_error"].items():
        assert e.dtype == torch.float32 and not e.any()
        assert e.shape == state["opt"]["m"][k].shape
    plain = tstep.init_train_state(tc, tm.init_params(tc, torch.Generator().manual_seed(0),
                                                      "cpu"))
    assert "ef_error" not in plain


@pytest.mark.parametrize("microbatch", [ROWS, ROWS // 2], ids=["n_micro1", "n_micro2"])
def test_compressed_train_steps_match_reference(microbatch):
    jc, tc = configs(microbatch_size=microbatch)
    jparams = jm.init_params(jc, jax.random.PRNGKey(0))
    jstate = jstep.init_train_state(jc, jparams, compress_grads=True)
    tstate = tstep.init_train_state(
        tc, convert.params_from_reference(tc, as_np(jparams), "cpu"), compress_grads=True)
    jfn = jax.jit(jstep.make_train_step(jc, jopt.AdamWConfig(**OPT), global_rows=ROWS,
                                        compress_grads=True))
    tfn = tstep.make_train_step(tc, topt.AdamWConfig(**OPT), global_rows=ROWS,
                                compress_grads=True)
    flipped = {}
    for i, seed in enumerate((1, 2)):
        jb, tb = batch(jc, seed)
        jstate, jmet = jfn(jstate, jb)
        tstate, tmet = tfn(tstate, tb)
        close_metrics(jmet, tmet, f"step {i + 1}")
        close_state(tc, jstate, tstate, flipped, f"step {i + 1}")
    assert any(e.abs().max() > 0 for e in tstate["ef_error"].values())


@pytest.mark.parametrize("arch", ["stablelm-3b", "jamba-v0.1-52b"])
def test_grouped_compression_bitwise_the_stacked_reference_tree(arch):
    """The reference compresses its parameter tree, whose leaves stack a
    pattern position's layers; the port's name-keyed tensors grouped by
    ``_stacked_leaves`` give the same values bit for bit."""
    over = dict(dtype="float32", n_layers=8)   # jamba: one pattern; stablelm: 8 layers
    jc, tc = jcfg.get_config(arch).reduced(**over), tcfg.get_config(arch).reduced(**over)
    shapes = jm.init_params(jc, jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    leaves, treedef = jax.tree.flatten(shapes)
    g = jax.tree.unflatten(treedef, [
        jnp.asarray(rng.standard_normal(x.shape).astype(np.float32)
                    * np.exp(rng.uniform(-3, 3))) for x in leaves])
    e = jax.tree.unflatten(treedef, [
        jnp.asarray(rng.standard_normal(x.shape).astype(np.float32) * 1e-3) for x in leaves])
    jdeq, jerr = jcomp.ef_compress_tree(g, e)
    tg, te = ({k: torch.from_numpy(np.array(a))
               for k, a in convert.named_reference_arrays(tc, as_np(tree)).items()}
              for tree in (g, e))
    tdeq, terr = tcomp.ef_compress_tree(tg, te, tstep._stacked_leaves(tc, tg))
    for jtree, tnamed in ((jdeq, tdeq), (jerr, terr)):
        for k, w in convert.named_reference_arrays(tc, as_np(jtree)).items():
            assert tnamed[k].numpy().tobytes() == w.tobytes(), k


def test_compressed_step_is_the_plain_gradients_compressed_then_updated():
    """The port's compressed step equals, bit for bit, its own averaged
    gradients put through ``ef_compress_tree`` (scales grouped as the
    reference's leaves) and then ``adamw_update``."""
    _, tc = configs(microbatch_size=ROWS // 2)
    opt = topt.AdamWConfig(**OPT)
    model = tm.init_params(tc, torch.Generator().manual_seed(5), "cpu")
    other = tm.init_params(tc, torch.Generator().manual_seed(5), "cpu")
    state = tstep.init_train_state(tc, model, compress_grads=True)
    _, tb = batch(tc, 8)
    state, met = tstep.make_train_step(tc, opt, global_rows=ROWS, compress_grads=True)(
        state, tb)
    plain = tstep.init_train_state(tc, other)
    params = dict(other.named_parameters())
    gsum = {k: torch.zeros(p.shape) for k, p in params.items()}
    for i in range(2):
        loss, _ = tm.lm_loss(tc, other, {k: v[i::2] for k, v in tb.items()})
        for acc, gr in zip(gsum.values(), torch.autograd.grad(loss, list(params.values()))):
            acc.add_(gr)
    for acc in gsum.values():
        acc.div_(2)
    deq, err = tcomp.ef_compress_tree(gsum, tcomp.init_error_state(params),
                                      tstep._stacked_leaves(tc, params))
    _, _, om = topt.adamw_update(opt, params, deq, plain["opt"])
    assert torch.equal(met["grad_norm"], om["grad_norm"])
    for k, p in state["params"].named_parameters():
        assert torch.equal(p, params[k]), k
        assert torch.equal(state["ef_error"][k], err[k]), k
        assert torch.equal(state["opt"]["m"][k], plain["opt"]["m"][k]), k


def test_train_state_from_reference_carries_the_errors():
    """One compressed step in JAX, the state carried across bit for bit
    (errors included), one more compressed step on both."""
    jc, tc = configs()
    jstate = jstep.init_train_state(jc, jm.init_params(jc, jax.random.PRNGKey(4)),
                                    compress_grads=True)
    jfn = jax.jit(jstep.make_train_step(jc, jopt.AdamWConfig(**OPT), global_rows=ROWS,
                                        compress_grads=True))
    jstate, _ = jfn(jstate, batch(jc, 5)[0])
    tstate = convert.train_state_from_reference(tc, as_np(jstate), "cpu")
    want = convert.named_reference_arrays(tc, as_np(jstate["ef_error"]))
    assert set(want) == set(tstate["ef_error"])
    for k, w in want.items():
        assert tstate["ef_error"][k].numpy().tobytes() == w.tobytes(), k
    jb, tb = batch(jc, 6)
    jstate, jmet = jfn(jstate, jb)
    tstate, tmet = tstep.make_train_step(tc, topt.AdamWConfig(**OPT), global_rows=ROWS,
                                         compress_grads=True)(tstate, tb)
    close_metrics(jmet, tmet, "step 2")
    close_state(tc, jstate, tstate, {}, "step 2")


def test_checkpoint_round_trip_carries_the_errors(tmp_path):
    _, tc = configs()
    state = tstep.init_train_state(
        tc, tm.init_params(tc, torch.Generator().manual_seed(1), "cpu"), compress_grads=True)
    state, _ = tstep.make_train_step(tc, topt.AdamWConfig(**OPT), global_rows=ROWS,
                                     compress_grads=True)(state, batch(tc, 3)[1])
    mgr = CheckpointManager(tmp_path / "ck")
    mgr.save({"train": state}, 1, blocking=True)
    template = {"train": tstep.init_train_state(
        tc, tm.init_params(tc, torch.Generator().manual_seed(2), "cpu"), compress_grads=True)}
    restored = mgr.restore(template)["train"]
    assert set(restored["ef_error"]) == set(state["ef_error"])
    for k, e in state["ef_error"].items():
        assert tbits(restored["ef_error"][k]) == tbits(e), k
    for k, p in state["params"].named_parameters():
        assert tbits(dict(restored["params"].named_parameters())[k].detach()) == \
            tbits(p.detach()), k


def test_train_cli_compress_grads_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced", "--steps", "2",
         "--compress-grads", "--device", "cpu", "--batch-size", "4", "--seq-len", "33",
         "--ckpt-dir", str(tmp_path / "ck"), "--data-dir", str(tmp_path / "d")],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "final loss" in res.stdout and "device=cpu" in res.stdout
    meta = (tmp_path / "ck" / "step_00000002" / "META.json").read_text()
    assert "train/ef_error/embed" in meta
