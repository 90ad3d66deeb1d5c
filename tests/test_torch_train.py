"""The port's training slice against the JAX package, on the CPU.

Reduced stablelm-3b is overridden to grouped-query attention (8 query
heads over 2 kv heads) and run in f32, so the comparison checks the logic,
not bf16 rounding. The JAX side runs under its XLA dispatch (the only
dispatch it can differentiate: its Pallas RMSNorm has no gradient),
restored afterwards. Weights and train states cross with
``convert.params_from_reference`` / ``train_state_from_reference``; tokens
are made with numpy from a seed.

Tolerances (f32 on both sides, sums taken in another order): loss and
gradient norm 1e-5 relative (observed ~1e-7); gradients 1e-5 absolute and
1e-4 relative; AdamW moments ``m`` 2e-6 and ``v`` 2e-8 absolute (observed
6.6e-8 and 1.6e-9 after two steps, against largest values 6.4e-3 and
1.4e-4); parameters 2e-4 absolute after steps at lr 1e-2: on the few
elements whose gradient is near zero, Adam's normalised update ``m/√v``
carries the last bits of ``g`` to a few percent of the step (observed
6.8e-5 on 35 of 2.8e5 elements).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as jm
from repro import configs as jcfg
from repro.core import planner as jplanner
from repro.data import BatchIterator as JBatchIterator
from repro.data import DataConfig as JDataConfig
from repro.data import materialize_dataset as j_materialize
from repro.kernels import dispatch
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch import configs as tcfg
from repro_torch import convert
from repro_torch import models as tm
from repro_torch.core import planner as tplanner
from repro_torch.data import BatchIterator, DataConfig, materialize_dataset
from repro_torch.kernels import ops
from repro_torch.train import optimizer as topt
from repro_torch.train import step as tstep

GQA = dict(dtype="float32", n_heads=8, n_kv_heads=2)
ROWS, SEQ = 4, 16
LOSS_TOL = dict(rtol=1e-5, atol=0.0)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
STATE_TOL = {"params": dict(atol=2e-4, rtol=0.0), "m": dict(atol=2e-6, rtol=0.0),
             "v": dict(atol=2e-8, rtol=0.0)}
OPT = dict(lr=1e-2, warmup_steps=2)


@pytest.fixture(autouse=True)
def one_thread():
    """The models here are tiny: one intra-op thread runs them fastest and
    keeps parallel test workers from oversubscribing the cores."""
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


def configs(**overrides):
    over = {**GQA, **overrides}
    return (jcfg.get_config("stablelm-3b").reduced(**over),
            tcfg.get_config("stablelm-3b").reduced(**over))


def batch(cfg, seed=1):
    """tokens and labels (ROWS, SEQ) int32, the first row's first labels
    masked (-1)."""
    seqs = np.random.default_rng(seed).integers(0, cfg.vocab_size, (ROWS, SEQ + 1))
    tok, lab = seqs[:, :-1].astype(np.int32), seqs[:, 1:].astype(np.int32)
    lab[0, :3] = -1
    return ({"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)},
            {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab)})


def as_np(tree):
    return jax.tree.map(np.asarray, tree)


def close_named(cfg, jtree, tnamed, tol, what):
    want = convert.named_reference_arrays(cfg, as_np(jtree))
    assert set(want) == set(tnamed), what
    for k, w in want.items():
        got = tnamed[k].detach().numpy()
        np.testing.assert_allclose(got, w, err_msg=f"{what} {k}", **tol)


def close_state(cfg, jstate, tstate, what=""):
    close_named(cfg, jstate["params"], dict(tstate["params"].named_parameters()),
                STATE_TOL["params"], f"{what} params")
    for key in ("m", "v"):
        close_named(cfg, jstate["opt"][key], tstate["opt"][key], STATE_TOL[key],
                    f"{what} {key}")
    assert int(jstate["opt"]["step"]) == int(tstate["opt"]["step"])
    assert tstate["opt"]["step"].dtype == torch.int32


def close_metrics(jmet, tmet, what=""):
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]), err_msg=f"{what} {key}",
                                   **LOSS_TOL)
    assert float(tmet["lr"]) == float(jmet["lr"]), what


def test_lm_loss_and_gradients_match_reference():
    jc, tc = configs()
    jparams = jm.init_params(jc, jax.random.PRNGKey(0))
    model = convert.params_from_reference(tc, as_np(jparams), "cpu").requires_grad_(True)
    jb, tb = batch(jc)
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.lm_loss(jc, p, jb), has_aux=True))(jparams)
    tloss, taux = tm.lm_loss(tc, model, tb)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), **LOSS_TOL)
    for key in ("nll", "zloss", "ntok"):
        np.testing.assert_allclose(float(taux[key].detach()), float(jaux[key]), **LOSS_TOL)
    assert float(taux["ntok"]) == ROWS * SEQ - 3
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(tloss, list(model.parameters()))
    close_named(tc, jgrads, dict(zip(names, grads)), GRAD_TOL, "grad")


@pytest.mark.parametrize("microbatch", [ROWS, ROWS // 2], ids=["n_micro1", "n_micro2"])
def test_train_steps_match_reference(microbatch):
    jc, tc = configs(microbatch_size=microbatch)
    jparams = jm.init_params(jc, jax.random.PRNGKey(0))
    jstate = jstep.init_train_state(jc, jparams)
    tstate = tstep.init_train_state(tc, convert.params_from_reference(tc, as_np(jparams), "cpu"))
    jfn = jax.jit(jstep.make_train_step(jc, jopt.AdamWConfig(**OPT), global_rows=ROWS))
    tfn = tstep.make_train_step(tc, topt.AdamWConfig(**OPT), global_rows=ROWS)
    assert tstep._num_microbatches(tc, ROWS) == ROWS // microbatch
    for i, seed in enumerate((1, 2)):
        jb, tb = batch(jc, seed)
        jstate, jmet = jfn(jstate, jb)
        tstate, tmet = tfn(tstate, tb)
        close_metrics(jmet, tmet, f"step {i + 1}")
        close_state(tc, jstate, tstate, f"step {i + 1}")


def test_train_state_from_reference_continues_a_jax_run():
    """One step in JAX, the state carried across, one more step on both."""
    jc, tc = configs()
    jstate = jstep.init_train_state(jc, jm.init_params(jc, jax.random.PRNGKey(4)))
    jfn = jax.jit(jstep.make_train_step(jc, jopt.AdamWConfig(**OPT), global_rows=ROWS))
    jstate, _ = jfn(jstate, batch(jc, 5)[0])
    tstate = convert.train_state_from_reference(tc, as_np(jstate), "cpu")
    assert all(p.requires_grad for p in tstate["params"].parameters())
    for key in ("m", "v"):   # carried bit for bit
        want = convert.named_reference_arrays(tc, as_np(jstate["opt"][key]))
        for k, w in want.items():
            assert tstate["opt"][key][k].numpy().tobytes() == w.tobytes()
    jb, tb = batch(jc, 6)
    jstate, jmet = jfn(jstate, jb)
    tstate, tmet = tstep.make_train_step(tc, topt.AdamWConfig(**OPT),
                                         global_rows=ROWS)(tstate, tb)
    close_metrics(jmet, tmet)
    close_state(tc, jstate, tstate)
    assert int(tstate["opt"]["step"]) == 2


@pytest.mark.parametrize("policy", ["block", "dots", "planner"])
def test_every_remat_policy_gives_the_loss_and_gradients_of_none(policy):
    _, tc = configs()
    model = tm.init_params(tc, torch.Generator().manual_seed(3), "cpu").requires_grad_(True)
    _, tb = batch(tc)
    out = {}
    for name in ("none", policy):
        cfg = tcfg.base.dataclasses.replace(tc, remat_policy=name)
        ops.reset_launches()
        loss, _ = tm.lm_loss(cfg, model, tb, save_names=("mixer_out",))
        out[name] = (loss, torch.autograd.grad(loss, list(model.parameters())))
    assert torch.equal(out[policy][0], out["none"][0])
    for a, b in zip(out[policy][1], out["none"][1]):
        assert torch.equal(a, b)


def test_unknown_remat_policy_raises():
    _, tc = configs(remat_policy="everything")
    model = tm.init_params(tc, torch.Generator().manual_seed(3), "cpu").requires_grad_(True)
    with pytest.raises(ValueError, match="remat policy"):
        tm.lm_loss(tc, model, batch(tc)[1])


@pytest.mark.parametrize("arch", ["stablelm-3b", "llama3-405b", "jamba-v0.1-52b",
                                  "qwen2-moe-a2.7b", "mamba2-2.7b"])
@pytest.mark.parametrize("shape,dp,budget", [("train_4k", 16, 4e9), ("train_4k", 1, 4e9),
                                             ("train_4k", 16, 2e8)])
def test_plan_remat_matches_reference(arch, shape, dp, budget):
    """The same save set and bytes; recompute seconds at the H100's dense
    bf16 rate instead of a v5e's, so the reference's times 197/989."""
    want = jplanner.plan_remat(jcfg.get_config(arch), jcfg.SHAPES[shape], dp, budget)
    got = tplanner.plan_remat(tcfg.get_config(arch), tcfg.SHAPES[shape], dp, budget)
    assert got.save_names == want.save_names
    assert got.used_bytes == want.used_bytes and got.budget_bytes == want.budget_bytes
    np.testing.assert_allclose(got.recompute_seconds_saved,
                               want.recompute_seconds_saved * 197 / 989, rtol=1e-12)
    assert {k: v["bytes"] for k, v in got.candidates.items()} == \
        {k: v["bytes"] for k, v in want.candidates.items()}


def test_batches_and_tables_are_bitwise_the_reference(tmp_path):
    kw = dict(n_shards=2, docs_per_shard=16, doc_len=128, vocab_size=300, seq_len=33,
              seed=5, catalog_budget_bytes=1 << 20)
    jout = j_materialize(JDataConfig(**kw), tmp_path / "jax")
    tout = materialize_dataset(DataConfig(**kw), tmp_path / "torch", device="cpu")
    assert tout["plan"].flagged == jout["plan"].flagged
    assert tout["plan"].order == jout["plan"].order
    assert tout["store"].manifest() == jout["store"].manifest()
    for node in jout["workload"].nodes:
        want, got = jout["store"].read(node.name), tout["store"].read(node.name)
        assert set(got) == set(want), node.name
        for col, w in want.items():
            g = got[col].numpy()
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), (node.name, col)
    jit = JBatchIterator(tmp_path / "jax", JDataConfig(**kw), batch_size=4)
    tit = BatchIterator(tmp_path / "torch", DataConfig(**kw), batch_size=4, device="cpu")
    for _ in range(6):   # crosses an epoch
        jb, tb = jit.next_batch(), tit.next_batch()
        for key in ("tokens", "labels"):
            got = tb[key].numpy()
            assert got.dtype == jb[key].dtype and got.tobytes() == jb[key].tobytes()
    assert tit.get_state() == jit.get_state()
