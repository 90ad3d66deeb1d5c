"""Mamba-2 and hybrid models on a mesh of gloo ranks on the CPU, against
the JAX package's unsharded functions; greedy generation and elastic
restore on the mesh.

Four ranks (``test_torch_mesh_ranks.run_ranks``, one spawn for every case:
``prog_ssm``) lay the model out by the sharding specs and run the port's
functions with the mesh set; their results, gathered back to whole
tensors, are held against the reference's unsharded functions run here
under XLA dispatch, on weights from the reference's ``init_params`` and
tokens made with numpy from a seed. Configurations, f32: reduced
mamba2-2.7b (``reduced()``: d_model 64, 8 SSD heads of 16, state 16, 2
layers) and reduced jamba-v0.1-52b at one pattern of 8 layers (7 Mamba-2
and 1 attention layer, 4 MoE of 8 experts top 2 at the config's capacity
1.25), on 2 x 2 ``data`` x ``model`` meshes with FSDP on and off and on
1 x 4 (4 and 2 SSD heads a rank; one data rank, so FSDP splits nothing:
off for mamba2, on for jamba).

- **Serving:** the forward's logits, a prefill and decode steps' logits
  and the cache (k/v and the Mamba-2 state: conv inputs and SSD state)
  within the serving tests' 1e-4; ``greedy_generate`` on the mesh (the
  global prompt in, the global tokens out on every rank) gives the
  reference's tokens; ``elastic_restore`` of a checkpoint of the whole
  weights onto each rank's shards is bitwise ``shard_params``; the gated
  norm's gather runs once a Mamba-2 layer a call.
- **The trap:** the gated RMSNorm over d_inner run on a rank's columns
  alone (its mean of squares over d_inner / tp) gives other logits, so
  the serving tests see the fault the gather removes.
- **Training:** one step with dp 2, global_rows 8 and 2 microbatches
  against ``make_train_step(cfg, dp=2, global_rows=8)``, on 2 x 2 with
  FSDP off and on and on 1 x 4 (one data rank, the same 2 microbatches):
  the loss within 1e-5 relative; the moments and the updated parameters
  within the limits the port's unsharded Mamba-2 and hybrid steps are held
  to against the reference (``STATE_TOL``, as ``test_torch_mamba`` and
  ``test_torch_moe_train``; Adam's ill-conditioned elements as in
  ``test_torch_sharded``), and the gradient norm within the gradients'
  1e-4 relative (``GRAD_TOL``). ``test_torch_sharded``'s 1e-5 of a
  tensor's largest element does not hold here even unsharded: on these
  inputs the port's unsharded jamba step is 2.5e-4 of a tensor's largest
  moment and 1.3e-5 of the gradient norm from the reference (its f32
  gradients grow through depth, ``test_torch_moe_train``'s ``DEPTH``), and
  the sharded step lies as far from either. ``elastic_restore`` of the
  reference's state after the step onto each rank's parameter shards and
  ZeRO-1 moment parts is bitwise.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as jm
from repro import configs as jcfg
from repro.kernels import dispatch
from repro.serve.step import greedy_generate, make_decode_step, make_prefill_step
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch import configs as tcfg
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from test_torch_mesh_ranks import run_ranks
from test_torch_sharded import (OPT, PROMPT, ROWS, SEQ, TOL, TRAIN_SEQ, as_np,
                                assert_train_step_matches, tokens_of)

WORLD = 4
TIMEOUT = 240
STATE_TOL = {"params": 2e-4, "m": 2e-6, "v": 2e-8}     # test_torch_moe_train's
NORM_RTOL = 1e-4                                       # GRAD_TOL's relative part
NEW = 6                                  # greedy tokens
ARCHS = {"mamba": ("mamba2-2.7b", dict(dtype="float32")),
         "jamba": ("jamba-v0.1-52b", dict(dtype="float32", n_layers=8))}


def case(arch, mesh_shape, fsdp, kind="serve"):
    name = f"{arch}_{kind}_{mesh_shape[0]}x{mesh_shape[1]}" + ("_fsdp" if fsdp else "")
    return dict(name=name, arch=ARCHS[arch][0], over=ARCHS[arch][1], mesh_shape=mesh_shape,
                fsdp=fsdp)


# FSDP splits over the data axis, of size 1 on 1 x 4: one case a model there
SERVE = [case(a, m, f) for a in ARCHS for m, f in (((2, 2), False), ((2, 2), True),
                                                  ((1, 4), a == "jamba"))]
TRAIN = [case(a, m, f, "train") for a in ARCHS
         for m, f in (((2, 2), False), ((2, 2), True), ((1, 4), False))]
NAIVE = dict(case("mamba", (2, 2), False), name="mamba_naive_norm", naive_norm=True)


def configs(c):
    return (jcfg.get_config(c["arch"]).reduced(**c["over"]),
            tcfg.get_config(c["arch"]).reduced(**c["over"]))


def names(cases):
    return [c["name"] for c in cases]


def save_checkpoint(path, tree):
    """A whole state (name → numpy array, nested) through the port's
    ``CheckpointManager``, as a run would write it."""
    def tensors(t):
        return ({k: tensors(v) for k, v in t.items()} if isinstance(t, dict)
                else torch.from_numpy(np.array(t)))
    CheckpointManager(path).save(tensors(tree), 0, blocking=True)


def reference_serve(jc, tc, jparams):
    """The reference's forward, prefill + decode steps, cache and greedy
    tokens, and the weights by the port's names."""
    tok = tokens_of(jc, 100, (4, SEQ))
    logits, _, _ = jax.jit(lambda p, t: jm.forward(jc, p, t))(jparams, tok)
    cache = jm.make_cache(jc, 4, SEQ)
    last, cache = jax.jit(make_prefill_step(jc))(jparams, tok[:, :PROMPT], cache)
    steps = [last]
    decode = jax.jit(make_decode_step(jc))
    for pos in range(PROMPT, SEQ):
        lg, cache = decode(jparams, tok[:, pos], cache, jnp.int32(pos))
        steps.append(lg)
    return dict(logits=np.asarray(logits), serve=np.stack(steps, 1), cache=as_np(cache),
                greedy=np.asarray(greedy_generate(jc, jparams, tok[:, :PROMPT], NEW)),
                tokens=tok, weights=convert.named_reference_arrays(tc, as_np(jparams)))


def reference_train(jc, tc, jparams):
    """The reference's train step (dp 2, global_rows 8), its batch, and the
    state after it by the port's names."""
    seqs = np.random.default_rng(8).integers(0, jc.vocab_size, (ROWS, TRAIN_SEQ + 1))
    batch = {"tokens": seqs[:, :-1].astype(np.int32), "labels": seqs[:, 1:].astype(np.int32)}
    batch["labels"][0, :3] = -1
    assert jstep._num_microbatches(jc, ROWS, 2) == 2
    fn = jax.jit(jstep.make_train_step(jc, jopt.AdamWConfig(**OPT), dp=2, global_rows=ROWS))
    state, met = fn(jstep.init_train_state(jc, jparams),
                    {k: jnp.asarray(v) for k, v in batch.items()})
    return dict(metrics={k: float(v) for k, v in met.items()}, batch=batch, ef_error=None,
                start=convert.named_reference_arrays(tc, as_np(jparams)),
                params=convert.named_reference_arrays(tc, as_np(state["params"])),
                m=convert.named_reference_arrays(tc, as_np(state["opt"]["m"])),
                v=convert.named_reference_arrays(tc, as_np(state["opt"]["v"])))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's outputs for each architecture, and every rank's
    results of every case (one spawn)."""
    root = tmp_path_factory.mktemp("ssm")
    prev = dispatch.set_kernel_impl("xla")
    try:
        serve, train = {}, {}
        for arch in ARCHS:
            jc, tc = configs(case(arch, (2, 2), False))
            jparams = jax.jit(functools.partial(jm.init_params, jc))(jax.random.PRNGKey(0))
            serve[arch] = reference_serve(jc, tc, jparams)
            train[arch] = reference_train(jc, tc, jparams)
    finally:
        dispatch.set_kernel_impl(prev)
    for c in SERVE + [NAIVE]:
        want = serve[c["name"].split("_")[0]]
        (root / c["name"]).mkdir()
        np.savez(root / c["name"] / "weights.npz", **want["weights"])
        np.save(root / c["name"] / "tokens.npy", want["tokens"])
        save_checkpoint(root / c["name"] / "ckpt", {"params": want["weights"]})
    for c in TRAIN:
        want = train[c["name"].split("_")[0]]
        (root / c["name"]).mkdir()
        np.savez(root / c["name"] / "weights.npz", **want["start"])
        np.savez(root / c["name"] / "batch.npz", **want["batch"])
        save_checkpoint(root / c["name"] / "ckpt", {"params": want["params"], "opt": {
            "m": want["m"], "v": want["v"], "step": np.asarray(1, np.int32)}})
    ranks = run_ranks(
        "ssm", WORLD, root, TIMEOUT,
        forward=[dict(c, seq=PROMPT, new=NEW) for c in SERVE] + [dict(NAIVE, seq=PROMPT,
                                                                     new=NEW)],
        train=[dict(c, opt=OPT, dp=2, rows=ROWS) for c in TRAIN])
    return serve, train, ranks


def arch_of(name):
    return name.split("_")[0]


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", names(SERVE))
def test_sharded_forward_matches_reference(runs, name):
    serve, _, ranks = runs
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got[name]["logits"].numpy(), serve[arch_of(name)]["logits"],
                                   err_msg=f"{name} rank {r}", **TOL)


@pytest.mark.parametrize("name", names(SERVE))
def test_sharded_prefill_decode_and_cache_match_reference(runs, name):
    """The last prompt position's logits, each decode step's, and every
    layer's cache after them: an attention layer's k/v, a Mamba-2 layer's
    conv inputs and f32 SSD state (the reference's stacked cache: layer n
    is group n // len(pattern)'s sub-layer n % len(pattern))."""
    serve, _, ranks = runs
    want = serve[arch_of(name)]
    tc = configs(case(arch_of(name), (2, 2), False))[1]
    for r, got in enumerate(ranks):
        res = got[name]
        np.testing.assert_allclose(res["serve"].numpy(), want["serve"],
                                   err_msg=f"{name} rank {r}", **TOL)
        assert len(res["cache"]) == tc.n_layers
        for n, entry in enumerate(res["cache"]):
            g, i = divmod(n, len(tc.pattern))
            ref = want["cache"][f"sub{i}"]
            assert set(entry) == set(ref)
            for k, t in entry.items():
                np.testing.assert_allclose(t.numpy(), ref[k][g],
                                           err_msg=f"{name} rank {r} layer {n} {k}", **TOL)


@pytest.mark.parametrize("name", names(SERVE))
def test_greedy_generate_on_a_mesh_gives_reference_tokens(runs, name):
    serve, _, ranks = runs
    for r, got in enumerate(ranks):
        tokens = got[name]["greedy"]
        assert tokens.shape == (4, NEW), (name, r)
        np.testing.assert_array_equal(tokens.numpy(), serve[arch_of(name)]["greedy"],
                                      err_msg=f"{name} rank {r}")


@pytest.mark.parametrize("name", names(SERVE))
def test_elastic_restore_onto_shards_is_bitwise_shard_params(runs, name):
    """The whole weights' checkpoint restored with ``NamedSharding``
    placements gives each rank exactly ``shard_params``' shards, the SSD
    heads' and d_inner's split over ``model``."""
    _, _, ranks = runs
    c = next(c for c in SERVE if c["name"] == name)
    tp = c["mesh_shape"][1]
    di = configs(c)[1].ssm_d_inner
    for r, got in enumerate(ranks):
        assert got[name]["restore_bitwise"], (name, r)
        assert got[name]["restore_shapes"]["layers.0.mixer.w_x"][1] == di // tp
        assert got[name]["restore_shapes"]["layers.0.mixer.a_log"] == (
            configs(c)[1].ssm_heads // tp,)


@pytest.mark.parametrize("name", names(SERVE))
def test_gated_norm_gathers_once_a_mamba_layer_a_call(runs, name):
    """The gated norm's all-gather over ``model`` (tag ``gated_norm``) runs
    once for each Mamba-2 layer in each call, moving the rank's rows of the
    gated product (f32): the forward, the prefill, the decode steps and the
    greedy loop's prefill and steps."""
    _, _, ranks = runs
    c = next(c for c in SERVE if c["name"] == name)
    tc = configs(c)[1]
    dp, tp = c["mesh_shape"]
    n_ssm = sum(m == "ssm" for m, _ in tc.pattern) * tc.n_groups
    rows, di = 4 // dp, tc.ssm_d_inner // tp
    positions = SEQ + PROMPT + (SEQ - PROMPT) + PROMPT + (NEW - 1)
    calls = 1 + 1 + (SEQ - PROMPT) + 1 + (NEW - 1)
    for got in ranks:
        tag = got[name]["counts"]["tags"]["gated_norm"]
        assert tag == {"calls": n_ssm * calls, "bytes": n_ssm * rows * positions * di * 4}


def test_gated_norm_on_local_columns_differs_from_reference(runs):
    """The trap the gather removes: RMSNorm over a rank's d_inner / tp
    columns alone normalises by another mean of squares, raises nothing,
    and moves the logits far past the serving tolerance."""
    serve, _, ranks = runs
    want = serve["mamba"]["logits"]
    for got in ranks:
        logits = got[NAIVE["name"]]["logits"].numpy()
        assert logits.shape == want.shape and np.isfinite(logits).all()
        assert not np.allclose(logits, want, **TOL)
        assert np.abs(logits - want).max() > 100 * TOL["atol"]


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", names(TRAIN))
def test_sharded_ssm_train_step_matches_reference(runs, name):
    _, train, ranks = runs
    for r, got in enumerate(ranks):
        assert_train_step_matches(got[name], train[arch_of(name)], f"{name} rank {r}",
                                  atol=STATE_TOL, norm_rtol=NORM_RTOL)


@pytest.mark.parametrize("name", names(TRAIN))
def test_elastic_restore_of_train_state_is_bitwise(runs, name):
    """The reference's whole state after the step, restored with
    ``NamedSharding`` placements by ``train_state_specs`` (the parameters
    by ``param_specs``, the moments by ``opt_state_specs``), is bitwise
    each rank's parameter shards, ZeRO-1 moment parts and step."""
    _, _, ranks = runs
    for r, got in enumerate(ranks):
        assert got[name]["restore_bitwise"], (name, r)
