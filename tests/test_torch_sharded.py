"""Sharded train and serve steps on a mesh of gloo ranks on the CPU,
against the JAX package's unsharded steps.

Four ranks (``test_torch_mesh_ranks.run_ranks``; a 2 x 2 ``data`` x
``model`` mesh, or 1 x 4) lay the model out by the sharding specs
(``sharding.layout.shard_params``) and run the port's steps with the mesh
set; their results, gathered back to whole tensors, are held against the
reference's unsharded functions run here under XLA dispatch, on weights
from the reference's ``init_params`` and tokens made with numpy from a
seed. Configurations: reduced qwen2-moe-a2.7b as the reference's own
sharded test reduces it (d_model 64, 4/4 heads of 16, d_ff 128, vocab 256,
8 experts top 2: experts split over ``model``; with 7 experts each
expert's hidden width is split instead) and reduced stablelm-12b at GQA
8/2 (kv heads split at tp 2; replicated at tp 4, each rank reading the kv
head of its q heads), f32.

- **Train step:** one step with dp 2, global_rows 8 and 2 microbatches
  against ``make_train_step(cfg, dp=2, global_rows=8)``, with and without
  FSDP and with ``compress_grads``: loss and gradient norm within 1e-5
  relative, the moments and every updated parameter within 1e-5 of their
  tensor's largest magnitude, except where Adam's step is ill-conditioned
  (the reference's gradient under ``NEAR_ZERO`` of its tensor's largest,
  or an int8 grid point that differs under compression), which may move
  by at most the learning rate and stay rare.
- **Serving:** the forward's logits, a prefill and decode steps'
  logits and the kv cache against ``forward``, ``make_prefill_step`` and
  ``make_decode_step`` within the serving tests' 1e-4.
- **MoE:** ``shard_map_ep`` against the gather path drop-free (capacity
  16) within the reference's own 2e-4; at capacity 1.25 the gather path
  on the mesh routes and drops exactly the (token, expert) pairs of the
  port's unsharded layer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as jm
from repro import configs as jcfg
from repro.kernels import dispatch
from repro.serve.step import make_decode_step, make_prefill_step
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch import configs as tcfg
from repro_torch import convert
from repro_torch import models as tm
from test_torch_mesh_ranks import GQA, QWEN, run_ranks

WORLD = 4
TIMEOUT = 150
QWEN_ARCH, LM_ARCH = "qwen2-moe-a2.7b", "stablelm-12b"
TOL = dict(atol=1e-4, rtol=1e-4)        # the serving tests' logit tolerance (f32)
EP_TOL = dict(atol=2e-4, rtol=2e-4)     # the reference's shard_map test
REL = 1e-5
OPT = dict(lr=1e-2, warmup_steps=2)
NEAR_ZERO = 2e-3                        # as test_torch_moe_train
ADAM_SHARE = 1e-4
FLIP_SHARE = 1e-3                       # as test_torch_compression
SEQ, PROMPT = 12, 8                     # forward tokens; prefill, then a decode step each
ROWS, TRAIN_SEQ = 8, 16

FORWARD = [
    dict(name="qwen_gather_16", arch=QWEN_ARCH, over={**QWEN, "moe_capacity_factor": 16.0},
         mesh_shape=(2, 2), fsdp=False, moe_impl="gather"),
    dict(name="qwen_ep_16", arch=QWEN_ARCH, over={**QWEN, "moe_capacity_factor": 16.0},
         mesh_shape=(2, 2), fsdp=True, moe_impl="shard_map_ep"),
    dict(name="qwen_gather_125", arch=QWEN_ARCH, over=QWEN, mesh_shape=(2, 2), fsdp=True,
         moe_impl="gather"),
    dict(name="qwen_ffn_tp_125", arch=QWEN_ARCH, over={**QWEN, "moe_experts": 7},
         mesh_shape=(2, 2), fsdp=True, moe_impl="gather"),
    dict(name="stablelm_2x2", arch=LM_ARCH, over=GQA, mesh_shape=(2, 2), fsdp=False,
         moe_impl="gather"),
    dict(name="stablelm_1x4", arch=LM_ARCH, over=GQA, mesh_shape=(1, 4), fsdp=True,
         moe_impl="gather"),
]
TRAIN = [
    dict(name="qwen_dp2", arch=QWEN_ARCH, over=QWEN, mesh_shape=(2, 2), fsdp=False,
         compress=False, dp=2),
    dict(name="qwen_dp2_fsdp", arch=QWEN_ARCH, over=QWEN, mesh_shape=(2, 2), fsdp=True,
         compress=False, dp=2),
    dict(name="qwen_dp2_compress", arch=QWEN_ARCH, over=QWEN, mesh_shape=(2, 2), fsdp=True,
         compress=True, dp=2),
    dict(name="stablelm_2x2", arch=LM_ARCH, over=GQA, mesh_shape=(2, 2), fsdp=False,
         compress=False, dp=2),
    dict(name="stablelm_1x4_fsdp", arch=LM_ARCH, over=GQA, mesh_shape=(1, 4), fsdp=True,
         compress=False, dp=1),
]
WITH_DROPS = ["qwen_gather_125", "qwen_ffn_tp_125"]


@pytest.fixture(scope="module", autouse=True)
def xla_dispatch():
    prev = dispatch.set_kernel_impl("xla")
    try:
        yield
    finally:
        dispatch.set_kernel_impl(prev)


def as_np(tree):
    return jax.tree.map(np.asarray, tree)


def configs(case):
    return (jcfg.get_config(case["arch"]).reduced(**case["over"]),
            tcfg.get_config(case["arch"]).reduced(**case["over"]))


def tokens_of(cfg, seed, shape):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


# ---------------------------------------------------------------------------
# the reference's outputs, and the ranks'
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def forward_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("forward")
    want = {}
    for case in FORWARD:   # one seed: the ep and gather cases share weights and tokens
        jc, tc = configs(case)
        jparams = jm.init_params(jc, jax.random.PRNGKey(0))
        tok = tokens_of(jc, 100, (4, SEQ))
        (root / case["name"]).mkdir()
        np.savez(root / case["name"] / "weights.npz",
                 **convert.named_reference_arrays(tc, as_np(jparams)))
        np.save(root / case["name"] / "tokens.npy", tok)
        logits, aux, _ = jax.jit(lambda p, t, jc=jc: jm.forward(jc, p, t))(jparams, tok)
        cache = jm.make_cache(jc, 4, SEQ)
        last, cache = jax.jit(make_prefill_step(jc))(jparams, tok[:, :PROMPT], cache)
        steps = [last]
        decode = jax.jit(make_decode_step(jc))
        for pos in range(PROMPT, SEQ):
            lg, cache = decode(jparams, tok[:, pos], cache, jnp.int32(pos))
            steps.append(lg)
        want[case["name"]] = dict(
            logits=np.asarray(logits), aux=float(aux), serve=np.stack(steps, 1),
            cache=as_np(cache), tc=tc, model=convert.params_from_reference(
                tc, as_np(jparams), "cpu"), tokens=tok)
    cases = [dict(case, seq=PROMPT) for case in FORWARD]
    ranks = run_ranks("forward", WORLD, root, TIMEOUT, cases=cases)
    return want, ranks


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("train")
    want, refs = {}, {}
    for case in TRAIN:
        jc, tc = configs(case)
        jparams = jm.init_params(jc, jax.random.PRNGKey(7))
        seqs = np.random.default_rng(8).integers(0, jc.vocab_size, (ROWS, TRAIN_SEQ + 1))
        batch = {"tokens": seqs[:, :-1].astype(np.int32), "labels": seqs[:, 1:].astype(np.int32)}
        batch["labels"][0, :3] = -1
        (root / case["name"]).mkdir()
        np.savez(root / case["name"] / "weights.npz",
                 **convert.named_reference_arrays(tc, as_np(jparams)))
        np.savez(root / case["name"] / "batch.npz", **batch)
        key = (case["arch"], case["compress"], case["dp"])
        if key not in refs:   # fsdp changes no number of the reference's step
            assert jstep._num_microbatches(jc, ROWS, case["dp"]) == ROWS // case["dp"] // 2
            fn = jax.jit(jstep.make_train_step(jc, jopt.AdamWConfig(**OPT), dp=case["dp"],
                                               global_rows=ROWS,
                                               compress_grads=case["compress"]))
            state, met = fn(jstep.init_train_state(jc, jparams, case["compress"]),
                            {k: jnp.asarray(v) for k, v in batch.items()})
            refs[key] = (state, met)
        state, met = refs[key]
        want[case["name"]] = dict(
            metrics={k: float(v) for k, v in met.items()}, tc=tc,
            params=convert.named_reference_arrays(tc, as_np(state["params"])),
            m=convert.named_reference_arrays(tc, as_np(state["opt"]["m"])),
            v=convert.named_reference_arrays(tc, as_np(state["opt"]["v"])),
            ef_error=(convert.named_reference_arrays(tc, as_np(state["ef_error"]))
                      if case["compress"] else None))
    cases = [dict(case, opt=OPT, rows=ROWS) for case in TRAIN]
    ranks = run_ranks("train", WORLD, root, TIMEOUT, cases=cases)
    return want, ranks


def names(cases):
    return [c["name"] for c in cases]


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", names(FORWARD))
def test_sharded_forward_matches_reference(forward_runs, name):
    want, ranks = forward_runs
    for r, got in enumerate(ranks):
        res = got[name]
        np.testing.assert_allclose(res["logits"].numpy(), want[name]["logits"],
                                   err_msg=f"rank {r}", **TOL)
        np.testing.assert_allclose(res["aux"], want[name]["aux"], rtol=REL, atol=1e-7)


@pytest.mark.parametrize("name", names(FORWARD))
def test_sharded_prefill_and_decode_match_reference(forward_runs, name):
    """The last prompt position's logits, each decode step's, and the kv
    cache after them (the reference's stacked cache: layer n is group
    n // len(pattern)'s sub-layer n % len(pattern))."""
    want, ranks = forward_runs
    tc = want[name]["tc"]
    for r, got in enumerate(ranks):
        res = got[name]
        np.testing.assert_allclose(res["serve"].numpy(), want[name]["serve"],
                                   err_msg=f"rank {r}", **TOL)
        assert len(res["cache"]) == tc.n_layers
        for n, entry in enumerate(res["cache"]):
            g, i = divmod(n, len(tc.pattern))
            for k in ("k", "v"):
                np.testing.assert_allclose(entry[k].numpy(), want[name]["cache"][f"sub{i}"][k][g],
                                           err_msg=f"rank {r} layer {n} {k}", **TOL)


def test_shard_map_ep_matches_gather_drop_free(forward_runs):
    """Expert-parallel dispatch with local capacity against the gather
    path's global one, both drop-free at capacity 16 (the reference's own
    equivalence test, ``tests/sharding/test_perf_paths.py``)."""
    want, ranks = forward_runs
    for got in ranks:
        assert got["qwen_ep_16"]["dropped"] == got["qwen_gather_16"]["dropped"] == 0
        for key in ("logits", "serve"):
            np.testing.assert_allclose(got["qwen_ep_16"][key].numpy(),
                                       got["qwen_gather_16"][key].numpy(), **EP_TOL)


@pytest.mark.parametrize("name", WITH_DROPS)
def test_gather_path_drops_the_pairs_the_unsharded_layer_drops(forward_runs, name):
    """At capacity 1.25 the mesh's gather path routes every token to the
    same experts and keeps or drops each (token, slot) pair as the port's
    unsharded layer on the whole batch."""
    want, ranks = forward_runs
    stats = {"routing": []}
    with torch.no_grad():
        tm.forward(want[name]["tc"], want[name]["model"],
                   torch.from_numpy(want[name]["tokens"]), moe_stats=stats)
    assert stats["dropped"] > 0
    for got in ranks:
        res = got[name]
        assert res["dropped"] == stats["dropped"]
        assert len(res["routing"]) == len(stats["routing"]) == want[name]["tc"].n_layers
        for (topi, kept), (wtopi, wkept) in zip(res["routing"], stats["routing"]):
            assert torch.equal(topi, wtopi) and torch.equal(kept, wkept)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def ill_conditioned(m, b1):
    """Elements whose step-1 gradient (``m / (1 - b1)``) is under
    ``NEAR_ZERO`` of its tensor's largest."""
    g = np.abs(m) / (1 - b1)
    return g <= NEAR_ZERO * g.max()


def grid_flipped(got, want, what):
    """Compression errors more than 1e-5 apart: the two packages' f32 sums
    straddling a half step of the int8 grid. Each is at most one step and
    they stay rare (``FLIP_SHARE``)."""
    n = off = 0
    flipped = {}
    for k, w in want.items():
        d = np.abs(got[k].numpy() - w)
        out = d > 1e-5
        assert (d[out] <= 2 * np.abs(w).max() + 1e-5).all(), f"{what} ef_error {k}"
        flipped[k] = out
        n, off = n + d.size, off + int(out.sum())
    assert off <= FLIP_SHARE * n, f"{what}: {off} of {n} errors differ"
    return flipped


@pytest.mark.parametrize("name", names(TRAIN))
def test_sharded_train_step_matches_reference(train_runs, name):
    want, ranks = train_runs
    w = want[name]
    opt = jopt.AdamWConfig(**OPT)
    lr = w["metrics"]["lr"]
    for r, got in enumerate(ranks):
        res = got[name]
        what = f"{name} rank {r}"
        assert res["step"] == 1
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(res["metrics"][key], w["metrics"][key], rtol=REL,
                                       atol=0.0, err_msg=f"{what} {key}")
        state = res["state"]
        flipped = ({k: np.zeros(a.shape, bool) for k, a in w["params"].items()}
                   if w["ef_error"] is None else grid_flipped(state["ef_error"], w["ef_error"],
                                                              what))
        assert set(state["params"]) == set(w["params"])
        n = off = 0
        for k, want_p in w["params"].items():
            for key in ("m", "v"):
                got_t, want_t = state[key][k].numpy(), w[key][k]
                bad = ~np.isclose(got_t, want_t, rtol=0.0, atol=REL * np.abs(want_t).max()
                                  + 1e-30) & ~flipped[k]
                assert not bad.any(), f"{what} {key} {k}"
            got_p = state["params"][k].numpy()
            out = ~np.isclose(got_p, want_p, rtol=0.0, atol=REL * np.abs(want_p).max())
            free = ill_conditioned(w["m"][k], opt.b1) | flipped[k]
            assert not (out & ~free).any(), \
                f"{what} params {k}: {np.abs(got_p - want_p)[out & ~free].max()}"
            assert (np.abs(got_p - want_p)[out] <= lr * (1 + opt.weight_decay) * 2).all(), k
            n, off = n + want_p.size, off + int(out.sum())
        assert off <= max(ADAM_SHARE * n, FLIP_SHARE * n if w["ef_error"] is not None else 0), \
            f"{what}: {off} of {n} parameters apart"


@pytest.mark.parametrize("name", names(TRAIN))
def test_every_rank_gathers_the_same_state(train_runs, name):
    _, ranks = train_runs
    first = ranks[0][name]["state"]
    for got in ranks[1:]:
        for key, tree in got[name]["state"].items():
            for k, t in tree.items():
                assert torch.equal(t, first[key][k]), (key, k)


def test_fsdp_gathers_weights_and_reduce_scatters_gradients(train_runs):
    """With FSDP the layers gather their weights over ``data`` and the
    gradients come back reduce-scattered; without, neither happens and
    the gradients are all-reduced over ``data``."""
    _, ranks = train_runs
    for got in ranks:
        plain = got["qwen_dp2"]["counts"]["calls"]
        fsdp = got["qwen_dp2_fsdp"]["counts"]["calls"]
        assert plain["reduce_scatter"] == 0 and fsdp["reduce_scatter"] > 0
        assert fsdp["all_gather"] > plain["all_gather"]
        assert got["qwen_dp2"]["counts"]["host_staged_bytes"] == 0
