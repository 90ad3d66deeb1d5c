"""The port's public signatures that take the reference's arguments, against
the JAX package on the CPU.

``LoopConfig.log_every``, ``attention_forward(write_cache=)``,
``init_mlp(d_ff=)`` and ``make_ssm_cache(dtype=)`` exist in the port with
the reference's meaning: every parameter (and dataclass field) of these
reference signatures, and of ``init_moe``, ``moe_forward``, the train
step's (``make_train_step(dp=)`` included), the sharding strategy's, the
mesh context's, the meshes', ``greedy_generate``'s and
``elastic_restore``'s, is in the port's with the same default;
``init_mlp`` and ``make_ssm_cache`` give the reference's shapes and dtypes;
``write_cache``'s cache (the post-RoPE k and v on the cache-less path, the
cache written in place on the cache path) lies within the model tolerance
of the reference's ``new_cache`` for the same weights, and leaving it out
keeps the port's output alone. Inputs are made with numpy from a seed.
"""
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.mesh as jmesh
import repro.runtime.ft as jft
import repro.serve.step as jserve
import repro.models.layers as jl
import repro.sharding.compression as jcomp
import repro.sharding.context as jctx
import repro.sharding.strategy as jstrat
import repro.train.loop as jloop
import repro.train.step as jstep
from repro import configs as jcfg
from repro.kernels import dispatch
import repro_torch.launch.mesh as tmesh
import repro_torch.runtime.ft as tft
import repro_torch.serve.step as tserve
import repro_torch.models.layers as tl
import repro_torch.sharding.compression as tcomp
import repro_torch.sharding.context as tctx
import repro_torch.sharding.strategy as tstrat
import repro_torch.train.loop as tloop
import repro_torch.train.step as tstep
from repro_torch import configs as tcfg

TOL = dict(atol=1e-4, rtol=1e-4)   # the serving tests' logit tolerance (f32)
GQA = dict(dtype="float32", n_heads=8, n_kv_heads=2)
# The port draws its weights from a torch.Generator where the reference
# takes a jax.random key; every other name is the reference's.
RENAMED = {"key": "gen"}


def configs(arch, **over):
    return jcfg.get_config(arch).reduced(**over), tcfg.get_config(arch).reduced(**over)


@pytest.mark.parametrize("name", ["attention_forward", "init_mlp", "make_ssm_cache",
                                  "init_moe", "moe_forward"])
def test_every_reference_parameter_is_in_the_port(name):
    want = inspect.signature(getattr(jl, name)).parameters
    got = inspect.signature(getattr(tl, name)).parameters
    for pname, param in want.items():
        port_name = RENAMED.get(pname, pname)
        assert port_name in got, f"{name}: no {port_name}"
        assert got[port_name].default == param.default, f"{name}({port_name}=)"


MODULES = {"compression": (jcomp, tcomp), "step": (jstep, tstep),
           "strategy": (jstrat, tstrat), "context": (jctx, tctx), "mesh": (jmesh, tmesh),
           "serve": (jserve, tserve), "ft": (jft, tft)}


@pytest.mark.parametrize("module,name", [
    ("compression", "quantize_int8"), ("compression", "dequantize_int8"),
    ("compression", "ef_compress_tree"), ("compression", "init_error_state"),
    ("compression", "compressed_psum"),
    ("step", "init_train_state"), ("step", "make_train_step"),
    ("step", "train_state_specs"), ("step", "_num_microbatches"),
    ("strategy", "mesh_axis_sizes"), ("strategy", "dp_axes"), ("strategy", "param_specs"),
    ("strategy", "opt_state_specs"), ("strategy", "batch_specs"),
    ("strategy", "cache_specs"), ("strategy", "activation_sharding_constraint"),
    ("strategy", "audit_divisibility"),
    ("context", "set_mesh"), ("context", "get_mesh"), ("context", "mesh_context"),
    ("mesh", "make_production_mesh"), ("mesh", "make_local_mesh"),
    ("mesh", "required_devices"), ("serve", "greedy_generate"), ("ft", "elastic_restore")])
def test_compression_and_train_step_take_every_reference_parameter(module, name):
    """Every parameter of the reference's function is the port's, in the
    same order and with the same default; the port may add parameters after
    them (``mesh=`` of ``compressed_psum``, ``reduce_max=`` of
    ``ef_compress_tree``). ``_num_microbatches``' ``dp`` defaults to 1 in
    the port."""
    ref, port = MODULES[module]
    want = inspect.signature(getattr(ref, name)).parameters
    got = inspect.signature(getattr(port, name)).parameters
    for pname, param in want.items():
        assert pname in got, f"{name}: no {pname}"
        default = param.default   # the two packages' AdamWConfig: compare fields
        if dataclasses.is_dataclass(default):
            assert dataclasses.asdict(got[pname].default) == dataclasses.asdict(default)
        elif (name, pname) != ("_num_microbatches", "dp"):
            assert got[pname].default == default, f"{name}({pname}=)"
    assert list(got)[:len(want)] == list(want), name


def test_loop_config_has_every_reference_field():
    port = {f.name: f.default for f in dataclasses.fields(tloop.LoopConfig)}
    for f in dataclasses.fields(jloop.LoopConfig):
        assert f.name in port and port[f.name] == f.default, f.name
    assert tloop.LoopConfig(log_every=3).log_every == jloop.LoopConfig(log_every=3).log_every


@pytest.mark.parametrize("d_ff", [None, 48])
def test_init_mlp_width_matches_reference(d_ff):
    jc, tc = configs("stablelm-12b", **GQA)
    want = jl.init_mlp(jc, jax.random.PRNGKey(0), d_ff=d_ff)
    got = tl.init_mlp(tc, torch.Generator().manual_seed(0), d_ff=d_ff)
    for k in ("wi", "wo"):
        w = np.asarray(want[k])
        assert tuple(getattr(got, k).shape) == w.shape and str(getattr(got, k).dtype) == \
            f"torch.{w.dtype}", k
    assert got.wo.shape[0] == (d_ff or tc.d_ff)


@pytest.mark.parametrize("dtype", [None, "float32", "bfloat16"])
def test_make_ssm_cache_dtype_matches_reference(dtype):
    jc, tc = configs("mamba2-2.7b")
    want = jl.make_ssm_cache(jc, 3, dtype=None if dtype is None else getattr(jnp, dtype))
    got = tl.make_ssm_cache(tc, 3, "cpu", dtype=None if dtype is None else getattr(torch, dtype))
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        assert tuple(got[k].shape) == w.shape, k
        assert str(got[k].dtype) == f"torch.{jnp.dtype(w.dtype).name}", k


def attention_inputs(s=12, seed=0):
    jc, tc = configs("stablelm-12b", **GQA)
    p = jl.init_attention(jc, jax.random.PRNGKey(seed))
    port = tl.Attention(*(torch.from_numpy(np.array(p[k])) for k in ("wq", "wk", "wv", "wo")))
    x = np.random.default_rng(seed).standard_normal((2, s, jc.d_model)).astype(np.float32)
    return jc, tc, p, port, x


@pytest.fixture
def xla():
    prev = dispatch.set_kernel_impl("xla")
    try:
        yield
    finally:
        dispatch.set_kernel_impl(prev)


def test_attention_write_cache_gives_reference_new_cache(xla):
    """Cache-less: the post-RoPE k and v (b, kv, s, hd) as the new cache."""
    jc, tc, p, port, x = attention_inputs()
    pos = np.arange(x.shape[1])
    want_out, want_cache = jl.attention_forward(jc, p, jnp.asarray(x), jnp.asarray(pos),
                                                write_cache=True)
    with torch.no_grad():
        out, cache = tl.attention_forward(tc, port, torch.from_numpy(x), torch.from_numpy(pos),
                                          write_cache=True)
        alone = tl.attention_forward(tc, port, torch.from_numpy(x), torch.from_numpy(pos))
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **TOL)
    assert set(cache) == set(want_cache) == {"k", "v"}
    for k in ("k", "v"):
        assert tuple(cache[k].shape) == want_cache[k].shape
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(want_cache[k]), **TOL,
                                   err_msg=k)
    assert torch.equal(alone, out)


def test_attention_write_cache_returns_the_written_cache(xla):
    """With a cache: the cache written in place at ``cache_pos``, returned as
    the reference returns its updated one."""
    jc, tc, p, port, x = attention_inputs(s=5, seed=1)
    pos = np.arange(3, 8)
    want_out, want_cache = jl.attention_forward(
        jc, p, jnp.asarray(x), jnp.asarray(pos), cache=jl.make_kv_cache(jc, 2, 16),
        cache_pos=3, write_cache=True)
    cache = tl.make_kv_cache(tc, 2, 16, "cpu")
    with torch.no_grad():
        out, got = tl.attention_forward(tc, port, torch.from_numpy(x), torch.from_numpy(pos),
                                        cache=cache, cache_pos=3, write_cache=True)
    assert got is cache
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want_cache[k]), **TOL, err_msg=k)
