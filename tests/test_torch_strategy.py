"""The port's sharding strategy against the JAX package's, on the CPU with
no process group.

For every architecture on both production meshes (``FakeMesh``es, as the
reference's tests use: axis names and a device grid's shape), the port's
parameter, optimizer-state and cache specs equal the reference's entry for
entry, a layer's tensor taking its stacked leaf's spec without the group
entry, and both audits are clean. The port reads shapes only
(``models.transformer.param_shapes``, a meta-device cache): the 405B and
480B configurations are never allocated. The reference's own cases carry
over (kv replicated, EP against ffn TP, the sequence-split cache spec), and
``batch_specs``, ``train_state_specs``, the production meshes and the mesh
context are held to the reference's.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.distributed as dist

import repro.launch.mesh as jmesh
import repro.models as jm
import repro.sharding.context as jctx
import repro.sharding.strategy as jstrat
import repro.train.step as jstep
from repro import configs as jcfg
import repro_torch.launch.mesh as tmesh
import repro_torch.sharding.context as tctx
import repro_torch.sharding.strategy as tstrat
import repro_torch.train.step as tstep
from repro_torch import configs as tcfg
from repro_torch import models as tm
from repro_torch.models.transformer import param_shapes


class FakeMesh:
    """Axis names and a device grid's shape: enough for specs and audits."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape, dtype=object)


MESHES = {
    "single": FakeMesh((16, 16), ("data", "model")),
    "multi": FakeMesh((2, 16, 16), ("pod", "data", "model")),
}
CACHE = dict(batch=32, max_len=64)


@functools.lru_cache(maxsize=None)
def ref_shapes(arch, **over):
    cfg = dataclasses.replace(jcfg.get_config(arch), **over)
    key = jax.ShapeDtypeStruct((2,), jnp.uint32)
    return cfg, jax.eval_shape(functools.partial(jm.init_params, cfg), key)


def port_vs_ref(jtree, tspecs, pattern_len):
    """(name, port entry tuple, reference entry tuple) for every parameter."""
    for name, spec in tspecs.items():
        head, _, rest = name.partition(".")
        if head != "layers":
            yield name, tuple(spec), tuple(jtree[name])
            continue
        n, _, rest = rest.partition(".")
        node = jtree["blocks"][f"sub{int(n) % pattern_len}"]
        for part in rest.split("."):
            node = node[part]
        yield name, tuple(spec), tuple(node)[1:]


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
@pytest.mark.parametrize("arch", tcfg.ARCH_IDS)
def test_param_and_opt_specs_equal_reference_and_audit_clean(arch, mesh_kind):
    mesh = MESHES[mesh_kind]
    jc, jshape = ref_shapes(arch)
    tc = tcfg.get_config(arch)
    shapes = param_shapes(tc)
    for ref_fn, port_fn in ((jstrat.param_specs, tstrat.param_specs),
                            (jstrat.opt_state_specs, tstrat.opt_state_specs)):
        jspec, tspec = ref_fn(jc, jshape, mesh), port_fn(tc, shapes, mesh)
        pairs = list(port_vs_ref(jspec, tspec, len(tc.pattern)))
        leaves = {tstrat._stacked_path(name, tc) for name in tspec}
        assert len(leaves) == len(jax.tree.leaves(jshape))   # every leaf, once a layer
        for name, got, want in pairs:
            assert got == want, (ref_fn.__name__, name, got, want)
    assert jstrat.audit_divisibility(jc, jshape, mesh) == []
    assert tstrat.audit_divisibility(tc, shapes, mesh) == []
    assert tstrat.audit_divisibility(tc, shapes, mesh,
                                     specs=tstrat.opt_state_specs(tc, shapes, mesh)) == []


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
@pytest.mark.parametrize("arch", tcfg.ARCH_IDS)
def test_cache_specs_equal_reference(arch, mesh_kind):
    mesh = MESHES[mesh_kind]
    jc, tc = jcfg.get_config(arch), tcfg.get_config(arch)
    jcache = jax.eval_shape(lambda: jm.make_cache(jc, CACHE["batch"], CACHE["max_len"]))
    tcache = tm.make_cache(tc, CACHE["batch"], CACHE["max_len"], "meta")
    jspec, tspec = jstrat.cache_specs(jc, jcache, mesh), tstrat.cache_specs(tc, tcache, mesh)
    assert len(tspec) == tc.n_layers
    for n, entry in enumerate(tspec):
        want = jspec[f"sub{n % len(tc.pattern)}"]
        assert set(entry) == set(want)
        for k, spec in entry.items():
            assert tuple(spec) == tuple(want[k])[1:], (n, k)
            assert len(spec) == tcache[n][k].dim()


def test_audit_reports_what_the_reference_reports():
    """A reduced model on the production mesh breaks divisibility: the port
    reports, for each layer's tensor under its stacked leaf's path, the
    reference's violations."""
    jc = jcfg.get_config("qwen2-moe-a2.7b").reduced(moe_d_ff=40)   # 40 % 16
    tc = tcfg.get_config("qwen2-moe-a2.7b").reduced(moe_d_ff=40)
    jshape = jax.eval_shape(functools.partial(jm.init_params, jc),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    want = set(jstrat.audit_divisibility(jc, jshape, MESHES["single"]))
    got = tstrat.audit_divisibility(tc, param_shapes(tc), MESHES["single"])
    assert want and len(got) > len(want)   # a stacked leaf's violation, once a layer
    stacked = {"/".join(tstrat._stacked_path(p.split(": ")[0], tc)) + ": " + p.split(": ")[1]
               for p in got}
    assert stacked == want


def test_kv_replicated_when_small():
    tc = tcfg.get_config("llama3-405b")  # kv 8 < 16
    spec = tstrat.param_specs(tc, param_shapes(tc), MESHES["single"])
    assert spec["layers.0.mixer.wk"][-1] is None
    assert spec["layers.0.mixer.wq"][-1] == "model"


def test_moe_ep_vs_ffn_sharding():
    tc = tcfg.get_config("arctic-480b")   # 128 experts: EP over model
    spec = tstrat.param_specs(tc, param_shapes(tc), MESHES["single"])
    assert spec["layers.0.ffn.w_in"][0] == "model"
    tc = tcfg.get_config("qwen2-moe-a2.7b")   # 60 experts: each expert's ffn over model
    spec = tstrat.param_specs(tc, param_shapes(tc), MESHES["single"])
    assert spec["layers.0.ffn.w_in"][0] is None and spec["layers.0.ffn.w_in"][-1] == "model"


def test_shard_cache_seq_spec():
    tc = dataclasses.replace(tcfg.get_config("llama3-405b"), shard_cache_seq=True)
    spec = tstrat.cache_specs(tc, tm.make_cache(tc, 8, 64, "meta"), MESHES["single"])
    assert spec[0]["k"][2] == "model"   # sequence split
    assert spec[0]["k"][1] is None      # kv heads not split (8 < 16)


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
@pytest.mark.parametrize("arch", ["llava-next-34b", "stablelm-12b"])
def test_batch_specs_and_activation_constraint_equal_reference(arch, mesh_kind):
    mesh = MESHES[mesh_kind]
    jc, tc = jcfg.get_config(arch), tcfg.get_config(arch)
    want = jstrat.batch_specs(jc, mesh)
    got = tstrat.batch_specs(tc, mesh)
    assert set(got) == set(want) and ("patch_embeds" in got) == (tc.frontend == "vlm")
    assert all(tuple(got[k]) == tuple(want[k]) for k in want)
    assert tuple(tstrat.activation_sharding_constraint(mesh)) == tuple(
        jstrat.activation_sharding_constraint(mesh))
    assert tstrat.dp_axes(mesh) == jstrat.dp_axes(mesh)
    assert tstrat.mesh_axis_sizes(mesh) == jstrat.mesh_axis_sizes(mesh)


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "jamba-v0.1-52b"])
def test_train_state_specs_structure_equals_reference(arch, compress):
    mesh = MESHES["multi"]
    jc, jshape = ref_shapes(arch)
    tc = tcfg.get_config(arch)
    want = jstep.train_state_specs(jc, jshape, mesh, compress_grads=compress)
    got = tstep.train_state_specs(tc, param_shapes(tc), mesh, compress_grads=compress)
    assert set(got) == set(want) and set(got["opt"]) == set(want["opt"])
    assert tuple(got["opt"]["step"]) == tuple(want["opt"]["step"]) == ()
    for key, sub in (("params", got["params"]), ("m", got["opt"]["m"]),
                     ("v", got["opt"]["v"])) + ((("ef_error", got["ef_error"]),)
                                                 if compress else ()):
        ref = want[key] if key in ("params", "ef_error") else want["opt"][key]
        for name, g, w in port_vs_ref(ref, sub, len(tc.pattern)):
            assert g == w, (key, name)


@pytest.mark.parametrize("multi", [False, True])
def test_production_meshes_match_reference_and_hold_no_process_group(multi):
    got = tmesh.make_production_mesh(multi_pod=multi)
    assert got.axis_names == (("pod", "data", "model") if multi else ("data", "model"))
    assert got.devices.shape == ((2, 16, 16) if multi else (16, 16))
    assert got.size == tmesh.required_devices(multi) == jmesh.required_devices(multi)
    assert got._groups == {} and not dist.is_initialized()
    assert got.devices.ravel().tolist() == list(range(got.size))


def test_mesh_context_as_reference():
    assert tctx.get_mesh() is None and jctx.get_mesh() is None
    a, b = object(), object()
    with tctx.mesh_context(a):
        assert tctx.get_mesh() is a
        with tctx.mesh_context(b):
            assert tctx.get_mesh() is b
        assert tctx.get_mesh() is a
    assert tctx.get_mesh() is None
    tctx.set_mesh(a)
    try:
        assert tctx.get_mesh() is a
    finally:
        tctx.set_mesh(None)


def test_partition_spec_is_a_tuple_of_entries():
    spec = tstrat.P(("pod", "data"), None, "model")
    assert tuple(spec) == (("pod", "data"), None, "model") and len(spec) == 3
    assert tstrat.axes_of(spec[0]) == ("pod", "data") and tstrat.axes_of(spec[1]) == ()
    assert tuple(tstrat.P()) == ()
