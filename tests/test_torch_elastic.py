"""``runtime.elastic_restore`` in the port against the JAX package's.

One state tree (f32 and bf16 leaves, an int32 step, nested mappings and a
list) is made with numpy from a seed, saved by the port's
``CheckpointManager`` and by the reference's, and restored from each flat
dict by both packages' ``elastic_restore`` onto the same template: every
leaf must come back bitwise, under the same "/"-joined keys, in the
template's dtype; the port's with ``shardings=None`` (each template leaf's
device) and with a pytree of ``torch.device("cpu")``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RefCheckpointManager
from repro.runtime.ft import elastic_restore as ref_elastic_restore
from repro_torch import configs as tcfg
from repro_torch import models as tm
from repro_torch.checkpoint import CheckpointManager
from repro_torch.launch import mesh as tmesh
from repro_torch.runtime import elastic_restore
from repro_torch.sharding import layout, strategy


def arrays(seed=5):
    rng = np.random.default_rng(seed)
    return {
        "params": {
            "w": rng.standard_normal((4, 3)).astype(np.float32),
            "b": rng.standard_normal(3).astype(np.float32),
            "layers": [rng.standard_normal((2, 2)).astype(np.float32)
                       for _ in range(2)],
        },
        "mu": rng.standard_normal((3, 5)).astype(np.float32),  # stored bf16
        "step": np.asarray(7, np.int32),
    }


def port_tree(a):
    return {
        "params": {"w": torch.from_numpy(a["params"]["w"]),
                   "b": torch.from_numpy(a["params"]["b"]),
                   "layers": [torch.from_numpy(x) for x in a["params"]["layers"]]},
        "mu": torch.from_numpy(a["mu"]).to(torch.bfloat16),
        "step": torch.from_numpy(a["step"]),
    }


def ref_tree(a):
    return {
        "params": {"w": jnp.asarray(a["params"]["w"]),
                   "b": jnp.asarray(a["params"]["b"]),
                   "layers": [jnp.asarray(x) for x in a["params"]["layers"]]},
        "mu": jnp.asarray(a["mu"]).astype(jnp.bfloat16),
        "step": jnp.asarray(a["step"]),
    }


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}/{k}" if prefix else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}/{i}" if prefix else str(i))
    else:
        yield prefix, tree


def bits(x):
    """A leaf's dtype name and bytes (bf16 through its 16-bit view)."""
    if isinstance(x, torch.Tensor):
        name = str(x.dtype).removeprefix("torch.")
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return name, x.cpu().numpy().tobytes()
    x = np.asarray(x)
    return str(x.dtype), x.tobytes()


def assert_same_leaves(got, want):
    g, w = dict(leaves(got)), dict(leaves(want))
    assert sorted(g) == sorted(w)
    for key in w:
        assert bits(g[key]) == bits(w[key]), key


def as_numpy_flat(flat):
    """The port's restored flat dict as numpy for the reference (bf16
    widened to f32, which the reference narrows back exactly)."""
    return {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
            for k, v in flat.items()}


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("placement", ["none", "devices"])
def test_elastic_restore_matches_reference(tmp_path, writer, placement):
    a = arrays()
    if writer == "port":
        mgr = CheckpointManager(tmp_path)
        mgr.save(port_tree(a), 3, blocking=True)
        flat = mgr.restore_flat()
        ref_flat = as_numpy_flat(flat)
    else:
        mgr = RefCheckpointManager(tmp_path)
        mgr.save(ref_tree(a), 3, blocking=True)
        flat = ref_flat = mgr.restore_flat()
    # a template of other values: only its structure, dtypes and devices count
    template = port_tree(arrays(seed=99))
    shardings = None
    if placement == "devices":
        shardings = {
            "params": {"w": torch.device("cpu"), "b": torch.device("cpu"),
                       "layers": [torch.device("cpu")] * 2},
            "mu": torch.device("cpu"), "step": torch.device("cpu"),
        }
    got = elastic_restore(flat, template, shardings)
    want = ref_elastic_restore(ref_flat, ref_tree(arrays(seed=99)))
    assert_same_leaves(got, want)
    assert_same_leaves(got, port_tree(a))
    assert got["mu"].dtype == torch.bfloat16 and got["step"].dtype == torch.int32
    assert isinstance(got["params"]["layers"], list)


def test_elastic_restore_takes_template_dtypes_and_copies():
    flat = {"a": np.arange(4, dtype=np.float64), "b": torch.ones(2)}
    template = {"a": torch.zeros(4, dtype=torch.float32),
                "b": torch.zeros(2, dtype=torch.bfloat16)}
    got = elastic_restore(flat, template)
    assert got["a"].dtype == torch.float32 and got["b"].dtype == torch.bfloat16
    assert got["a"].tolist() == [0.0, 1.0, 2.0, 3.0]
    got["a"][0] = 5.0
    assert flat["a"][0] == 0.0   # the flat dict is never aliased
    want = ref_elastic_restore({"a": flat["a"], "b": np.ones(2, np.float32)},
                               {"a": jnp.zeros(4, jnp.float32),
                                "b": jnp.zeros(2, jnp.bfloat16)})
    assert bits(got["b"]) == bits(want["b"])


def test_elastic_restore_refuses_other_placements():
    template = {"w": torch.zeros(2), "b": torch.zeros(1)}
    flat = {"w": np.zeros(2, np.float32), "b": np.zeros(1, np.float32)}
    with pytest.raises(TypeError, match="placement 'data'"):
        elastic_restore(flat, template, {"w": "data", "b": "data"})
    with pytest.raises(ValueError, match="placements"):
        elastic_restore(flat, template, {"w": torch.device("cpu")})
    with pytest.raises(KeyError):
        elastic_restore({"w": flat["w"]}, template)


def test_device_placements_are_matched_by_path():
    """A placement pytree built in another key order places each leaf by
    its path, as before."""
    a = arrays()
    flat = {f"params/{k}": v for k, v in (("w", a["params"]["w"]), ("b", a["params"]["b"]))}
    template = {"params": {"w": torch.zeros(4, 3), "b": torch.zeros(3, dtype=torch.bfloat16)}}
    got = elastic_restore(flat, template,
                          {"params": {"b": torch.device("cpu"), "w": torch.device("cpu")}})
    assert torch.equal(got["params"]["w"], torch.from_numpy(a["params"]["w"]))
    assert got["params"]["b"].dtype == torch.bfloat16


@pytest.mark.parametrize("rank", range(4))
def test_named_sharding_restores_the_rank_shard(tmp_path, monkeypatch, rank):
    """A whole reduced mamba2-2.7b written by ``CheckpointManager`` and
    restored with ``NamedSharding`` placements on a 2 x 2 mesh gives rank
    ``rank`` exactly ``shard_tensor``'s cut of every tensor, SSD heads and
    d_inner split over ``model``."""
    cfg = tcfg.get_config("mamba2-2.7b").reduced(dtype="float32")
    whole = dict(tm.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
                 .named_parameters())
    CheckpointManager(tmp_path).save({"params": whole}, 1, blocking=True)
    mesh = tmesh.Mesh((2, 2), ("data", "model"))
    monkeypatch.setattr(tmesh.dist, "get_rank", lambda: rank)
    specs = strategy.param_specs(cfg, whole, mesh)
    template = {"params": {k: torch.empty(
        layout.shard_tensor(t, specs[k], mesh).shape) for k, t in whole.items()}}
    got = elastic_restore(CheckpointManager(tmp_path).restore_flat(), template,
                          {"params": layout.named_shardings(specs, mesh)})
    for k, t in whole.items():
        assert torch.equal(got["params"][k], layout.shard_tensor(t, specs[k], mesh)), k
    h = mesh.axis_index("model") * cfg.ssm_heads // 2
    assert torch.equal(got["params"]["layers.0.mixer.a_log"],
                       whole["layers.0.mixer.a_log"][h:h + cfg.ssm_heads // 2])


def test_named_sharding_refuses_a_template_of_another_shape(monkeypatch):
    monkeypatch.setattr(tmesh.dist, "get_rank", lambda: 0)
    mesh = tmesh.Mesh((1, 2), ("data", "model"))
    place = layout.NamedSharding(mesh, strategy.P(None, "model"))
    with pytest.raises(ValueError, match="shard of shape"):
        elastic_restore({"w": np.zeros((2, 4), np.float32)}, {"w": torch.zeros(2, 4)},
                        {"w": place})
