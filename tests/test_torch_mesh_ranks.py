"""Ranks of a mesh on the CPU, for the sharding tests, and the mesh's own
tests.

:func:`run_ranks` starts ``world`` ranks in fresh interpreters (start
method ``spawn``), each with one thread, meeting through a ``FileStore`` in
the test's temporary directory on the gloo backend; each runs one of this
module's rank programs and saves what it returns. The ranks are joined
within the caller's time limit, then killed, and the call fails. This
module imports neither JAX nor the JAX package, so neither do the ranks
(each checks so at its end): reference outputs reach them as ``.npz``
files that the test process writes.
"""
from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import configs as tcfg
from repro_torch import models as tm
from repro_torch.checkpoint import CheckpointManager
from repro_torch.launch import mesh as tmesh
from repro_torch.models import layers as tl
from repro_torch.runtime import elastic_restore
from repro_torch.serve import greedy_generate
from repro_torch.sharding import collectives as C
from repro_torch.sharding import compression as tcomp
from repro_torch.sharding import layout, strategy
from repro_torch.sharding.context import mesh_context
from repro_torch.train import optimizer as topt
from repro_torch.train import step as tstep

BANNED = ("jax", "jaxlib", "repro")


def _rank_entry(program: str, rank: int, world: int, root: str, kw: dict) -> None:
    torch.set_num_threads(1)
    out = Path(root)
    try:
        store = dist.FileStore(str(out / "store"), world)
        dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
        try:
            result = PROGRAMS[program](rank, world, out, **kw)
        finally:
            dist.destroy_process_group()
        bad = sorted(k for k in sys.modules if k.split(".")[0] in BANNED)
        if bad:
            raise AssertionError(f"rank {rank} imported {bad}")
        torch.save(result, out / f"rank{rank}.pt")
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        os._exit(1)


def run_ranks(program: str, world: int, root: Path, timeout: float, **kw) -> list:
    """Each rank's result of ``PROGRAMS[program](rank, world, root, **kw)``."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_entry, args=(program, r, world, str(root), kw))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(10)
    errors = [(root / f"rank{r}.err").read_text() for r in range(world)
              if (root / f"rank{r}.err").exists()]
    if alive:
        pytest.fail(f"{program}: {len(alive)} of {world} ranks still ran after {timeout} s "
                    f"and were killed\n" + "\n".join(errors))
    codes = [p.exitcode for p in procs]
    if errors or any(codes):
        pytest.fail(f"{program}: exit codes {codes}\n" + "\n".join(errors))
    return [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(world)]


# ---------------------------------------------------------------------------
# configurations shared with the test files
# ---------------------------------------------------------------------------

# the reference's own reduction of qwen2-moe-a2.7b
# (tests/sharding/test_strategy.py::test_sharded_train_and_decode_execute_on_8_devices)
QWEN = dict(d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256, moe_experts=8,
            moe_top_k=2, head_dim=16, dtype="float32")
GQA = dict(n_heads=8, n_kv_heads=2, dtype="float32")


def to_tensors(arrays) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()}


def model_from(cfg, arrays) -> tm.Transformer:
    """A whole model on the CPU with the given weights (name → array)."""
    model = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(torch.from_numpy(np.array(arrays[k])))
    return model


def local_batch(batch: dict, mesh) -> dict:
    """This rank's data shard of a global batch (``batch_specs``)."""
    dp = strategy.dp_axes(mesh)
    return {k: layout.shard_tensor(v, strategy.P(dp, *([None] * (v.dim() - 1))), mesh)
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# rank programs
# ---------------------------------------------------------------------------

def prog_collectives(rank, world, root):
    """Every collective over each axis of a 2 x 2 mesh and over both, on
    inputs made from the rank's number; ``compressed_psum`` on the rows of
    ``root/psum.npz``."""
    mesh = tmesh.make_local_mesh(2, 2)
    with mesh_context(mesh):
        return _collectives(mesh, rank, root)


def _collectives(mesh, rank, root):
    out = {"coords": mesh.coords()}
    x = torch.arange(12, dtype=torch.float32).reshape(4, 3) * (rank + 1)
    for axis in ("data", "model", ("data", "model")):
        key = axis if isinstance(axis, str) else "both"
        out[f"sum_{key}"] = C.all_reduce(x, axis)
        out[f"max_{key}"] = C.all_reduce(x - 5 * rank, axis, "max")
        out[f"bf16_{key}"] = C.all_reduce(x.to(torch.bfloat16) / 3, axis)
        out[f"gather0_{key}"] = C.all_gather(x, axis, 0)
        out[f"gather1_{key}"] = C.all_gather(x, axis, 1)
        out[f"scatter0_{key}"] = C.reduce_scatter(x, axis, 0) if x.shape[0] % mesh.axis_size(
            axis) == 0 else None
        out[f"a2a_{key}"] = C.all_to_all(x, axis)
        out[f"int_{key}"] = C.all_reduce(torch.arange(4, dtype=torch.int32) + rank, axis)
    rows = np.load(root / "psum.npz")["x"]
    out["psum_model"] = tcomp.compressed_psum(torch.from_numpy(rows[rank]), "model")
    out["psum_both"] = tcomp.compressed_psum(torch.from_numpy(rows[rank]), ("data", "model"))
    out["counts"] = C.counts()
    return out


def prog_autograd(rank, world, root):
    """copy_to / reduce_from / gather_from gradients on a 2 x 2 mesh."""
    mesh = tmesh.make_local_mesh(2, 2)
    with mesh_context(mesh):
        x = torch.full((2, 3), float(rank + 1), requires_grad=True)
        y = C.reduce_from(C.copy_to(x, "model") * (rank + 1), "model")
        (gx,) = torch.autograd.grad((y * torch.arange(6.).reshape(2, 3)).sum(), x)
        w = (torch.arange(6.).reshape(3, 2) + 10 * rank).requires_grad_(True)
        full = C.gather_from(w, "data", 0)
        (gw,) = torch.autograd.grad((full * (rank + 1)).sum(), w)
    return {"y": y.detach(), "gx": gx, "full": full.detach(), "gw": gw}


def prog_forward(rank, world, root, cases):
    """Each case of ``cases`` (:func:`forward_case`) on the files of
    ``root/<name>``."""
    return {c["name"]: forward_case(root / c["name"], **c) for c in cases}


def forward_case(root, name, arch, over, mesh_shape, fsdp, moe_impl, seq):
    """The sharded forward (logits, aux, MoE drops and routing) on
    ``weights.npz`` and ``tokens.npy``, and a prefill of the first ``seq``
    tokens with one decode step a further token, the logits and the cache
    gathered back to whole tensors."""
    cfg = dataclasses.replace(tcfg.get_config(arch).reduced(**over), fsdp_params=fsdp,
                              moe_impl=moe_impl)
    mesh = tmesh.make_local_mesh(*mesh_shape)
    model = layout.shard_params(model_from(cfg, np.load(root / "weights.npz")), mesh)
    tokens = torch.from_numpy(np.load(root / "tokens.npy"))
    tok = local_batch({"t": tokens}, mesh)["t"]
    out = {}
    with mesh_context(mesh), torch.no_grad():
        stats = {"routing": []}
        logits, aux, _ = tm.forward(cfg, model, tok, moe_stats=stats)
        out.update(logits=_gather_logits(logits, mesh), aux=float(aux),
                   dropped=stats.get("dropped", 0), routing=stats["routing"])
        cache = tm.make_cache(cfg, tokens.shape[0], tokens.shape[1], "cpu")
        last, cache = tm.prefill(cfg, model, tok[:, :seq], cache)
        steps = [_gather_logits(last, mesh)]
        for i in range(seq, tokens.shape[1]):
            lg, cache = tm.decode_step(cfg, model, tok[:, i], cache, i)
            steps.append(_gather_logits(lg, mesh))
        out["serve"] = torch.stack(steps, 1)
        specs = strategy.cache_specs(cfg, cache, mesh)
        out["cache"] = [{k: layout.gather_tensor(v, specs[n][k], mesh) for k, v in c.items()}
                        for n, c in enumerate(cache)]
    return out


def _gather_logits(logits, mesh):
    """Whole logits from each rank's rows and vocabulary columns."""
    spec = strategy.P(strategy.dp_axes(mesh), *([None] * (logits.dim() - 2)), "model")
    return layout.gather_tensor(logits, spec, mesh)


def prog_train(rank, world, root, cases):
    """Each case of ``cases`` (:func:`train_case`) on the files of
    ``root/<name>``."""
    return {c["name"]: train_case(root / c["name"], **c) for c in cases}


def train_case(root, name, arch, over, mesh_shape, fsdp, compress, opt, dp, rows):
    """One sharded train step on ``weights.npz`` and ``batch.npz``; the
    metrics, the whole updated state and the collectives' counts."""
    cfg = dataclasses.replace(tcfg.get_config(arch).reduced(**over), fsdp_params=fsdp)
    mesh = tmesh.make_local_mesh(*mesh_shape)
    model = layout.shard_params(model_from(cfg, np.load(root / "weights.npz")), mesh)
    batch = local_batch(to_tensors(np.load(root / "batch.npz")), mesh)
    C.reset_counts()
    with mesh_context(mesh):
        state = tstep.init_train_state(cfg, model, compress_grads=compress)
        step = tstep.make_train_step(cfg, topt.AdamWConfig(**opt), dp=dp, global_rows=rows,
                                     compress_grads=compress)
        state, met = step(state, batch)
        counts = C.counts()
        whole = layout.gather_train_state(cfg, state, mesh)
    return {"metrics": {k: float(v) for k, v in met.items()}, "state": whole,
            "step": int(state["opt"]["step"]), "counts": counts}


def prog_ssm(rank, world, root, forward, train):
    """The Mamba-2 and hybrid cases of ``test_torch_sharded_ssm`` in one
    spawn: each of ``forward`` (:func:`ssm_serve_case`) and each of
    ``train`` (:func:`ssm_train_case`) on the files of ``root/<name>``."""
    out = {c["name"]: ssm_serve_case(root / c["name"], **c) for c in forward}
    out.update({c["name"]: ssm_train_case(root / c["name"], **c) for c in train})
    return out


def ssm_serve_case(root, name, arch, over, mesh_shape, fsdp, seq, new, naive_norm=False):
    """:func:`forward_case`, then ``greedy_generate`` of ``new`` tokens on
    the mesh from the first ``seq`` tokens of every row (the global prompt;
    every rank returns the global tokens), and ``elastic_restore`` of the
    whole weights' checkpoint (``root/ckpt``) onto this rank's shards
    against ``shard_params``. With ``naive_norm`` only the forward's logits,
    with the gated norm run on each rank's d_inner columns alone."""
    if naive_norm:
        cfg = dataclasses.replace(tcfg.get_config(arch).reduced(**over), fsdp_params=fsdp)
        mesh = tmesh.make_local_mesh(*mesh_shape)
        model = layout.shard_params(model_from(cfg, np.load(root / "weights.npz")), mesh)
        tok = local_batch({"t": torch.from_numpy(np.load(root / "tokens.npy"))}, mesh)["t"]
        gated = tl._gated_norm
        tl._gated_norm = _norm_on_local_columns
        try:
            with mesh_context(mesh), torch.no_grad():
                logits = tm.forward(cfg, model, tok)[0]
        finally:
            tl._gated_norm = gated
        return {"logits": _gather_logits(logits, mesh)}
    C.reset_counts()
    out = forward_case(root, name, arch, over, mesh_shape, fsdp, "gather", seq)
    cfg = dataclasses.replace(tcfg.get_config(arch).reduced(**over), fsdp_params=fsdp)
    mesh = tmesh.make_local_mesh(*mesh_shape)
    whole = model_from(cfg, np.load(root / "weights.npz"))
    model = layout.init_sharded_params(cfg, torch.Generator().manual_seed(1), mesh, "cpu")
    prompt = torch.from_numpy(np.load(root / "tokens.npy"))[:, :seq]
    with mesh_context(mesh):
        named = dict(model.named_parameters())
        restored = elastic_restore(
            CheckpointManager(root / "ckpt").restore_flat(), {"params": named},
            {"params": layout.named_shardings(strategy.param_specs(cfg, named, mesh), mesh)})
        with torch.no_grad():
            for k, p in named.items():
                p.copy_(restored["params"][k])
        want = dict(layout.shard_params(whole, mesh).named_parameters())
        out["restore_bitwise"] = all(torch.equal(restored["params"][k], want[k]) for k in want)
        out["restore_shapes"] = {k: tuple(t.shape) for k, t in restored["params"].items()}
        out["greedy"] = greedy_generate(cfg, model, prompt, new, device="cpu")
    out["counts"] = C.counts()
    return out


def _norm_on_local_columns(cfg, g, w, mesh):
    """The gated norm done wrong: RMSNorm over the rank's d_inner columns
    of g alone, with its columns of norm_w."""
    first, di = mesh.axis_index("model") * g.shape[-1], g.shape[-1]
    return tl.ops.rmsnorm(g, w[first:first + di].contiguous(), eps=cfg.norm_eps)


def ssm_train_case(root, name, arch, over, mesh_shape, fsdp, opt, dp, rows):
    """:func:`train_case`, then ``elastic_restore`` of the reference's
    whole state after the step (``root/ckpt``: params, m, v and the step)
    onto this rank's shards by ``train_state_specs`` (the params by
    ``param_specs``, the moments by ``opt_state_specs``) against the shards
    cut by ``shard_tensor`` and ``zero_slice``."""
    out = train_case(root, name, arch, over, mesh_shape, fsdp, False, opt, dp, rows)
    cfg = dataclasses.replace(tcfg.get_config(arch).reduced(**over), fsdp_params=fsdp)
    mesh = tmesh.make_local_mesh(*mesh_shape)
    model = layout.init_sharded_params(cfg, torch.Generator().manual_seed(1), mesh, "cpu")
    flat = CheckpointManager(root / "ckpt").restore_flat()
    with mesh_context(mesh):
        state = tstep.init_train_state(cfg, model)
        named = {k: p.detach() for k, p in model.named_parameters()}
        specs = tstep.train_state_specs(cfg, named, mesh)
        got = elastic_restore(flat, {"params": named, "opt": state["opt"]},
                              layout.named_shardings(specs, mesh))
    pspec, ospec = specs["params"], specs["opt"]["m"]
    same = torch.equal(got["opt"]["step"], flat["opt/step"])
    for k in named:
        cut = layout.shard_tensor(flat[f"params/{k}"], pspec[k], mesh,
                                  fused_last=layout.is_fused(k))
        same &= torch.equal(got["params"][k], cut)
        for key in ("m", "v"):
            part = layout.zero_slice(layout.shard_tensor(flat[f"opt/{key}/{k}"], pspec[k], mesh,
                                                         fused_last=layout.is_fused(k)),
                                     pspec[k], ospec[k], mesh)
            same &= torch.equal(got["opt"][key][k], part)
    out["restore_bitwise"] = bool(same)
    return out


PROGRAMS = {"collectives": prog_collectives, "autograd": prog_autograd,
            "forward": prog_forward, "train": prog_train, "ssm": prog_ssm}


# ---------------------------------------------------------------------------
# the mesh's own tests (no process group)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axis,want", [
    ("model", [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11]]),
    ("data", [[0, 4, 8], [1, 5, 9], [2, 6, 10], [3, 7, 11]]),
    (("data", "model"), [list(range(12))]),
    (("model", "data"), [[0, 4, 8, 1, 5, 9, 2, 6, 10, 3, 7, 11]]),
])
def test_mesh_slices_are_row_major_with_the_first_axis_major(axis, want):
    mesh = tmesh.Mesh((3, 4), ("data", "model"))
    assert mesh.slices(axis).tolist() == want
    for row in want:
        for i, r in enumerate(row):
            assert mesh.axis_index(axis, r) == i


def test_make_local_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_local_mesh(2, 2)


@pytest.mark.parametrize("fused", [False, True])
def test_shard_and_gather_are_inverse_over_every_rank(fused):
    """``shard_tensor`` of each rank of a (2, 3) mesh, concatenated as
    ``gather_tensor`` concatenates, gives the whole tensor back; the fused
    gate|up dimension gives each rank its own part of both halves."""
    mesh = tmesh.Mesh((2, 3), ("data", "model"))
    t = torch.arange(4 * 12, dtype=torch.float32).reshape(4, 12)
    spec = strategy.P("data", "model")
    parts = [[layout.shard_tensor(t, spec, mesh, r, fused) for r in mesh.devices[i]]
             for i in range(2)]
    if fused:   # rank (0, j): gate columns [2j, 2j+2) and up columns [6+2j, 6+2j+2)
        for j in range(3):
            want = torch.cat([t[:2, 2 * j:2 * j + 2], t[:2, 6 + 2 * j:8 + 2 * j]], 1)
            assert torch.equal(parts[0][j], want)
    rows = torch.cat([torch.cat(r, 1) for r in parts], 0)
    if fused:
        rows = layout._deinterleave(rows, 1, 3)
    assert torch.equal(rows, t)
