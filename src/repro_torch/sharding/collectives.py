"""Collectives over a mesh axis, and the autograd pieces that tensor,
data and expert parallelism are built from. The one module of the port
that calls ``torch.distributed``.

Each operation takes a mesh axis or a tuple of axes (their product group,
the first axis major, ``launch.mesh.Mesh.group``) and the mesh (default:
``sharding.context.get_mesh()``). On an axis of size 1 it returns its input
and runs nothing. The kinds are ``all_reduce`` (sum or max),
``all_gather``, ``reduce_scatter`` and ``all_to_all``, on
``all_reduce`` / ``all_gather_into_tensor`` / ``reduce_scatter_tensor`` /
``all_to_all_single``, names that torch 2.11 and 2.13 both have.

**Counting.** Each kind's calls and the bytes this rank hands to them (a
half type's sum: its f32 copy) are counted (:func:`counts`,
:func:`reset_counts`), as ``native.launch`` counts kernel launches; a
gather given a ``tag`` is also counted under it (``counts()["tags"]``).

**The backend rule.** NCCL when every rank has a card of its own
(:func:`backend_for`). NCCL refuses ranks that share one device, so ranks
that share a card run on gloo, which the caller passes to
``init_process_group``. gloo runs every collective on the host: on a CUDA
tensor it copies the input to host memory and the result back itself
(torch 2.11 on the H100 and 2.13 here have such paths for all four kinds),
so this module hands it CUDA tensors as they are and counts those bytes,
in and out, as ``host_staged_bytes``.

**Sums of half types** (bf16, f16) run in f32 and are cast back once, on
every backend: the result does not depend on the order of a low-precision
reduction, and an exact sum (one non-zero term, as the vocabulary lookup's)
stays exact.
"""
from __future__ import annotations

import threading

import torch
import torch.distributed as dist

from .context import get_mesh

KINDS = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all")
_lock = threading.Lock()
_calls = dict.fromkeys(KINDS, 0)
_bytes = dict.fromkeys(KINDS, 0)
_staged = [0]
_tags: dict[str, dict[str, int]] = {}


def counts() -> dict:
    """``{"calls": {kind: n}, "bytes": {kind: n}, "host_staged_bytes": n,
    "tags": {tag: {"calls": n, "bytes": n}}}`` since the last
    :func:`reset_counts`."""
    with _lock:
        return {"calls": dict(_calls), "bytes": dict(_bytes), "host_staged_bytes": _staged[0],
                "tags": {t: dict(c) for t, c in _tags.items()}}


def reset_counts() -> None:
    with _lock:
        for k in KINDS:
            _calls[k] = _bytes[k] = 0
        _staged[0] = 0
        _tags.clear()


def backend_for(device: str | torch.device, ranks_per_card: int) -> str:
    """The process group's backend: ``"nccl"`` when ranks run on cards of
    their own, ``"gloo"`` when they are on the CPU or share a card."""
    return "nccl" if torch.device(device).type == "cuda" and ranks_per_card == 1 else "gloo"


def _count(kind: str, group, x: torch.Tensor, out: torch.Tensor,
           tag: str | None = None) -> None:
    with _lock:
        _calls[kind] += 1
        _bytes[kind] += x.numel() * x.element_size()
        if tag is not None:
            c = _tags.setdefault(tag, {"calls": 0, "bytes": 0})
            c["calls"] += 1
            c["bytes"] += x.numel() * x.element_size()
        if x.is_cuda and dist.get_backend(group) == "gloo":
            _staged[0] += (x.numel() * x.element_size() + out.numel() * out.element_size())


def _group(axis, mesh):
    mesh = get_mesh() if mesh is None else mesh
    if mesh is None:
        raise RuntimeError("no mesh: pass one or set it with sharding.context")
    return mesh, mesh.axis_size(axis)


def _wide(x: torch.Tensor) -> torch.Tensor:
    return x.float() if x.dtype in (torch.bfloat16, torch.float16) else x


def all_reduce(x: torch.Tensor, axis, op: str = "sum", mesh=None) -> torch.Tensor:
    """The sum (``op="sum"``) or maximum (``"max"``) of x over the axis's
    ranks, as a new tensor of x's dtype."""
    mesh, n = _group(axis, mesh)
    if n == 1:
        return x
    group, _ = mesh.group(axis)
    y = (_wide(x) if op == "sum" else x).contiguous().clone()
    reduce_op = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    dist.all_reduce(y, op=reduce_op, group=group)
    _count("all_reduce", group, y, y)
    return y.to(x.dtype)


def all_gather(x: torch.Tensor, axis, dim: int = 0, mesh=None,
               tag: str | None = None) -> torch.Tensor:
    """The axis's ranks' x concatenated along ``dim`` in axis order."""
    mesh, n = _group(axis, mesh)
    if n == 1:
        return x
    group, _ = mesh.group(axis)
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * src.shape[0], *src.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, src, group=group)
    _count("all_gather", group, src, out, tag)
    return out.movedim(0, dim)


def reduce_scatter(x: torch.Tensor, axis, dim: int = 0, mesh=None) -> torch.Tensor:
    """The sum of x over the axis's ranks, split along ``dim`` into as many
    equal parts: this rank's part (its index along the axis)."""
    mesh, n = _group(axis, mesh)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} does not split {n} ways")
    group, _ = mesh.group(axis)
    src = _wide(x).movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // n, *src.shape[1:]), dtype=src.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, src, group=group)
    _count("reduce_scatter", group, src, out)
    return out.movedim(0, dim).to(x.dtype)


def all_to_all(x: torch.Tensor, axis, mesh=None) -> torch.Tensor:
    """x split along dim 0 into as many equal parts as the axis has ranks;
    part j goes to rank j, and the result holds the parts received, in
    axis order."""
    mesh, n = _group(axis, mesh)
    if n == 1:
        return x
    if x.shape[0] % n:
        raise ValueError(f"all_to_all: {x.shape[0]} rows do not split {n} ways")
    group, _ = mesh.group(axis)
    src = x.contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    _count("all_to_all", group, src, out)
    return out


# ---------------------------------------------------------------------------
# autograd pieces (Megatron's f and g, the FSDP gather)
# ---------------------------------------------------------------------------

class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.axis, ctx.mesh = axis, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.axis, mesh=ctx.mesh), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        return all_reduce(x, axis, mesh=mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, mesh, tag):
        ctx.axis, ctx.dim, ctx.mesh = axis, dim, mesh
        return all_gather(x, axis, dim, mesh, tag)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.axis, ctx.dim, ctx.mesh), None, None, None, None


def copy_to(x: torch.Tensor, axis, mesh=None) -> torch.Tensor:
    """x as it is; its gradient summed over the axis. Marks where a tensor
    every rank of the axis holds enters work that each rank does in part
    (column-parallel products, an expert shard's dispatch)."""
    mesh = get_mesh() if mesh is None else mesh
    return x if mesh.axis_size(axis) == 1 else _CopyTo.apply(x, axis, mesh)


def reduce_from(x: torch.Tensor, axis, mesh=None) -> torch.Tensor:
    """The sum of the axis's partial x (``all_reduce``); the gradient passes
    unchanged to each rank's part."""
    mesh = get_mesh() if mesh is None else mesh
    return x if mesh.axis_size(axis) == 1 else _ReduceFrom.apply(x, axis, mesh)


def gather_from(x: torch.Tensor, axis, dim: int, mesh=None,
                tag: str | None = None) -> torch.Tensor:
    """The axis's shards of x joined along ``dim`` (an FSDP weight before
    use); the gradient is summed over the axis and split back
    (``reduce_scatter``), so each rank gets its shard's whole gradient.
    ``tag`` counts the forward's gather under that name too."""
    mesh = get_mesh() if mesh is None else mesh
    return x if mesh.axis_size(axis) == 1 else _GatherFrom.apply(x, axis, dim, mesh, tag)
