"""Device meshes over ``torch.distributed`` ranks: the counterpart of
``repro.launch.mesh``.

A :class:`Mesh` names its axes and holds the grid of ranks (``devices``,
row-major over the shape, as ``jax.make_mesh`` lays devices out). It makes
its process groups on first use of an axis (one ``dist.new_group`` for
every slice along that axis, on every rank in the same order), so building
a mesh touches no process group: ``make_production_mesh`` gives the
(16, 16) and (2, 16, 16) meshes the specs are written for, with no process
anywhere. ``make_local_mesh`` needs the process group of its ranks
initialised.
"""
from __future__ import annotations

import numpy as np
import torch.distributed as dist


class Mesh:
    """Axis names, a shape, and the grid of ranks in ``devices`` (a numpy
    array of that shape). An axis argument below is one axis name or a
    tuple of them (their product, the first axis major)."""

    def __init__(self, shape, axis_names):
        shape, axis_names = tuple(shape), tuple(axis_names)
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh shape {shape} does not match axes {axis_names}")
        self.axis_names = axis_names
        self.devices = np.arange(int(np.prod(shape))).reshape(shape)
        self._groups: dict[tuple[str, ...], tuple] = {}

    def __repr__(self) -> str:
        return f"Mesh({dict(zip(self.axis_names, self.devices.shape))})"

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def _axes(self, axis) -> tuple[str, ...]:
        axes = tuple(axis) if isinstance(axis, tuple) else (axis,)
        for a in axes:
            if a not in self.axis_names:
                raise ValueError(f"{a!r} is not an axis of {self}")
        return axes

    def axis_size(self, axis) -> int:
        sizes = dict(zip(self.axis_names, self.devices.shape))
        return int(np.prod([sizes[a] for a in self._axes(axis)], dtype=np.int64))

    def coords(self, rank: int | None = None) -> dict[str, int]:
        """A rank's index along each axis (default: this process's rank)."""
        rank = dist.get_rank() if rank is None else rank
        where = np.argwhere(self.devices == rank)
        if len(where) != 1:
            raise ValueError(f"rank {rank} is not in {self}")
        return dict(zip(self.axis_names, (int(i) for i in where[0])))

    def axis_index(self, axis, rank: int | None = None) -> int:
        """A rank's index along ``axis`` (for a tuple, the mixed-radix
        index, the first axis major)."""
        c = self.coords(rank)
        sizes = dict(zip(self.axis_names, self.devices.shape))
        idx = 0
        for a in self._axes(axis):
            idx = idx * sizes[a] + c[a]
        return idx

    def slices(self, axis) -> np.ndarray:
        """Every group of ranks along ``axis``: rows of the grid with the
        axis (or axes, first major) moved last, each row in axis order."""
        axes = self._axes(axis)
        rest = [self.axis_names.index(a) for a in self.axis_names if a not in axes]
        order = rest + [self.axis_names.index(a) for a in axes]
        return self.devices.transpose(order).reshape(-1, self.axis_size(axes))

    def group(self, axis):
        """``(process group, ranks)`` of this rank's slice along ``axis``.
        The first call for an axis makes the groups of all its slices, in
        order, on every rank: the ranks must reach it together, as they
        reach every collective."""
        axes = self._axes(axis)
        if axes not in self._groups:
            if not dist.is_initialized():
                raise RuntimeError(f"{self}: no process group is initialised")
            if dist.get_world_size() != self.size:
                raise RuntimeError(f"{self} needs {self.size} ranks, the process group has "
                                   f"{dist.get_world_size()}")
            me = dist.get_rank()
            mine = None
            for row in self.slices(axes):
                ranks = [int(r) for r in row]
                g = dist.new_group(ranks)
                if me in ranks:
                    mine = (g, ranks)
            self._groups[axes] = mine
        return self._groups[axes]


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_local_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A (data, model) mesh over the ranks of the initialised process group,
    which must hold ``data · model`` of them (rank r at row r // model,
    column r % model)."""
    if not dist.is_initialized():
        raise RuntimeError("make_local_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    if dist.get_world_size() != data * model:
        raise ValueError(f"a {data} x {model} mesh needs {data * model} ranks, the process "
                         f"group has {dist.get_world_size()}")
    return Mesh((data, model), ("data", "model"))


def required_devices(multi_pod: bool) -> int:
    return 512 if multi_pod else 256
