"""The mesh the model's layers run on: the counterpart of
``repro.sharding.context``. Set by a launcher, a rank's program or a test
before the forward; ``None`` (the default) runs every layer whole on one
device. With a mesh set, every parameter and cache tensor the forward
reads is the rank's local shard (``sharding.layout``) and the layers call
``sharding.collectives`` over the mesh's process groups."""
from __future__ import annotations

from contextlib import contextmanager

_MESH = None


def set_mesh(mesh) -> None:
    global _MESH
    _MESH = mesh


def get_mesh():
    return _MESH


@contextmanager
def mesh_context(mesh):
    global _MESH
    prev = _MESH
    _MESH = mesh
    try:
        yield
    finally:
        _MESH = prev
