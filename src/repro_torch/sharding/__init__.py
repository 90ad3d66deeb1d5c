"""Gradient compression: the counterpart of ``repro.sharding`` so far.

Only :mod:`.compression` is ported. The sharding strategy, the mesh
context and ``compressed_psum`` (a collective over a process group) come
with the sharding slice of the port.
"""
from . import compression

__all__ = ["compression"]
