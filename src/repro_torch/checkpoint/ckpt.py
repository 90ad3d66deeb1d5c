"""Async write-behind checkpointing: the counterpart of
``repro.checkpoint.ckpt``, the paper's Fig. 6 ``t2`` overlap applied to
checkpoint persistence.

``save`` snapshots the state to host memory synchronously (so the
checkpoint is consistent), hands it to a background writer and returns;
training proceeds while serialization happens off the critical path.
Durability is crash-consistent: each checkpoint is written to
``step_XXXXXXXX.tmp/`` then atomically renamed, and a ``LATEST`` marker is
updated only after the rename, so a crash mid-write never corrupts the
restore point; ``keep`` checkpoints survive garbage collection.

The format is the reference's: one ``.npy`` per leaf, keyed by its path
(``/``-joined; files ``__``-joined), and ``META.json`` with each leaf's
logical dtype. bf16, which ``.npy`` cannot encode, is stored as its uint16
bits (taken through a torch view; there is no ``ml_dtypes``). A state is a
tree of mappings, sequences, tensors and Python scalars; an ``nn.Module``
stands for its named parameters.
"""
from __future__ import annotations

import concurrent.futures as cf
import json
import os
import shutil
import time
from collections.abc import Mapping, Sequence
from pathlib import Path
from typing import Any

import numpy as np
import torch
from torch import nn

# dtypes .npy cannot encode: stored bit-cast to a same-width integer
_BITCAST = {torch.bfloat16: (torch.int16, np.uint16)}
_LOGICAL = {"bfloat16": torch.bfloat16}


def _children(node: Any):
    """``(key, child)`` pairs of an inner node of a state tree, or None for
    a leaf."""
    if isinstance(node, nn.Module):
        return list(node.named_parameters())
    if isinstance(node, Mapping):
        return [(str(k), v) for k, v in node.items()]
    if isinstance(node, Sequence) and not isinstance(node, (str, bytes)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def _leaves(tree: Any, prefix: str = ""):
    """``(path, leaf)`` for every leaf, depth first in insertion order."""
    kids = _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for key, child in kids:
        yield from _leaves(child, f"{prefix}/{key}" if prefix else key)


def _to_numpy(leaf: Any) -> tuple[np.ndarray, str]:
    """A leaf as a host numpy array (bf16 as its uint16 bits) and its
    logical dtype name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        logical = str(t.dtype).removeprefix("torch.")
        if t.dtype in _BITCAST:
            same_width, np_dtype = _BITCAST[t.dtype]
            t = t.view(same_width)
        else:
            np_dtype = None
        # a CPU tensor's numpy view would see later in-place updates: copy
        arr = t.cpu().numpy() if t.device.type != "cpu" else t.numpy().copy()
        return (arr if np_dtype is None else arr.view(np_dtype)), logical
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


class CheckpointManager:
    def __init__(self, directory: str | os.PathLike, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._writer = cf.ThreadPoolExecutor(max_workers=1)
        self._pending: list[cf.Future] = []
        self.write_seconds = 0.0

    # -- save ------------------------------------------------------------------
    def save(self, state: Any, step: int, blocking: bool = False) -> cf.Future:
        """Write-behind by default: snapshot to host, persist in background."""
        flat = {path: _to_numpy(leaf) for path, leaf in _leaves(state)}
        fut = self._writer.submit(self._persist, flat, step)
        self._pending.append(fut)
        if blocking:
            fut.result()
        return fut

    def _persist(self, flat: dict[str, tuple[np.ndarray, str]], step: int) -> None:
        t0 = time.perf_counter()
        name = f"step_{step:08d}"
        tmp = self.dir / (name + ".tmp")
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        meta = {}
        for key, (arr, logical) in flat.items():
            fname = key.replace("/", "__") + ".npy"
            np.save(tmp / fname, arr)
            meta[key] = {"file": fname, "shape": list(arr.shape), "dtype": logical}
        (tmp / "META.json").write_text(json.dumps({"step": step, "leaves": meta}))
        final = self.dir / name
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        latest_tmp = self.dir / "LATEST.tmp"
        latest_tmp.write_text(name)
        os.replace(latest_tmp, self.dir / "LATEST")
        self._gc()
        self.write_seconds += time.perf_counter() - t0

    def _gc(self) -> None:
        ckpts = sorted(p for p in self.dir.iterdir() if p.name.startswith("step_")
                       and not p.name.endswith(".tmp"))
        for old in ckpts[: -self.keep]:
            shutil.rmtree(old, ignore_errors=True)

    def wait(self) -> None:
        for f in self._pending:
            f.result()
        self._pending.clear()

    # -- restore ----------------------------------------------------------------
    def latest_step(self) -> int | None:
        marker = self.dir / "LATEST"
        if not marker.exists():
            return None
        return int(marker.read_text().split("_")[1])

    def restore_flat(self, step: int | None = None) -> dict[str, torch.Tensor]:
        """Every leaf of a checkpoint as a CPU tensor in its logical dtype."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint in {self.dir}")
        folder = self.dir / f"step_{step:08d}"
        meta = json.loads((folder / "META.json").read_text())
        out = {}
        for key, info in meta["leaves"].items():
            t = torch.from_numpy(np.load(folder / info["file"]))
            if info["dtype"] in _LOGICAL:
                logical = _LOGICAL[info["dtype"]]
                t = t.view(_BITCAST[logical][0]).view(logical)
            out[key] = t
        return out

    def restore(self, template: Any, step: int | None = None) -> Any:
        """Restore into the structure of ``template``. Tensor leaves (and a
        module's parameters) are filled in place, keeping their device and
        dtype; Python scalars are replaced. Returns the filled tree."""
        flat = self.restore_flat(step)
        return _fill(template, flat, "")


def _fill(node: Any, flat: dict[str, torch.Tensor], prefix: str) -> Any:
    kids = _children(node)
    if kids is None:
        saved = flat[prefix]
        if isinstance(node, torch.Tensor):
            with torch.no_grad():
                node.copy_(saved)
            return node
        return type(node)(saved.item())
    filled = [(k, _fill(v, flat, f"{prefix}/{k}" if prefix else k)) for k, v in kids]
    if isinstance(node, nn.Module):
        return node
    if isinstance(node, Mapping):
        return {k: v for k, v in filled}
    return type(node)(v for _, v in filled)
