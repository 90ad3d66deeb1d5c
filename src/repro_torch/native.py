"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for Hopper (``sm_90a``) into its own
shared library with a plain ``extern "C"`` interface, loaded with ctypes.
The build happens at first use, into ``build/repro_torch/`` at the root of
the repository, under a name keyed by a hash of the sources and the flags:
a changed source is rebuilt, an unchanged one reused. ``build`` starts one
``nvcc`` per source, all at once, and waits for them together; a file
lock in the build directory lets one process build while others (the forked
hosts of a multi-host pool, say) wait and then load what it built.

Each family of kernels declares its C entry points with :func:`declare`.
:func:`launch` calls one of them on a device's current stream, raises when
it reports a CUDA error, and counts the launch against its kernel (and a
variant of it) in one registry; every kernel wrapper of the port goes
through it, and nothing else writes the counts. A family reads its own
counters through :class:`LaunchCounts`. Nothing here builds at import: the
CPU tests import every module, and a machine without a card has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from collections.abc import Iterable, Iterator, Mapping
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "repro_torch"
SOURCES = ("dataplane", "rmsnorm", "flash_attention", "flash_attention_mma", "ssd_scan")

# No --use_fast_math: the data-plane kernels hold a bitwise contract with
# the numpy reference, and every rounding step is spelled out in the source;
# the model kernels keep IEEE division, expf and logf.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_functions: dict[str, ctypes._CFuncPtr] = {}
_build_logs: dict[str, str] = {}
# C entry point -> (source, its arguments before the stream)
_entry_points: dict[str, tuple[str, list]] = {}
# launches of every kernel, and of "kernel/variant" for a variant's share
_counts: dict[str, int] = {}
_count_lock = threading.Lock()


def _fresh_locks() -> None:
    """A forked child starts with its own unlocked locks: a lock another
    thread of the parent held at the fork would stay held in the child."""
    global _lock, _count_lock
    _lock = threading.Lock()
    _count_lock = threading.Lock()


os.register_at_fork(after_in_child=_fresh_locks)


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = Path(cuda_home) / "bin" / "nvcc"
        if cand.exists():
            nvcc = str(cand)
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def library_path(name: str) -> Path:
    """Where source ``csrc/<name>.cu`` builds to (content-addressed)."""
    h = hashlib.sha256()
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile every named source that is not built yet, one ``nvcc`` each,
    all started together. Returns ``{name: compiler output}`` (``ptxas -v``
    register and spill report) and raises ``RuntimeError`` naming every
    source that failed."""
    with _lock:
        return _build_locked(tuple(names))


def _build_locked(names: tuple[str, ...]) -> dict[str, str]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)   # released when the file closes
        return _build_unshared(names)


def _build_unshared(names: tuple[str, ...]) -> dict[str, str]:
    procs = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            _build_logs.setdefault(name, "(cached build)")
            continue
        tmp = target.with_suffix(f".so.tmp{os.getpid()}")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, target)
    failed = []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        _build_logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return {name: _build_logs.get(name, "") for name in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _build_locked((name,))
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
        return lib


def declare(source: str, signatures: dict[str, list]) -> None:
    """Declare the C entry points of ``csrc/<source>.cu``: each name with
    the ctypes of its arguments before the stream."""
    for fn, argtypes in signatures.items():
        _entry_points[fn] = (source, list(argtypes))


def _function(fn: str) -> ctypes._CFuncPtr:
    """Declared C entry point ``fn``, taking its arguments and then the
    stream, and returning an int."""
    f = _functions.get(fn)
    if f is None:
        source, argtypes = _entry_points[fn]
        f = getattr(library(source), fn)
        with _lock:
            f.argtypes = [*argtypes, ctypes.c_void_p]
            f.restype = ctypes.c_int
            _functions[fn] = f
    return f


def launch(kernel: str, fn: str, device: torch.device, *args,
           variant: str | tuple[str, ...] | None = None) -> None:
    """Call entry point ``fn`` with ``args`` and ``device``'s current
    stream, then count one launch of ``kernel`` (and of each of its
    variants: ``variant`` names one or several). Every entry point returns
    ``cudaGetLastError()``; a non-zero code raises ``RuntimeError`` and
    counts nothing."""
    f = _function(fn)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = f(*args, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with error {err}")
    variants = (variant,) if isinstance(variant, str) else variant or ()
    with _count_lock:
        _counts[kernel] += 1
        for name in variants:
            _counts[f"{kernel}/{name}"] += 1


class LaunchCounts(Mapping):
    """A live read-only view of some kernels' launch counts (names as
    :func:`launch` counts them: ``kernel`` or ``kernel/variant``)."""

    def __init__(self, names: Iterable[str]):
        self._names = tuple(names)
        with _count_lock:
            for name in self._names:
                _counts.setdefault(name, 0)

    def __getitem__(self, name: str) -> int:
        if name not in self._names:
            raise KeyError(name)
        return _counts[name]

    def __iter__(self) -> Iterator[str]:
        return iter(self._names)

    def __len__(self) -> int:
        return len(self._names)

    def __repr__(self) -> str:
        return repr(dict(self))

    def reset(self) -> None:
        """Set these counts to 0."""
        with _count_lock:
            for name in self._names:
                _counts[name] = 0


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    """A tensor's device address for a C entry point (null for ``None``)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())
