"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for Hopper (``sm_90a``) into its own
shared library with a plain ``extern "C"`` interface, loaded with ctypes.
The build happens at first use, into ``build/repro_torch/`` at the root of
the repository, under a name keyed by a hash of the sources and the flags:
a changed source is rebuilt, an unchanged one reused. ``build`` starts one
``nvcc`` per source, all at once, and waits for them together; a source in
:data:`PARTS` compiles as several translation units, one ``nvcc`` each,
started with the rest and linked into its one library. A file lock in the
build directory lets one process build while others (the forked hosts of a
multi-host pool, say) wait and then load what it built.

Each family of kernels declares its C entry points with :func:`declare`.
:func:`launch` calls one of them on a device's current stream, raises when
it reports a CUDA error, and counts the launch against its kernel (and a
variant of it) in one registry; every kernel wrapper of the port goes
through it, and nothing else writes the counts. A family reads its own
counters through :class:`LaunchCounts`. Nothing here builds at import: the
CPU tests import every module, and a machine without a card has no ``nvcc``.

:func:`build_ptx` and :func:`compile_ptx` stop a source at PTX, with the
language and optimisation flags of the shipped build and the virtual
architecture its SASS comes from: what the determinism lints
(``analysis.determinism``) read.
"""
from __future__ import annotations

import concurrent.futures as cf
import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from collections.abc import Iterable, Iterator, Mapping
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "repro_torch"
SOURCES = ("dataplane", "rmsnorm", "flash_attention", "flash_attention_mma", "ssd_scan")
# Sources compiled as n translation units, unit i with -DSC_PART=i (the
# source guards each unit's share with SC_IN_PART), linked into one
# library: with one nvcc a source the f32 flash source set the whole
# build's length (137.8 s on an H100's host, every other source but the
# bf16 flash one under 12 s); in units the build takes 42-46 s there (the
# sources say how they split).
PARTS = {"flash_attention": 5, "flash_attention_mma": 3}

# No --use_fast_math: the data-plane kernels hold a bitwise contract with
# the numpy reference, and every rounding step is spelled out in the source;
# the model kernels keep IEEE division, expf and logf.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def ptx_flags(flags) -> tuple[str, ...]:
    """nvcc's flags for the PTX that ptxas turns into the SASS ``flags``
    build: each ``-gencode arch=compute_XX,code=...`` becomes
    ``-arch=compute_XX -ptx``, and the flags that act after the PTX is made
    (``-shared``, and whatever ``-Xcompiler`` passes to the host compiler
    and ``-Xptxas`` to ptxas) go; every other flag (language, optimisation,
    ``--fmad``, fast math, defines) stays as it is."""
    out, it = [], iter(flags)
    for flag in it:
        if flag == "-gencode":
            arch = next(it).split(",")[0].removeprefix("arch=")
            out += [f"-arch={arch}", "-ptx"]
        elif flag in ("-Xcompiler", "-Xptxas"):
            next(it)
        elif flag != "-shared":
            out.append(flag)
    return tuple(out)


# The PTX of the libraries' sm_90a code, under NVCC_FLAGS' own device flags.
PTX_FLAGS = ptx_flags(NVCC_FLAGS)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_functions: dict[str, ctypes._CFuncPtr] = {}
_build_logs: dict[str, str] = {}
_build_seconds: dict[str, float] = {}
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


def cuda_home() -> Path:
    """The CUDA toolkit's root (``CUDA_HOME``, else ``/usr/local/cuda``)."""
    return Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))


def nvcc_path() -> str | None:
    """``nvcc`` on the ``PATH`` or under :func:`cuda_home`, or None."""
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cand = cuda_home() / "bin" / "nvcc"
        if cand.exists():
            nvcc = str(cand)
    return nvcc


def _nvcc() -> str:
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def nvcc_version() -> str:
    """The compiler's release line (``Cuda compilation tools, release
    ...``); raises without ``nvcc``."""
    out = subprocess.run([_nvcc(), "--version"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return next((line for line in out.splitlines() if "release" in line), out.strip())


def _digest(name: str, flags) -> str:
    h = hashlib.sha256()
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(flags).encode())
    h.update(f"parts={PARTS.get(name, 1)}".encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    """Where source ``csrc/<name>.cu`` builds to (content-addressed)."""
    return BUILD_DIR / f"{name}-{_digest(name, NVCC_FLAGS)}.so"


def ptx_path(name: str) -> Path:
    """Where source ``csrc/<name>.cu`` compiles to PTX (content-addressed,
    as :func:`library_path`)."""
    return BUILD_DIR / f"{name}-{_digest(name, PTX_FLAGS)}.ptx"


def build_ptx(name: str) -> str:
    """The PTX of ``csrc/<name>.cu`` under ``PTX_FLAGS``, compiled on first
    use into :func:`ptx_path`; raises ``RuntimeError`` if ``nvcc`` is
    missing or fails."""
    return _ptx(CSRC / f"{name}.cu", ptx_path(name))


def compile_ptx(source: str, name: str) -> str:
    """The PTX of a CUDA source given as text, under ``PTX_FLAGS``: the
    source and its PTX go into the build directory as ``<name>-<hash>.cu``
    and ``.ptx``, keyed by the text and the flags."""
    h = hashlib.sha256(source.encode())
    h.update(" ".join(PTX_FLAGS).encode())
    stem = BUILD_DIR / f"{name}-{h.hexdigest()[:16]}"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = stem.with_suffix(".cu")
    if not src.exists():
        tmp = src.with_suffix(f".cu.tmp{os.getpid()}")
        tmp.write_text(source)
        os.replace(tmp, src)
    return _ptx(src, stem.with_suffix(".ptx"))


def _ptx(source: Path, target: Path) -> str:
    with _lock, _build_lock():
        if not target.exists():
            tmp = target.with_suffix(f".ptx.tmp{os.getpid()}")
            proc = subprocess.run(
                [_nvcc(), *PTX_FLAGS, "-o", str(tmp), str(source)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc -ptx failed for {source.name} "
                                   f"(exit {proc.returncode}):\n{proc.stdout}")
            os.replace(tmp, target)
    return target.read_text()


def build(names=SOURCES) -> dict[str, str]:
    """Compile every named source that is not built yet, one ``nvcc`` each
    (one a unit for a source of :data:`PARTS`), all started together
    (:func:`build_seconds` gives each source's wall seconds). Returns
    ``{name: compiler output}`` (``ptxas -v`` register and spill report,
    each unit's headed by its seconds) and raises ``RuntimeError`` naming
    every source that failed."""
    with _lock:
        return _build_locked(tuple(names))


@contextlib.contextmanager
def _build_lock():
    """The build directory's file lock, shared with other processes."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)   # released when the file closes
        yield


def _build_locked(names: tuple[str, ...]) -> dict[str, str]:
    with _build_lock():
        return _build_unshared(names)


def _build_unshared(names: tuple[str, ...]) -> dict[str, str]:
    todo = []
    for name in names:
        if library_path(name).exists():
            _build_logs.setdefault(name, "(cached build)")
        else:
            todo.append(name)
    failed = []
    if todo:
        with cf.ThreadPoolExecutor(len(todo)) as pool:
            for name, ok in zip(todo, pool.map(_compile, todo)):
                if not ok:
                    failed.append(f"{name}.cu:\n{_build_logs[name]}")
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return {name: _build_logs.get(name, "") for name in names}


def _compile(name: str) -> bool:
    """Compile ``csrc/<name>.cu`` into :func:`library_path`: one ``nvcc``,
    or one a unit of :data:`PARTS` (started together) and a link. Records
    its output and seconds; returns whether it succeeded."""
    t0 = time.perf_counter()
    target = library_path(name)
    tmp = target.with_suffix(f".so.tmp{os.getpid()}")
    src = str(CSRC / f"{name}.cu")
    n = PARTS.get(name, 1)
    if n == 1:
        objs, jobs = [], [[_nvcc(), *NVCC_FLAGS, "-o", str(tmp), src]]
    else:
        objs = [tmp.with_suffix(f".unit{i}.o") for i in range(n)]
        unit_flags = [f for f in NVCC_FLAGS if f != "-shared"]
        jobs = [[_nvcc(), *unit_flags, "-c", f"-DSC_PART={i}", "-o", str(obj), src]
                for i, obj in enumerate(objs)]
    procs = [subprocess.Popen(job, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for job in jobs]

    def finish(proc):
        out = proc.communicate()[0]
        return out, time.perf_counter() - t0

    with cf.ThreadPoolExecutor(len(procs)) as pool:
        done = list(pool.map(finish, procs))
    outs, ok = [], True
    for i, (proc, (out, secs)) in enumerate(zip(procs, done)):
        outs.append(out if n == 1 else f"[unit {i}: {secs:.1f} s]\n{out}")
        if proc.returncode != 0:
            ok = False
            outs.append(f"(nvcc exit {proc.returncode})")
    if ok and objs:
        link = subprocess.run([_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        outs.append(link.stdout)
        if link.returncode != 0:
            ok = False
            outs.append(f"(link exit {link.returncode})")
    for obj in objs:
        obj.unlink(missing_ok=True)
    if ok:
        os.replace(tmp, target)
    else:
        tmp.unlink(missing_ok=True)
    _build_logs[name] = "\n".join(outs)
    _build_seconds[name] = time.perf_counter() - t0
    return ok


def build_seconds() -> dict[str, float]:
    """Each source's wall seconds in the builds this process made (its
    units' ``nvcc`` and the link), by name."""
    return dict(_build_seconds)


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
