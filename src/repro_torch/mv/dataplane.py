"""Array-level data plane for the MV operator hot path, on PyTorch.

The counterpart of ``repro.mv.dataplane``, with tensors in place of numpy
arrays. Every primitive is bitwise-equal to that module's numpy reference.
Dispatch is by the device of the tensor it is given, and nothing else:

* a CPU tensor takes the primitive's plain PyTorch version;
* a CUDA tensor takes the hand-written Hopper kernel (``csrc/dataplane.cu``)
  where the primitive has one, or the wrapper raises. No path falls back.

Kernels, each with its plain version beside it and a launch counter
(``launches``) that ``native.launch`` bumps where the wrapper launches
and nowhere else:

* ``filter_gt``           — ``filter_mask``, FILTER's pinned-dtype compare;
* ``map_derived``         — MAP's ``a*1.0001f + b/(1+|b|)`` in one fused
                            pass, every operation correctly rounded;
* ``fixed_point_encode``  — AGG's ``rint(f64(v)·2^16)`` (times the Z-set
                            weight, wrapping mod 2^64);
* ``probe_sorted``        — JOIN's searchsorted-left probe, clipped, with
                            the hit test at the clipped position, through
                            a static search tree built for each call;
* ``hash64``              — the splitmix64 finalizer, ``uint64`` out;
* ``pid_hist``            — splitmix64 ``% P`` per row plus the P-bucket
                            histogram in one pass (``partition_ids``,
                            ``partition_index``).

The plain versions of the two hash kernels run on int64, since torch has no
``>>`` or ``%`` on ``uint64``: logical shifts are emulated by masking and
the modulus is taken on 32-bit halves. ``group_reduce``'s grouping,
``first_occurrence``'s stable sort and ``partition_index``'s stable
grouping permutation have no kernel in the reference either; they are
PyTorch sorts, ``unique`` and integer ``index_add_`` on the tensor's device
(integer sums are exact in any order).

Wrappers launch on ``torch.cuda.current_stream()`` and never synchronise.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import native
from ..device import on_cpu

__all__ = [
    "hash64",
    "pid_hist",
    "partition_ids",
    "partition_index",
    "filter_mask",
    "map_derived",
    "fixed_point_encode",
    "group_reduce",
    "first_occurrence",
    "probe_sorted",
    "launches",
    "variant_launches",
    "reset_launches",
    "AGG_QUANTUM",
]

# Fixed-point quantum for AGG sums (mirrors tableops.AGG_QUANTUM).
AGG_QUANTUM = 2.0**16
_TWO_63 = 2.0**63

_SPLITMIX_C1 = 0xBF58476D1CE4E5B9
_SPLITMIX_C2 = 0x94D049BB133111EB

# numpy's ``np.float32(1.0001)``, widened exactly: an f64 column multiplies
# by this value, not by the double nearest 1.0001.
_MAP_C = float(np.float32(1.0001))

# ---------------------------------------------------------------------------
# Launch counters and the CUDA library
# ---------------------------------------------------------------------------

KERNELS = ("filter_gt", "map_derived", "fixed_point_encode", "probe_sorted",
           "hash64", "pid_hist")
launches = native.LaunchCounts(KERNELS)
# Launches of one instantiation within a kernel's count: the weighted
# (Z-set) encode runs only on incremental rounds; the scalar compare takes
# only columns off their element size or too short for one 16-byte vector
# after their head (``filter_head``); the probe's tree build runs for an
# index of more than one leaf (the build and the probe are one launch of
# probe_sorted).
variant_launches = native.LaunchCounts(("fixed_point_encode/weighted",
                                        "filter_gt/scalar", "probe_sorted/build"))


def reset_launches() -> None:
    """Set every kernel's launch counter to 0."""
    launches.reset()
    variant_launches.reset()


_P, _N, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# Every C entry point of csrc/dataplane.cu and its arguments before the stream.
native.declare("dataplane", {
    "sc_filter_gt_f32": [_P, ctypes.c_float, _P, _N, _I],
    "sc_filter_gt_f64": [_P, ctypes.c_double, _P, _N, _I],
    "sc_filter_gt_i64": [_P, ctypes.c_double, _P, _N, _I],
    "sc_map_derived": [_P, _I, _P, _I, _P, _N],
    "sc_fixed_point_encode": [_P, _I, _P, _P, _N],
    "sc_probe_sorted": [_P, _N, _P, _P, _P, _N, _P, _N],
    "sc_hash64": [_P, _P, _N],
    "sc_pid_hist": [_P, _N, _P, _P, _N],
})


def _check_1d(name: str, t: torch.Tensor, dtypes) -> None:
    if t.dim() != 1:
        raise ValueError(f"{name}: expected a 1-D tensor, got shape {tuple(t.shape)}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


# ---------------------------------------------------------------------------
# splitmix64 hash / partitioning
# ---------------------------------------------------------------------------

def _signed(c: int) -> int:
    return c - (1 << 64) if c >= 1 << 63 else c


def _lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns (torch's ``>>`` is
    arithmetic on int64)."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _hash64_i64(keys: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer on the int64 bit pattern of ``keys``; int64
    multiplication wraps mod 2^64 exactly like the uint64 reference."""
    x = keys.to(torch.int64).clone()
    x ^= _lsr(x, 30)
    x *= _signed(_SPLITMIX_C1)
    x ^= _lsr(x, 27)
    x *= _signed(_SPLITMIX_C2)
    x ^= _lsr(x, 31)
    return x


def _umod(x: torch.Tensor, P: int) -> torch.Tensor:
    """``uint64(x) % P`` for int64 bit patterns and 1 <= P < 2^31, on 32-bit
    halves so every intermediate stays a non-negative int64."""
    hi = _lsr(x, 32)
    lo = x & 0xFFFFFFFF
    return ((hi % P) * ((1 << 32) % P) + lo % P) % P


def _pid_plain(keys: torch.Tensor, P: int) -> torch.Tensor:
    return _umod(_hash64_i64(keys), P)


def _pid_hist_plain(keys: torch.Tensor,
                    P: int) -> tuple[torch.Tensor, torch.Tensor]:
    pid = _pid_plain(keys, P)
    return pid, torch.bincount(pid, minlength=P).to(torch.int64)


def _hash_keys(name: str, keys: torch.Tensor) -> torch.Tensor:
    keys = keys if keys.dtype == torch.int64 else keys.to(torch.int64)
    _check_1d(name, keys, (torch.int64,))
    return keys


def _hash_cuda(keys: torch.Tensor) -> torch.Tensor:
    keys = _hash_keys("hash64", keys)
    out = torch.empty(len(keys), dtype=torch.uint64, device=keys.device)
    if len(keys) == 0:
        return out
    native.launch("hash64", "sc_hash64", keys.device, native.ptr(keys), native.ptr(out),
                  ctypes.c_longlong(len(keys)))
    return out


def _pid_hist_cuda(keys: torch.Tensor,
                   P: int) -> tuple[torch.Tensor, torch.Tensor]:
    keys = _hash_keys("pid_hist", keys)
    pid = torch.empty(len(keys), dtype=torch.int64, device=keys.device)
    if len(keys) == 0:
        return pid, torch.zeros(P, dtype=torch.int64, device=keys.device)
    hist = torch.empty(P, dtype=torch.int64, device=keys.device)
    native.launch("pid_hist", "sc_pid_hist", keys.device, native.ptr(keys),
                  ctypes.c_longlong(P), native.ptr(pid), native.ptr(hist),
                  ctypes.c_longlong(len(keys)))
    return pid, hist


def _n_partitions(n_partitions: int) -> int:
    P = max(int(n_partitions), 1)
    if P >= 1 << 31:
        raise ValueError(f"n_partitions={P} must be < 2^31")
    return P


def hash64(keys: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer as ``uint64`` — bitwise the reference's."""
    if on_cpu(keys):
        return _hash64_i64(keys).view(torch.uint64)
    return _hash_cuda(keys)


def pid_hist(keys: torch.Tensor,
             n_partitions: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(pid, counts)`` of a P-way hash split, 1 < P < 2^31: ``pid[i] =
    splitmix64(keys[i]) % P`` and ``counts[p]`` the number of rows with pid
    ``p``, in one pass on the card."""
    P = _n_partitions(n_partitions)
    if P == 1:
        raise ValueError("pid_hist needs n_partitions > 1")
    if on_cpu(keys):
        return _pid_hist_plain(keys, P)
    return _pid_hist_cuda(keys, P)


def partition_ids(keys: torch.Tensor, n_partitions: int) -> torch.Tensor:
    """Partition id of each key: ``splitmix64(key) % P`` (0 when P=1). On
    the card it is ``pid_hist`` with the counts dropped, as the reference's
    Pallas path does."""
    P = _n_partitions(n_partitions)
    if P == 1:
        return torch.zeros(len(keys), dtype=torch.int64, device=keys.device)
    if on_cpu(keys):
        return _pid_plain(keys, P)
    return _pid_hist_cuda(keys, P)[0]


def partition_index(keys: torch.Tensor,
                    n_partitions: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Grouped row index of a P-way hash split: ``(order, counts)``, with
    ``order`` the stable partition-major permutation and ``counts[p]``
    partition p's row count. The grouping is a stable sort of the pids, as
    the reference groups outside its kernels too."""
    P = _n_partitions(n_partitions)
    n = len(keys)
    if P == 1:
        return (torch.arange(n, dtype=torch.int64, device=keys.device),
                torch.tensor([n], dtype=torch.int64, device=keys.device))
    pid, counts = pid_hist(keys, P)
    order = torch.sort(pid, stable=True).indices
    return order, counts


# ---------------------------------------------------------------------------
# FILTER compare
# ---------------------------------------------------------------------------

def _filter_plain(col: torch.Tensor, threshold: float) -> torch.Tensor:
    if col.dtype == torch.float32:
        return col > float(np.float32(threshold))
    if col.dtype.is_floating_point:
        return col > float(threshold)
    return col.to(torch.float64) > float(threshold)


def filter_head(addr: int, itemsize: int, n: int) -> int | None:
    """How the vector compare splits a column of ``n`` rows of ``itemsize``
    bytes at address ``addr``: the rows before its first 16-byte boundary,
    which it compares one by one (0 for a column on 16 bytes), or ``None``
    where the scalar kernel takes the column instead: an address off its
    element size, or fewer rows after the head than one 16-byte vector
    holds."""
    if addr % itemsize:
        return None
    head = (-addr % 16) // itemsize
    return head if n - head >= 16 // itemsize else None


def _filter_cuda(col: torch.Tensor, threshold: float) -> torch.Tensor:
    _check_1d("filter_mask", col, (torch.float32, torch.float64, torch.int64))
    n = len(col)
    head = filter_head(col.data_ptr(), col.element_size(), n)
    if head:
        # a view whose offset matches the column's, so that the vector
        # kernel stores each mask word on its alignment
        shift = (-head) % (16 // col.element_size())
        out = torch.empty(n + 16, dtype=torch.bool, device=col.device)[shift:shift + n]
    else:
        out = torch.empty(n, dtype=torch.bool, device=col.device)
    if n == 0:
        return out
    if col.dtype == torch.float32:
        fn, thr = "sc_filter_gt_f32", ctypes.c_float(float(np.float32(threshold)))
    elif col.dtype == torch.float64:
        fn, thr = "sc_filter_gt_f64", ctypes.c_double(float(threshold))
    else:
        fn, thr = "sc_filter_gt_i64", ctypes.c_double(float(threshold))
    native.launch("filter_gt", fn, col.device, native.ptr(col), thr, native.ptr(out),
                  ctypes.c_longlong(n), -1 if head is None else head,
                  variant="scalar" if head is None else None)
    return out


def filter_mask(col: torch.Tensor, threshold: float) -> torch.Tensor:
    """Boolean FILTER mask ``col > threshold`` under the pinned-dtype compare
    contract: a float column compares in its own width, anything else in
    float64 (torch alone would compare an int64 column in float32)."""
    if on_cpu(col):
        return _filter_plain(col, threshold)
    return _filter_cuda(col, threshold)


# ---------------------------------------------------------------------------
# MAP expression
# ---------------------------------------------------------------------------

def _softsign_plain(x: torch.Tensor) -> torch.Tensor:
    """numpy's ``x / (np.float32(1.0) + np.abs(x))``: float columns stay in
    their width; an integer column takes |x| in integers, then float64."""
    if x.dtype.is_floating_point:
        return x / (1.0 + torch.abs(x))
    return x.to(torch.float64) / (torch.abs(x).to(torch.float64) + 1.0)


def _mul_plain(a: torch.Tensor) -> torch.Tensor:
    """numpy's ``a * np.float32(1.0001)``: in a's width for float columns
    (the constant widened exactly for f64), float64 for integer columns."""
    if a.dtype.is_floating_point:
        return a * _MAP_C
    return a.to(torch.float64) * _MAP_C


def _map_plain(a: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    if b is None:
        return _softsign_plain(a)
    p, s = _mul_plain(a), _softsign_plain(b)
    rt = torch.promote_types(p.dtype, s.dtype)
    return p.to(rt) + s.to(rt)


_MAP_DTYPES = (torch.float32, torch.float64)
# The kernel's input types (sc_map_derived's type codes); an int64 column
# computes in float64, with softsign's |x| taken in wrapping int64 first.
_MAP_TYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.int64: 2}


def _as_map_input(x: torch.Tensor) -> torch.Tensor:
    """A column of another integer type enters the kernel as float64."""
    return x if x.dtype in _MAP_TYPE_CODES else x.to(torch.float64)


def _map_width(dtype: torch.dtype) -> torch.dtype:
    return dtype if dtype.is_floating_point else torch.float64


def _map_cuda(a: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    a = _as_map_input(a)
    b = None if b is None else _as_map_input(b)
    _check_1d("map_derived a", a, tuple(_MAP_TYPE_CODES))
    dtype = _map_width(a.dtype)
    if b is not None:
        _check_1d("map_derived b", b, tuple(_MAP_TYPE_CODES))
        if len(b) != len(a):
            raise ValueError(f"map_derived: lengths differ ({len(a)} vs {len(b)})")
        dtype = torch.promote_types(dtype, _map_width(b.dtype))
    out = torch.empty(len(a), dtype=dtype, device=a.device)
    if len(a) == 0:
        return out
    b_type = 0 if b is None else _MAP_TYPE_CODES[b.dtype]
    native.launch("map_derived", "sc_map_derived", a.device, native.ptr(a),
                  _MAP_TYPE_CODES[a.dtype], native.ptr(b), b_type, native.ptr(out),
                  ctypes.c_longlong(len(a)))
    return out


def map_derived(a: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    """The MAP expression ``a*1.0001f + softsign(b)`` (``softsign(a)`` with
    one input column), every mul/add/div/abs correctly rounded and unfused,
    with numpy's result dtype for every input combination."""
    if on_cpu(a, b):
        return _map_plain(a, b)
    return _map_cuda(a, b)


# ---------------------------------------------------------------------------
# Fixed-point AGG: encode + weighted segment reduction
# ---------------------------------------------------------------------------

def _encode_plain(values: torch.Tensor,
                  weights: torch.Tensor | None) -> torch.Tensor:
    r = torch.round(values.to(torch.float64) * AGG_QUANTUM)
    # numpy's int64 conversion (x86) gives INT64_MIN for NaN and outside
    # [-2^63, 2^63); spelled out, since the card's own conversion saturates
    inside = (r >= -_TWO_63) & (r < _TWO_63)
    fp = torch.where(inside, r, -_TWO_63).to(torch.int64)
    return fp if weights is None else fp * weights.to(torch.int64)


def _encode_cuda(values: torch.Tensor,
                 weights: torch.Tensor | None) -> torch.Tensor:
    if values.dtype not in _MAP_DTYPES:
        values = values.to(torch.float64)  # numpy's asarray(values, float64)
    _check_1d("fixed_point_encode values", values, _MAP_DTYPES)
    if weights is not None:
        weights = weights.to(torch.int64)
        _check_1d("fixed_point_encode weights", weights, (torch.int64,))
        if len(weights) != len(values):
            raise ValueError("fixed_point_encode: weights length differs")
    out = torch.empty(len(values), dtype=torch.int64, device=values.device)
    if len(values) == 0:
        return out
    native.launch("fixed_point_encode", "sc_fixed_point_encode", values.device,
                  native.ptr(values), int(values.dtype == torch.float64), native.ptr(weights),
                  native.ptr(out), ctypes.c_longlong(len(values)),
                  variant=None if weights is None else "weighted")
    return out


def fixed_point_encode(values: torch.Tensor,
                       weights: torch.Tensor | None = None) -> torch.Tensor:
    """Per-row int64 AGG contribution ``rint(v * AGG_QUANTUM)`` (half to
    even), times the signed Z-set weight when given (wrapping mod 2^64)."""
    if on_cpu(values, weights):
        return _encode_plain(values, weights)
    return _encode_cuda(values, weights)


def group_reduce(
    keys: torch.Tensor,
    cols: dict[str, tuple[torch.Tensor, str]],
    weights: torch.Tensor | None = None,
    stable: bool = False,
) -> tuple[torch.Tensor, dict[str, torch.Tensor], torch.Tensor]:
    """Weighted segment reduction over sorted unique group keys.

    ``cols`` maps output name → ``(values, kind)``; kind ``"fixed"`` encodes
    values through ``fixed_point_encode`` (times ``weights`` when given),
    kind ``"int"`` sums raw int64. Returns ``(sorted unique keys, {name:
    int64 sums}, counts)`` with ``counts`` the per-group sum of ``weights``
    (group sizes when None).

    Every sum is an exact int64 sum (mod 2^64), so ``index_add_``'s
    accumulation order cannot change it; ``stable`` is the caller's declared
    order sensitivity, kept for the reference's signature — this grouping
    (``torch.unique``) does not depend on row order at all.
    """
    del stable  # the grouping below is order-free; see docstring
    uniq, inv = torch.unique(keys, sorted=True, return_inverse=True)
    n = len(uniq)
    sums: dict[str, torch.Tensor] = {}
    for name, (v, kind) in cols.items():
        contrib = (
            v.to(torch.int64) if kind == "int"
            else fixed_point_encode(v, weights)
        )
        acc = torch.zeros(n, dtype=torch.int64, device=keys.device)
        sums[name] = acc.index_add_(0, inv, contrib)
    if weights is None:
        counts = torch.bincount(inv, minlength=n).to(torch.int64)
    else:
        counts = torch.zeros(n, dtype=torch.int64, device=keys.device)
        counts.index_add_(0, inv, weights.to(torch.int64))
    return uniq, sums, counts


# ---------------------------------------------------------------------------
# Join probe: first-occurrence index build + sorted probe
# ---------------------------------------------------------------------------

def first_occurrence(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(sorted unique keys, row index of each key's FIRST occurrence) — the
    PK-style probe index every right join side is reduced to. The stable
    sort is the contract (first occurrence in input order)."""
    sk, order = torch.sort(keys, stable=True)
    if len(sk) == 0:
        return sk, order
    first = torch.ones(len(sk), dtype=torch.bool, device=keys.device)
    torch.ne(sk[1:], sk[:-1], out=first[1:])
    sel = torch.nonzero(first).squeeze(1)
    return sk[sel], order[sel]


def _probe_plain(uniq: torch.Tensor,
                 probe: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    pos = torch.searchsorted(uniq, probe)
    posc = torch.clamp(pos, 0, len(uniq) - 1)
    return uniq[posc] == probe, posc


# The probe's search tree (csrc/dataplane.cu, kernel 4): leaves are runs of
# TREE_KEYS keys of the index itself; internal nodes hold TREE_KEYS
# separators over TREE_KEYS + 1 children, stored level by level, root first.
TREE_KEYS = 8
TREE_FAN = TREE_KEYS + 1


def probe_tree_levels(n_keys: int) -> list[int]:
    """Node counts of the probe tree's internal levels over an index of
    ``n_keys`` keys, root first; empty when one leaf holds them all. The C
    entry point computes the same and refuses a tree of another size."""
    counts = []
    m = -(-n_keys // TREE_KEYS)
    while m > 1:
        m = -(-m // TREE_FAN)
        counts.append(m)
    return counts[::-1]


def _probe_cuda(uniq: torch.Tensor,
                probe: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    _check_1d("probe_sorted uniq", uniq, (torch.int64,))
    _check_1d("probe_sorted probe", probe, (torch.int64,))
    n = len(probe)
    hit = torch.empty(n, dtype=torch.bool, device=probe.device)
    pos = torch.empty(n, dtype=torch.int64, device=probe.device)
    nodes = sum(probe_tree_levels(len(uniq)))
    # freed with the call (stream-ordered by the caching allocator)
    tree = (torch.empty(nodes * TREE_KEYS, dtype=torch.int64, device=uniq.device)
            if nodes else None)
    native.launch("probe_sorted", "sc_probe_sorted", probe.device, native.ptr(uniq),
                  ctypes.c_longlong(len(uniq)), native.ptr(probe), native.ptr(hit),
                  native.ptr(pos), ctypes.c_longlong(n), native.ptr(tree),
                  ctypes.c_longlong(nodes), variant="build" if nodes else None)
    return hit, pos


def probe_sorted(uniq: torch.Tensor,
                 probe: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Probe sorted-unique ``uniq`` with ``probe`` values: ``(hit, pos)``
    where ``pos`` is the searchsorted-left position clipped to the valid
    range and ``hit[i]`` iff ``uniq[pos[i]] == probe[i]``. Empty ``uniq``
    (or no probes) → all-miss with zero positions."""
    if len(uniq) == 0 or len(probe) == 0:
        return (torch.zeros(len(probe), dtype=torch.bool, device=probe.device),
                torch.zeros(len(probe), dtype=torch.int64, device=probe.device))
    if on_cpu(uniq, probe):
        return _probe_plain(uniq, probe)
    return _probe_cuda(uniq, probe)
