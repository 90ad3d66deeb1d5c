"""Columnar table operators — the SPJ units S/C schedules (paper §VI-A).

The counterpart of ``repro.mv.tableops`` on PyTorch. A *table* is a dict of
equal-length 1-D tensors on one device; every operator returns its result
on its inputs' device, and the outputs are bitwise those of the reference
operators on the same rows. The array-level inner loops — compare, map
expression, fixed-point segment reduction, join probe — run through
``mv/dataplane.py`` (the hand-written CUDA kernels on the card, their plain
PyTorch versions on the CPU). Data-dependent compaction (``nonzero``) reads
sizes back to the host, as in any vectorized engine.

Incremental refresh (Z-set weighted-row deltas)
-----------------------------------------------
Base-table rows carry a ``rid`` column: a globally unique row id that is
monotone in the ingestion round; updates keep their rid. A *delta* is a
Z-set: a table with an integer ``weight`` meta column where positive rows
are insertions (``+w`` = w identical copies) and negative rows are
retractions carrying the exact payload of the stored row(s) they cancel.
``apply_delta`` consolidates a delta into stored content in the canonical
stable rid order — the row order a full recompute produces.

* FILTER / PROJECT / MAP are per-row: the operator applied to the weighted
  delta IS the output delta.
* JOIN is left-driven with a PK-style first-occurrence right index; weights
  multiply through. ``zset_join_delta`` joins left retractions against the
  old right and insertions against the new right, and a right delta that
  changes a key's first-occurrence mapping triggers a *partial fallback*
  that re-joins only the affected surviving old-left rows.
* UNION sorts by ``rid`` and consolidates weighted inputs.
* AGG keeps mergeable partial aggregates: per-key ``sum_*`` columns in
  fixed-point int64 (quantum ``1/AGG_QUANTUM``) and an exact int64
  ``count``, so ``merge_agg(agg(old), agg(Δ±)) == agg(full)`` bitwise.
"""
from __future__ import annotations

import weakref

import numpy as np
import torch

from ..device import resolve_device
from . import dataplane

Table = dict[str, torch.Tensor]

# Columns that are bookkeeping, not data: excluded from MAP inputs and AGG
# measures (they still group/join/sort like any other column).
WEIGHT_COL = "weight"
META_COLS = ("key", "rid", WEIGHT_COL)

# Fixed-point quantum for AGG sums: values are accumulated as
# round(v * AGG_QUANTUM) in int64, so per-key sums are exactly associative.
AGG_QUANTUM = 2.0**16

# rid layout: round dominates, then the producing scan node, then the row
# offset within the batch.
_RID_NODE_SLOTS = 1 << 12
_RID_ROW_BITS = 32


def make_rid_base(round_idx: int, node_idx: int) -> int:
    """Start of the rid range for rows ingested by scan ``node_idx`` at
    ``round_idx`` — monotone in round across every table."""
    return (round_idx * _RID_NODE_SLOTS + node_idx) << _RID_ROW_BITS


def make_base_table(
    n_rows: int,
    n_cols: int,
    seed: int,
    key_mod: int | None = None,
    rid_base: int | None = None,
    key_probs: np.ndarray | None = None,
    device: str | torch.device | None = None,
) -> Table:
    """Deterministic synthetic base table on ``device`` (default: the card):
    an int64 ``key`` column, ``rid`` row ids when ``rid_base`` is given, and
    ``n_cols - 1`` float32 value columns. Keys draw uniformly from
    ``[0, key_mod)`` unless ``key_probs`` supplies a per-key distribution.
    The draws are numpy's ``default_rng`` in the reference's order, moved to
    the device afterwards, so the table is bitwise the reference's."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    kmod = key_mod or max(n_rows // 4, 4)
    if key_probs is not None:
        keys = rng.choice(len(key_probs), size=n_rows, p=key_probs)
        t = {"key": keys.astype(np.int64)}
    else:
        t = {"key": rng.integers(0, kmod, n_rows).astype(np.int64)}
    if rid_base is not None:
        t["rid"] = rid_base + np.arange(n_rows, dtype=np.int64)
    for c in range(n_cols - 1):
        t[f"c{c}"] = rng.standard_normal(n_rows).astype(np.float32)
    return {k: torch.from_numpy(v).to(dev) for k, v in t.items()}


def data_cols(table: Table) -> list[str]:
    return [k for k in table if k not in META_COLS]


def device_of(table: Table) -> torch.device:
    """The device a table's columns lie on (CPU for a column-less table)."""
    for v in table.values():
        return v.device
    return torch.device("cpu")


def _arange(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


def _nz(mask: torch.Tensor) -> torch.Tensor:
    """Indices of the True entries of a 1-D mask (``np.nonzero(m)[0]``)."""
    return torch.nonzero(mask).squeeze(1)


# ---------------------------------------------------------------------------
# Z-set (weighted-row) delta primitives
# ---------------------------------------------------------------------------

def n_rows(table: Table) -> int:
    return len(next(iter(table.values()))) if table else 0


# Memoized weight-column live-row sums (catalog admission sizes the same
# resident delta repeatedly). Keyed by the weight tensor's id(), which
# CPython recycles: a hit is only trusted when the stored weakref still
# resolves to the probing tensor AND its shape/dtype match. Stale entries
# found on probe are evicted eagerly.
_LIVE_ROWS_CACHE: dict[int, tuple[weakref.ref, tuple, torch.dtype, int]] = {}
_LIVE_ROWS_CACHE_MAX = 4096


def _live_rows(table: Table) -> int:
    """Total positive Z-set multiplicity of a delta (cached per weight
    tensor)."""
    w = table[WEIGHT_COL]
    key = id(w)
    hit = _LIVE_ROWS_CACHE.get(key)
    if hit is not None:
        ref, shape, dtype, cached = hit
        if ref() is w and tuple(w.shape) == shape and w.dtype == dtype:
            return cached
        _LIVE_ROWS_CACHE.pop(key, None)  # id recycled: drop the stale entry
    live = int(torch.clamp(weights_of(table), min=0).sum())
    ref = weakref.ref(w, lambda _r, k=key: _LIVE_ROWS_CACHE.pop(k, None))
    if len(_LIVE_ROWS_CACHE) >= _LIVE_ROWS_CACHE_MAX:
        _LIVE_ROWS_CACHE.clear()
    _LIVE_ROWS_CACHE[key] = (ref, tuple(w.shape), w.dtype, live)
    return live


def table_nbytes(table: Table) -> int:
    """Physical bytes of a table's columns (``tensor.nbytes`` equals numpy's
    ``.nbytes`` for every dtype a table holds)."""
    return int(sum(v.nbytes for v in table.values()))


def table_sizes(table: Table) -> tuple[int, int]:
    """``(physical bytes, weighted live bytes)`` in one pass — what the
    catalog admission path charges (``max`` of the two for a Z-set delta).
    The weight-column sum is memoized per tensor; callers that mutate the
    weight column in place should use ``weighted_nbytes``."""
    n = n_rows(table)
    w_bytes = table[WEIGHT_COL].nbytes if WEIGHT_COL in table else 0
    phys_all = table_nbytes(table)
    phys = phys_all - w_bytes
    if WEIGHT_COL not in table or n == 0:
        return phys_all, phys
    return phys_all, int(round(phys * (_live_rows(table) / n)))


def weighted_nbytes(table: Table) -> int:
    """Bytes of live content a table expands to when materialized: payload
    bytes times the total positive multiplicity (always recomputed)."""
    n = n_rows(table)
    phys = int(sum(v.nbytes for k, v in table.items() if k != WEIGHT_COL))
    if WEIGHT_COL not in table or n == 0:
        return phys
    live_rows = int(torch.clamp(weights_of(table), min=0).sum())
    return int(round(phys * (live_rows / n)))


def weights_of(table: Table) -> torch.Tensor:
    """The Z-set weight vector of a delta (implicit all-+1 when absent)."""
    if WEIGHT_COL in table:
        return table[WEIGHT_COL].to(torch.int64)
    return torch.ones(n_rows(table), dtype=torch.int64, device=device_of(table))


def with_weight(table: Table, weight: int = 1) -> Table:
    """Table with an explicit int64 weight column (existing one is kept only
    when ``weight`` is the default +1; otherwise it is overwritten)."""
    out = dict(table)
    if WEIGHT_COL not in out or weight != 1:
        out[WEIGHT_COL] = torch.full(
            (n_rows(table),), weight, dtype=torch.int64, device=device_of(table)
        )
    return out


def strip_weight(table: Table) -> Table:
    return {k: v for k, v in table.items() if k != WEIGHT_COL}


def take_rows(table: Table, idx: torch.Tensor) -> Table:
    return {k: v[idx] for k, v in table.items()}


def _occurrence_index(values: torch.Tensor) -> torch.Tensor:
    """occ[i] = number of j < i with values[j] == values[i] (duplicate rank)."""
    srt, order = torch.sort(values, stable=True)
    n = len(srt)
    if n == 0:
        return torch.zeros(0, dtype=torch.int64, device=values.device)
    new_run = torch.ones(n, dtype=torch.bool, device=values.device)
    new_run[1:] = srt[1:] != srt[:-1]
    idx = _arange(n, values.device)
    run_start = torch.cummax(torch.where(new_run, idx, 0), 0).values
    occ = torch.empty(n, dtype=torch.int64, device=values.device)
    occ[order] = idx - run_start
    return occ


def apply_delta(old: Table, delta: Table) -> Table:
    """Consolidate a Z-set delta into stored content.

    Rows of ``old`` whose rid carries a retraction are removed, positive
    rows are inserted (a ``+w`` row as ``w`` identical copies), and the
    result is restored to the canonical stable rid order. A ``-w`` row
    retracts the first ``w`` stored copies of its rid. ``old`` carries no
    weight column and neither does the result. Retractions require a rid on
    both sides to match by.
    """
    if not delta or n_rows(delta) == 0:
        return dict(old)
    w = weights_of(delta)
    neg = w < 0
    pos_idx = _nz(w > 0)
    if pos_idx.numel() and bool((w[pos_idx] != 1).any()):
        # general multiplicities: a +w row expands to w identical copies
        pos_idx = torch.repeat_interleave(pos_idx, w[pos_idx])
    missing = [k for k in old if k not in delta]
    if missing:
        raise ValueError(f"delta lacks columns {missing} of the target table")
    if "rid" not in old:
        if bool(neg.any()):
            raise ValueError("retraction delta needs a rid column to match by")
        return {k: torch.cat([old[k], delta[k][pos_idx]]) for k in old}
    retracted = delta["rid"][neg]
    old_rid = old["rid"]
    ins_rid = delta["rid"][pos_idx]
    if not retracted.numel() and (
        not len(old_rid) or not ins_rid.numel()
        or int(ins_rid.min()) > int(old_rid[-1])
    ):
        # pure append (round-monotone insert rids): the stable rid sort is a
        # no-op, skip it — the hot path of insert-only refresh
        return {k: torch.cat([old[k], delta[k][pos_idx]]) for k in old}
    if retracted.numel():
        # per-rid retraction multiplicity (Σ -w over that rid's tombstones)
        uniq_r, inv_r = torch.unique(retracted, sorted=True, return_inverse=True)
        counts = torch.zeros(len(uniq_r), dtype=torch.int64, device=w.device)
        counts.index_add_(0, inv_r, -w[neg])
        pos_r = torch.searchsorted(uniq_r, old_rid)
        pos_r = torch.clamp(pos_r, 0, max(len(uniq_r) - 1, 0))
        hit = uniq_r[pos_r] == old_rid
        if bool((counts == 1).all()) and (
            torch.unique(old_rid).numel() == len(old_rid)
        ):
            keep = _nz(~hit)  # the unique-rid, weight-±1 hot path
        else:
            occ = _occurrence_index(old_rid)
            drop = hit & (occ < counts[pos_r])
            keep = _nz(~drop)
    else:
        keep = _arange(len(old_rid), old_rid.device)
    merged = {k: torch.cat([old[k][keep], delta[k][pos_idx]]) for k in old}
    order = torch.sort(merged["rid"], stable=True).indices
    return {k: v[order] for k, v in merged.items()}


def materialize_delta(delta: Table) -> Table:
    """Live content of a Z-set delta standing alone (an MV whose first-ever
    part is a delta): applied onto an empty base, weight column stripped."""
    base = {k: v[:0] for k, v in delta.items() if k != WEIGHT_COL}
    return apply_delta(base, delta)


def _row_bytes_equal(a: Table, ai: torch.Tensor, b: Table, bi: torch.Tensor,
                     cols: list[str]) -> torch.Tensor:
    """Per-row bitwise equality of ``a[ai]`` vs ``b[bi]`` over ``cols``
    (value equality is not enough: -0.0 vs 0.0 must count as a change)."""
    eq = torch.ones(len(ai), dtype=torch.bool, device=ai.device)
    for c in cols:
        va = a[c][ai].contiguous()
        vb = b[c][bi].contiguous()
        ba = va.view(torch.uint8).reshape(len(ai), va.element_size())
        bb = vb.view(torch.uint8).reshape(len(bi), vb.element_size())
        eq &= (ba == bb).all(dim=1)
    return eq


def _intersect_unique(a: torch.Tensor, b: torch.Tensor):
    """``np.intersect1d(a, b, assume_unique=True, return_indices=True)``:
    sorted common values and their indices into ``a`` and ``b``."""
    aux, perm = torch.sort(torch.cat([a, b]), stable=True)
    mask = aux[1:] == aux[:-1]
    return aux[:-1][mask], perm[:-1][mask], perm[1:][mask] - len(a)


def consolidate_zset(delta: Table) -> Table:
    """Net opposite-sign pairs in a Z-set delta: a retraction and an
    insertion under the same (unique-per-sign) rid with bitwise-identical
    payloads partially cancel — their weights sum, a fully-cancelled pair
    drops out, and a surviving net multiplicity stays on the row whose sign
    it matches. Leaves everything else (order included) untouched."""
    if WEIGHT_COL not in delta or "rid" not in delta or n_rows(delta) == 0:
        return delta
    w = weights_of(delta)
    rid = delta["rid"]
    neg_idx, pos_idx = _nz(w < 0), _nz(w > 0)
    if not neg_idx.numel() or not pos_idx.numel():
        return delta

    # only rids unique within each sign are safely cancellable
    def _unique_only(idx):
        r = rid[idx]
        uniq, counts = torch.unique(r, sorted=True, return_counts=True)
        return idx[torch.isin(r, uniq[counts == 1])]

    neg_u, pos_u = _unique_only(neg_idx), _unique_only(pos_idx)
    common, ni, pi = _intersect_unique(rid[neg_u], rid[pos_u])
    if not common.numel():
        return delta
    cols = [k for k in delta if k not in (WEIGHT_COL, "rid")]
    same = _row_bytes_equal(delta, neg_u[ni], delta, pos_u[pi], cols)
    if not bool(same.any()):
        return delta
    neg_s, pos_s = neg_u[ni][same], pos_u[pi][same]
    net = w[neg_s] + w[pos_s]
    new_w = w.clone()
    drop = [neg_s[net == 0], pos_s[net == 0]]
    pos_net = net > 0
    if bool(pos_net.any()):
        new_w[pos_s[pos_net]] = net[pos_net]
        drop.append(neg_s[pos_net])
    neg_net = net < 0
    if bool(neg_net.any()):
        new_w[neg_s[neg_net]] = net[neg_net]
        drop.append(pos_s[neg_net])
    keep_mask = torch.ones(len(rid), dtype=torch.bool, device=rid.device)
    keep_mask[torch.cat(drop)] = False
    out = dict(delta)
    out[WEIGHT_COL] = new_w
    return take_rows(out, _nz(keep_mask))


def op_filter(table: Table, col: str = "c0", threshold: float = 0.0) -> Table:
    if col not in table:
        col = next(iter(data_cols(table)), None)
        if col is None:  # meta-only table (e.g. a key-only aggregate upstream)
            return dict(table)
    idx = _nz(dataplane.filter_mask(table[col], threshold))
    return {k: v[idx] for k, v in table.items()}


def op_project(table: Table, keep_frac: float = 0.5) -> Table:
    # the weight column is delta bookkeeping: it always survives and never
    # counts toward the projection width
    cols = [k for k in table if k != WEIGHT_COL]
    keep = max(1, int(round(len(cols) * keep_frac)))
    # meta columns always survive projection; data columns fill the rest
    metas = [k for k in cols if k in META_COLS]
    data = [k for k in cols if k not in META_COLS]
    width = max(keep - len(metas), 0)
    kept = set(metas) | set(data[:width]) | {WEIGHT_COL}
    return {k: table[k] for k in table if k in kept}


def op_map(table: Table) -> Table:
    """Element-wise derived column (models expression evaluation), bitwise
    independent of the batch shape: every mul/add/div/abs is correctly
    rounded (``dataplane.map_derived``)."""
    out = dict(table)
    vals = [table[k] for k in data_cols(table)]
    if len(vals) >= 2:
        out["derived"] = dataplane.map_derived(vals[0], vals[1])
    elif vals:
        out["derived"] = dataplane.map_derived(vals[0], None)
    return out


def op_join(left: Table, right: Table) -> Table:
    """Inner equi-join on 'key' (sort-based index build + probe + gather).

    Left-driven: output rows follow left input order, and the right side
    contributes its *first occurrence* per key (PK-style join). The right
    side's own meta columns are dropped — the output's rid (and Z-set
    weight, when the left is a weighted delta) are the left's.
    """
    lk, rk = left["key"], right["key"]
    uniq, ridx_for = dataplane.first_occurrence(rk)
    matched, pos = dataplane.probe_sorted(uniq, lk)
    li = _nz(matched)
    ri = ridx_for[pos[li]] if len(uniq) else li[:0]
    out: Table = {k: v[li] for k, v in left.items()}
    for k, v in right.items():
        if k in META_COLS:
            continue
        out[f"r_{k}"] = v[ri]
    return out


def join_delta_is_appendable(right_old_keys: torch.Tensor,
                             right_delta: Table) -> bool:
    """True iff appending ``right_delta`` cannot change existing join matches
    (insert-only, and no key in the delta is new)."""
    dk = right_delta["key"]
    if dk.numel() == 0:
        return True
    if bool((weights_of(right_delta) < 0).any()):
        return False
    return bool(torch.isin(dk, right_old_keys).all())


def _right_mapping_changes(
    right_old: Table, right_new: Table, candidates: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Candidate join keys whose PK first-occurrence mapping changed between
    the old and new right side: (keys needing retraction of old matches,
    keys needing insertion of new matches)."""
    uo, io = dataplane.first_occurrence(right_old["key"])
    un, inw = dataplane.first_occurrence(right_new["key"])

    old_has, opos = dataplane.probe_sorted(uo, candidates)
    new_has, npos = dataplane.probe_sorted(un, candidates)
    both = old_has & new_has
    changed = torch.zeros(len(candidates), dtype=torch.bool,
                          device=candidates.device)
    if bool(both.any()):
        cols = [k for k in right_old if k not in META_COLS]
        changed[both] = ~_row_bytes_equal(
            right_old, io[opos[both]], right_new, inw[npos[both]], cols
        )
    retract = candidates[(old_has & ~new_has) | changed]
    insert = candidates[(new_has & ~old_has) | changed]
    return retract, insert


def zset_join_delta(
    left_old, left_delta: Table, right_old: Table, right_delta: Table,
    stats: dict | None = None,
) -> tuple[Table, int]:
    """Weighted delta of ``op_join(left, right)`` given Z-set deltas of both
    sides; returns ``(delta, corrected_rows)``.

    Left retractions join the old right side, left insertions the new one.
    When the right delta changes a key's first-occurrence mapping, the
    partial fallback re-joins only the affected old-left rows that survive
    this round's left retractions (``corrected_rows`` counts those rows).
    ``stats``, when given, receives ``affected_keys``, ``matched_keys`` and
    ``corrected_rows``. ``left_old`` may be a Table or a zero-arg callable,
    invoked only when the right mapping actually changed.
    """
    lo_memo: list = [left_old if not callable(left_old) else None]

    def _left_old() -> Table:
        if lo_memo[0] is None:
            lo_memo[0] = left_old()
        return lo_memo[0]

    right_new = apply_delta(right_old, right_delta)
    w = weights_of(left_delta)
    parts: list[Table] = []
    neg_idx, pos_idx = _nz(w < 0), _nz(w > 0)
    if neg_idx.numel():
        parts.append(op_join(take_rows(with_weight(left_delta), neg_idx), right_old))
    if pos_idx.numel():
        parts.append(op_join(take_rows(with_weight(left_delta), pos_idx), right_new))
    corrected = 0
    affected = matched = 0
    if right_delta and n_rows(right_delta):
        cand = torch.unique(right_delta["key"], sorted=True)
    else:
        cand = torch.empty(0, dtype=torch.int64, device=w.device)
    if cand.numel():
        retract_keys, insert_keys = _right_mapping_changes(
            right_old, right_new, cand
        )
        affected = int(torch.unique(torch.cat([retract_keys, insert_keys])).numel())
        if retract_keys.numel() or insert_keys.numel():
            # old-left rows still standing after this round's left retractions
            lo = _left_old()
            l_rid = lo["rid"]
            l_retracted = left_delta["rid"][w < 0] if neg_idx.numel() \
                else l_rid[:0]
            rem = ~torch.isin(l_rid, l_retracted) if l_retracted.numel() else \
                torch.ones(len(l_rid), dtype=torch.bool, device=l_rid.device)
            l_keys = lo["key"]
            matched_keys: set[int] = set()
            if retract_keys.numel():
                sub = _nz(rem & torch.isin(l_keys, retract_keys))
                if sub.numel():
                    matched_keys.update(torch.unique(l_keys[sub]).tolist())
                    corr = op_join(
                        with_weight(take_rows(lo, sub), -1), right_old
                    )
                    corrected += n_rows(corr)
                    parts.append(corr)
            if insert_keys.numel():
                sub = _nz(rem & torch.isin(l_keys, insert_keys))
                if sub.numel():
                    matched_keys.update(torch.unique(l_keys[sub]).tolist())
                    corr = op_join(
                        with_weight(take_rows(lo, sub), +1), right_new
                    )
                    corrected += n_rows(corr)
                    parts.append(corr)
            matched = len(matched_keys)
    if stats is not None:
        stats["affected_keys"] = affected
        stats["matched_keys"] = matched
        stats["corrected_rows"] = corrected
    if not parts:
        # schema-only result: an empty slice of the left delta joined
        # against the right — no left read needed
        empty_left = take_rows(with_weight(left_delta), neg_idx[:0])
        return op_join(empty_left, right_old), 0
    out = concat_tables(parts)
    if "rid" in out:
        order = torch.sort(out["rid"], stable=True).indices
        out = {k: v[order] for k, v in out.items()}
    return out, corrected


def _is_number(t: torch.Tensor) -> bool:
    """numpy's ``issubdtype(dtype, np.number)`` for the dtypes tables hold."""
    return t.dtype != torch.bool and not t.dtype.is_complex


def op_agg(table: Table) -> Table:
    """Group-by key; fixed-point-exact sums + int64 count per group.

    Sums accumulate as int64 fixed-point and are stored back as float64 — a
    deterministic function of the exact integer sum, so aggregation is
    associative and ``merge_agg`` is bitwise-exact. On a Z-set delta every
    row contributes ``weight * fixed_point(v)`` to its group's sums and
    ``weight`` to its count; groups whose delta-local count nets to zero are
    kept (they may carry sum corrections).
    """
    keys = table["key"]
    w = weights_of(table) if WEIGHT_COL in table else None
    cols = {
        f"sum_{k}": (table[k], "fixed")
        for k in data_cols(table)
        if _is_number(table[k])
    }
    uniq, sums, counts = dataplane.group_reduce(keys, cols, weights=w, stable=False)
    out: Table = {"key": uniq}
    for name, acc in sums.items():
        out[name] = acc.to(torch.float64) / AGG_QUANTUM
    out["count"] = counts
    return out


def merge_agg(old: Table, delta: Table) -> Table:
    """Merge two partial aggregates: ``merge_agg(agg(a), agg(b)) == agg(a++b)``
    bitwise. ``delta`` may be a signed partial aggregate; groups whose
    merged count reaches zero are dropped. Keys come out sorted-unique."""
    ok, dk = old["key"], delta["key"]
    keys = torch.cat([ok, dk])
    # one segment reduction over the concatenated partials: sums re-enter
    # fixed-point (kind "fixed"), counts add raw (kind "int")
    cols: dict[str, tuple[torch.Tensor, str]] = {}
    for col in old:
        if col == "key":
            continue
        ov = old[col]
        dv = (
            delta[col] if col in delta
            else torch.zeros(len(dk), dtype=ov.dtype, device=ov.device)
        )
        cols[col] = (torch.cat([ov, dv]), "int" if col == "count" else "fixed")
    uniq, sums, _counts = dataplane.group_reduce(keys, cols, weights=None,
                                                 stable=False)
    out: Table = {"key": uniq}
    for col, acc in sums.items():
        out[col] = acc if col == "count" else acc.to(torch.float64) / AGG_QUANTUM
    live = out["count"] != 0
    if not bool(live.all()):
        out = {k: v[live] for k, v in out.items()}
    return out


def op_union(left: Table, right: Table) -> Table:
    """Union of the common columns, ordered by ``rid`` when both sides carry
    one; weighted delta inputs consolidate."""
    common = [k for k in left if k in right]
    out = {k: torch.cat([left[k], right[k]]) for k in common}
    if "rid" in out:
        order = torch.sort(out["rid"], stable=True).indices
        out = {k: v[order] for k, v in out.items()}
    if WEIGHT_COL in out:
        out = consolidate_zset(out)
    return out


def empty_like(schema: dict[str, torch.dtype],
               device: str | torch.device | None = None) -> Table:
    """A zero-row table with the given column schema (an empty delta), on
    ``device`` (default: the card)."""
    dev = resolve_device(device)
    return {k: torch.empty(0, dtype=dt, device=dev) for k, dt in schema.items()}


def table_schema(table: Table) -> dict[str, torch.dtype]:
    return {k: v.dtype for k, v in table.items()}


def _bytes_of(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.uint8)


def assert_tables_bitwise(a: Table, b: Table, context: str = "") -> None:
    """Raise AssertionError (naming the first divergent column) unless two
    tables are bitwise identical: same column set, dtypes, shapes, bytes."""
    if set(a) != set(b):
        raise AssertionError(
            f"{context}: column sets differ {sorted(a)} != {sorted(b)}"
        )
    for col in a:
        va, vb = a[col], b[col]
        if va.dtype != vb.dtype or va.shape != vb.shape or not torch.equal(
            _bytes_of(va), _bytes_of(vb.to(va.device))
        ):
            raise AssertionError(
                f"{context}.{col}: not bitwise identical "
                f"({va.dtype}{tuple(va.shape)} vs {vb.dtype}{tuple(vb.shape)})"
            )


def concat_tables(parts: list[Table]) -> Table:
    """Column-wise concatenation of same-schema tables (store parts). When
    any part carries Z-set weights, every part gets an explicit weight
    column and the result is consolidated by rid."""
    if not parts:
        raise ValueError("concat_tables needs at least one part")
    if len(parts) == 1:
        return dict(parts[0])
    weighted = any(WEIGHT_COL in p for p in parts)
    if weighted:
        parts = [with_weight(p) for p in parts]
    out = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    return consolidate_zset(out) if weighted else out
