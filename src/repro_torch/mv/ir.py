"""Operator IR: view definitions lifted out of Python closures (DESIGN.md §10).

``realize_workload`` / ``partition_workload`` attach per-node compute
closures (``MVNode.fn``) that the engine interprets node by node. Those
closures are opaque: nothing can inspect *which* operator a node applies or
*what* schema flows along an edge without executing it. This module lifts
them into an explicit, schema-typed operator DAG:

* ``lift_workload`` walks each closure's free variables (``make_fn`` captures
  its node index and op kind; partitioned scans wrap a ``_ScanRouter`` whose
  original closures are recovered through the router) and emits one
  ``OpNode`` per MV with its operator kind, parameters (FILTER threshold,
  PROJECT keep fraction, SCAN table layout), and partition provenance.
  Parameters come from the same module-level constants the closures execute
  (``workloads.filter_threshold`` / ``workloads.PROJECT_KEEP_FRAC``), so the
  lift cannot drift from the execution. Closures the lifter does not
  recognize degrade gracefully: the node is marked ``lifted=False`` and
  round-trips as its original closure.

* ``infer_schemas`` types every edge by *abstract interpretation over
  zero-row tables*: each operator runs on empty inputs with the real
  ``tableops`` kernels, so the inferred column names/dtypes are exact by
  construction (no re-implementation of operator semantics that could
  drift). Schemas describe the stored *content* of a node — the transient
  Z-set ``weight`` column of a delta is bookkeeping, not schema.

* ``compile_node`` / ``to_workload`` run the DAG back through ``tableops``
  in exactly the order the original closures did, so IR-driven execution is
  bitwise-identical to closure execution (property-tested across the
  scenario matrix). SCAN ingestion is data, not view logic: scans keep
  their original ``delta_fn``.

The static passes in ``repro_torch.analysis`` consume this IR, and
``mv.mqo`` builds on it: structural fingerprints over ``OpNode``s detect common
subexpressions across MV definitions, and the merged workload's nodes run
``compile_node`` programs instead of per-closure interpretation. Compiled
closures capture the same ``i`` / ``op`` free variables as
``realize_workload.make_fn`` (``param_src`` provenance), so a compiled or
merged workload re-lifts into the IR and stays statically analyzable.

The counterpart of ``repro.mv.ir``. Schemas keep numpy dtype strings
(``'<i8'``, ``'<f4'``), so fingerprints over them hash exactly as the
reference's; ``Schema.from_table`` reads a tensor's dtype alone, never its
data, so it works on tables on the card. Schema inference runs the operators
on zero-row tensors on a device (the card unless the caller asks for the
CPU); the data-plane wrappers return before launching on empty inputs.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping

import numpy as np
import torch

from ..device import resolve_device
from . import tableops as T
from .workloads import MVNode, Workload, filter_threshold, PROJECT_KEEP_FRAC

__all__ = [
    "Schema",
    "OpNode",
    "ViewIR",
    "lift_workload",
    "infer_schemas",
    "compile_node",
    "to_workload",
    "scan_table_schema",
]

IR_OPS = ("SCAN", "FILTER", "PROJECT", "MAP", "JOIN", "AGG", "UNION")


# ---------------------------------------------------------------------------
# Schema: typed column layout of a node's stored content
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Schema:
    """Ordered ``(column name, dtype string)`` pairs of a node's *content*
    (what a full build stores — Z-set deltas may transiently add ``weight``).
    Column order is part of the schema: tableops preserves it and the
    bitwise-equivalence contract compares it."""

    columns: tuple[tuple[str, str], ...]

    @classmethod
    def from_table(cls, table: Mapping[str, torch.Tensor]) -> "Schema":
        return cls(tuple(
            (k, _numpy_dtype(v.dtype).str)
            for k, v in table.items() if k != T.WEIGHT_COL
        ))

    def names(self) -> tuple[str, ...]:
        return tuple(k for k, _ in self.columns)

    @property
    def has_rid(self) -> bool:
        return "rid" in self.names()

    @property
    def has_key(self) -> bool:
        return "key" in self.names()

    def data_names(self) -> tuple[str, ...]:
        return tuple(k for k, _ in self.columns if k not in T.META_COLS)

    def to_dtypes(self) -> dict[str, torch.dtype]:
        return {k: _torch_dtype(d) for k, d in self.columns}

    def empty_table(self, device: str | torch.device | None = None) -> T.Table:
        """A zero-row table of this schema on ``device`` (default: the card)."""
        return T.empty_like(self.to_dtypes(), device=device)


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of a torch dtype (through a zero-element CPU tensor:
    no data is read, so the column may lie on any device)."""
    return torch.empty(0, dtype=dtype).numpy().dtype


def _torch_dtype(dtype: str | np.dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype (string)."""
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


def scan_table_schema(n_cols: int, with_rid: bool = True) -> Schema:
    """Layout of a ``make_base_table`` scan output: int64 ``key`` (+ ``rid``),
    ``n_cols - 1`` float32 value columns."""
    cols: list[tuple[str, str]] = [("key", np.dtype(np.int64).str)]
    if with_rid:
        cols.append(("rid", np.dtype(np.int64).str))
    f32 = np.dtype(np.float32).str
    cols.extend((f"c{c}", f32) for c in range(max(int(n_cols), 1) - 1))
    return Schema(tuple(cols))


# ---------------------------------------------------------------------------
# IR nodes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class OpNode:
    """One MV as an explicit operator application."""

    name: str
    op: str
    parents: tuple[int, ...]
    params: tuple[tuple[str, object], ...] = ()
    schema: Schema | None = None
    size: float = 0.0            # modeled/calibrated output bytes
    lifted: bool = True          # False: closure not recognized, kept opaque
    partition: int | None = None  # partition id when lifted from a P-way wl
    # index the closure derived its parameters from (``make_fn``'s captured
    # ``i``); None when the node was not lifted. ``compile_node`` re-captures
    # it so compiled programs round-trip through ``lift_workload``.
    param_src: int | None = None

    def param(self, key: str, default=None):
        for k, v in self.params:
            if k == key:
                return v
        return default

    @property
    def effective_op(self) -> str:
        """The operator the closure actually applies: ``make_fn`` degrades a
        JOIN/UNION with fewer than two inputs to its unary fallthrough (MAP),
        and the IR mirrors that contract exactly."""
        if self.op in ("JOIN", "UNION") and len(self.parents) < 2:
            return "MAP"
        return self.op


@dataclasses.dataclass(frozen=True)
class ViewIR:
    """Schema-typed operator DAG lifted from one workload."""

    nodes: tuple[OpNode, ...]
    name: str = ""
    n_partitions: int = 1

    @property
    def n(self) -> int:
        return len(self.nodes)

    def edges(self) -> tuple[tuple[int, int], ...]:
        return tuple(
            (p, i) for i, nd in enumerate(self.nodes) for p in nd.parents
        )

    def children(self) -> list[list[int]]:
        out: list[list[int]] = [[] for _ in self.nodes]
        for p, c in self.edges():
            out[p].append(c)
        return out

    def roots(self) -> tuple[int, ...]:
        return tuple(i for i, nd in enumerate(self.nodes) if not nd.parents)


# ---------------------------------------------------------------------------
# Lifting: closure free-variable walk
# ---------------------------------------------------------------------------

def _cells(fn) -> dict[str, object]:
    """Free variables of a closure by name (empty for plain functions)."""
    code = getattr(fn, "__code__", None)
    clo = getattr(fn, "__closure__", None)
    if code is None or not clo:
        return {}
    return dict(zip(code.co_freevars, (c.cell_contents for c in clo)))


def _unwrap_partition(fn) -> tuple[object, int | None]:
    """Partitioned scans wrap a ``_ScanRouter``: ``_scan_fn(router, p)``
    closures carry the router and partition id; the router holds the original
    closure. Returns ``(base_fn, partition_id)``."""
    cv = _cells(fn)
    router, p = cv.get("router"), cv.get("p")
    if router is not None and isinstance(p, int):
        base = getattr(router, "_fn", None) or getattr(router, "_delta", None)
        return base, p
    return fn, None


def _scan_layout(delta_fn) -> dict[str, int] | None:
    """Recover ``(rows, n_cols, key_mod)`` from a realized scan's ``delta_fn``
    closure chain (``delta_fn`` captures ``initial_load``, which captures the
    generation parameters)."""
    if delta_fn is None:
        return None
    base, _ = _unwrap_partition(delta_fn)
    cv = _cells(base)
    init = cv.get("initial_load")
    if init is None:
        return None
    icv = _cells(init)
    if "rows" not in icv or "n_cols" not in icv:
        return None
    return {
        "rows": int(icv["rows"]),
        "n_cols": int(icv["n_cols"]),
        "key_mod": int(icv.get("kmod", 0)),
    }


def lift_workload(workload: Workload) -> ViewIR:
    """Lift a (realized, partitioned, or modeled-only) workload into a
    ``ViewIR``. Nodes whose closures are not the known ``make_fn`` /
    ``_scan_fn`` shapes are kept opaque (``lifted=False``) — they still
    carry op/parents/size from the ``MVNode`` metadata, and ``to_workload``
    round-trips them as their original closures."""
    meta = workload.meta.get("partition") or {}
    n_partitions = int(meta.get("n_partitions", 1))
    nodes: list[OpNode] = []
    for idx, n in enumerate(workload.nodes):
        base_fn, partition = (
            _unwrap_partition(n.fn) if n.fn is not None else (None, None)
        )
        cv = _cells(base_fn) if base_fn is not None else {}
        node_i = cv.get("i")
        lifted = n.fn is not None and isinstance(node_i, int) and \
            cv.get("op") == n.op
        # parameter source index: the closure's captured index when lifted
        # (a partitioned node's base index, not its expanded position),
        # else the node's own index (modeled-only workloads execute nothing,
        # so the fallback only feeds the static passes)
        i = node_i if lifted else idx
        params: list[tuple[str, object]] = []
        if n.op == "FILTER":
            params = [("col", "c0"), ("threshold", filter_threshold(i))]
        elif n.op == "PROJECT":
            params = [("keep_frac", PROJECT_KEEP_FRAC)]
        elif n.op == "SCAN":
            layout = _scan_layout(n.delta_fn)
            if layout:
                params = sorted(layout.items())
        if partition is None and n_partitions > 1:
            partition = idx % n_partitions  # partition_workload index layout
        nodes.append(OpNode(
            name=n.name,
            op=n.op,
            parents=tuple(n.parents),
            params=tuple(params),
            size=float(n.size),
            lifted=bool(lifted or (n.fn is None and n.op != "SCAN")),
            partition=partition,
            param_src=node_i if lifted else None,
        ))
    return ViewIR(
        nodes=tuple(nodes), name=workload.name, n_partitions=n_partitions
    )


# ---------------------------------------------------------------------------
# Schema inference: abstract interpretation over zero-row tables
# ---------------------------------------------------------------------------

def infer_schemas(
    ir: ViewIR,
    scan_schemas: Mapping[int, Schema] | None = None,
    default_n_cols: int = 4,
    device: str | torch.device | None = None,
) -> ViewIR:
    """Return a ``ViewIR`` with every node's output ``Schema`` filled.

    Each operator is *executed on zero-row tables* of its parents' schemas
    through the real ``tableops`` kernels — the inferred schema is exact by
    construction wherever the lift is exact. ``scan_schemas`` overrides the
    layout of specific scan nodes (by index); otherwise a scan's layout comes
    from its lifted parameters, falling back to ``default_n_cols``. The
    zero-row tables lie on ``device`` (default: the card)."""
    dev = resolve_device(device)
    scan_schemas = dict(scan_schemas or {})
    empties: list[T.Table] = []
    typed: list[OpNode] = []
    for idx, node in enumerate(ir.nodes):
        if node.op == "SCAN" or not node.parents:
            if idx in scan_schemas:
                schema = scan_schemas[idx]
            else:
                n_cols = int(node.param("n_cols", default_n_cols))
                schema = scan_table_schema(n_cols)
            table = schema.empty_table(dev)
        else:
            fn = compile_node(node)
            table = fn([empties[p] for p in node.parents])
            schema = Schema.from_table(table)
        empties.append(Schema.from_table(table).empty_table(dev))
        typed.append(dataclasses.replace(node, schema=schema))
    return dataclasses.replace(ir, nodes=tuple(typed))


# ---------------------------------------------------------------------------
# IR-driven execution (the round trip back to tableops)
# ---------------------------------------------------------------------------

def compile_node(
    node: OpNode,
    delta_fn: Callable | None = None,
    param_index: int | None = None,
) -> Callable:
    """Compile one ``OpNode`` to ``fn(inputs) -> Table``, applying the same
    ``tableops`` calls in the same order as ``realize_workload.make_fn`` —
    including its JOIN/UNION unary fallthrough — so the compiled DAG is
    bitwise-identical to the closure it was lifted from.

    ``param_index`` (usually ``node.param_src``) makes the compiled closure
    *re-liftable*: it captures the same ``i`` / ``op`` free variables as
    ``make_fn``, so ``lift_workload`` recognizes compiled programs — merged
    MQO workloads stay analyzable by the static passes. The claim is made
    only when the node's params match what a re-lift would derive from that
    index (a hand-edited IR must not re-lift into wrong parameters)."""
    op = node.op
    if op == "SCAN" or not node.parents:
        if delta_fn is None:
            raise ValueError(
                f"{node.name}: SCAN compilation needs the ingestion delta_fn"
            )
        return lambda inputs: delta_fn(0)
    threshold = node.param("threshold", 0.0)
    col = node.param("col", "c0")
    keep_frac = node.param("keep_frac", 0.5)
    i = param_index
    if i is not None and (
        (op == "FILTER" and (threshold != filter_threshold(i) or col != "c0"))
        or (op == "PROJECT" and keep_frac != PROJECT_KEEP_FRAC)
    ):
        i = None  # params diverge from the index: drop the re-lift claim

    def fn(inputs):
        _ = i  # free-variable capture: lift_workload re-lifts compiled nodes
        if op == "JOIN" and len(inputs) >= 2:
            out = inputs[0]
            for other in inputs[1:]:
                out = T.op_join(out, other)
            return out
        if op == "UNION" and len(inputs) >= 2:
            out = inputs[0]
            for other in inputs[1:]:
                out = T.op_union(out, other)
            return out
        x = inputs[0]
        if op == "FILTER":
            return T.op_filter(x, col=col, threshold=threshold)
        if op == "PROJECT":
            return T.op_project(x, keep_frac=keep_frac)
        if op == "AGG":
            return T.op_agg(x)
        return T.op_map(x)

    return fn


def to_workload(ir: ViewIR, workload: Workload) -> Workload:
    """The IR-driven twin of ``workload``: every lifted non-scan node's
    closure is replaced by its compiled IR program; scans (ingestion is
    data, not view logic) and unlifted nodes keep their original closures.
    The result runs through the engine/scenario machinery unchanged and is
    bitwise-identical to the original (``tests/test_torch_ir.py``)."""
    if ir.n != workload.n:
        raise ValueError(
            f"IR/workload shape mismatch: {ir.n} vs {workload.n} nodes"
        )
    nodes: list[MVNode] = []
    for node, orig in zip(ir.nodes, workload.nodes):
        if node.op != "SCAN" and orig.parents and node.lifted and \
                orig.fn is not None:
            nodes.append(dataclasses.replace(
                orig, fn=compile_node(node, param_index=node.param_src)
            ))
        else:
            nodes.append(orig)
    return Workload(
        name=workload.name + "_ir", nodes=nodes, meta=dict(workload.meta)
    )
