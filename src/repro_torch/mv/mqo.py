"""Multi-query optimization: shared-subexpression delta compilation
(DESIGN.md §11).

View definitions across one workload frequently share whole prefixes — the
same filtered scan feeding the same join, consumed by several reporting
views. A refresh loop without MQO recomputes such a prefix once *per
view*; Mistry et al.'s MQO insight (PAPERS.md) is that a shared
subtree should be refreshed exactly once per round and treated as an
extra-high-benefit residency candidate: it is consumed by multiple
children, which is the paper's short-circuit objective compounded.

This module implements that over the operator IR (``mv.ir``):

* ``node_fingerprints`` — structural DAG hashing over ``OpNode``s: a
  node's fingerprint covers its effective op kind, parameters, typed
  schema, partition provenance, and its parents' fingerprints *in order*
  (JOIN is left-driven and UNION rid-ordered, so argument order is
  semantics). ``lifted=False`` closures hash as opaque-unique — an
  unrecognized closure must never merge with anything. SCANs hash as
  identity: two scan nodes generate *different data* (their delta_fns are
  seeded by node index), so a scan is only ever equal to itself.
* ``merge_workload`` — rewrite a realized workload into its shared DAG:
  one node per fingerprint equivalence class (the representative is the
  first member, so topological order is preserved), every consumer rewired
  to the representative. Merged nodes execute **compiled delta programs**
  (``ir.compile_node`` chains, OpenIVM's compile-don't-interpret framing)
  instead of the per-closure interpretation they were lifted from; the
  compiled closures carry ``param_src`` provenance so the merged workload
  re-lifts into the IR and stays statically analyzable
  (``analysis.mqo_check`` re-derives every class independently).
* ``verify_merged_equivalence`` — the bitwise contract: after any
  scenario, every original MV's stored bytes must equal its
  representative's bytes in the merged store. Sharing changes how many
  times a subtree is computed, never the bytes it produces.

Planner coupling comes for free: rewiring consumers multiplies the
representative's child count, and ``core.speedup.score_graph`` scores
``t_i = n_children·(read_disk − read_mem) + (write_disk − write_mem)`` —
a subtree shared by three views earns three read-savings terms, so shared
intermediates surface as first-class residency candidates without a
special case in ``core.altopt`` (see its module docstring).

``shared_prefix_workload`` builds the canonical benchmark shape: 2-4
views over one fact/dim scan pair, each view repeating the same
FILTER→JOIN prefix before a view-distinct tail. Duplicate FILTERs sit at
indices congruent mod 7 so ``workloads.filter_threshold`` gives them
identical thresholds — the merge is real, not forged.

The counterpart of ``repro.mv.mqo``: fingerprints, classes and merged stores
are the reference's exactly. The merge types its IR on a device (the card
unless the caller asks for the CPU), and merged nodes run the port's
operators on their inputs' device.
"""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import hashlib

import torch

from ..device import resolve_device
from . import ir as mvir
from .storage import DiskStore
from . import tableops as T
from .workloads import MVNode, Workload, OP_THROUGHPUT

__all__ = [
    "MergedWorkload",
    "node_fingerprints",
    "merge_workload",
    "verify_merged_equivalence",
    "shared_prefix_workload",
]


# ---------------------------------------------------------------------------
# Structural fingerprints
# ---------------------------------------------------------------------------

def node_fingerprints(ir: mvir.ViewIR) -> tuple[str, ...]:
    """Structural fingerprint of every node: equal fingerprints ⇔ the nodes
    compute the same content from the same sources.

    * opaque (``lifted=False``) nodes: unique by construction (index+name in
      the basis) — an uninspectable closure never merges;
    * SCAN / source nodes: identity — a scan's delta_fn is seeded by its
      node index, so two scans produce different data even with identical
      layout parameters;
    * lifted operators: effective op kind (the JOIN/UNION unary fallthrough
      included), parameters, typed output schema, partition id, and the
      parents' fingerprints in argument order.
    """
    fps: list[str] = []
    for idx, node in enumerate(ir.nodes):
        if not node.lifted:
            basis: tuple = ("opaque", idx, node.name)
        elif node.op == "SCAN" or not node.parents:
            basis = ("scan", idx, node.name, node.params, node.partition)
        else:
            basis = (
                node.effective_op,
                node.params,
                node.schema.columns if node.schema is not None else None,
                node.partition,
                tuple(fps[p] for p in node.parents),
            )
        fps.append(hashlib.sha256(repr(basis).encode()).hexdigest())
    return tuple(fps)


# ---------------------------------------------------------------------------
# The merge
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MergedWorkload:
    """A workload rewritten into its shared DAG, plus the provenance the
    bitwise verifier and the sc-lint soundness pass consume."""

    source: Workload                      # the unshared original
    workload: Workload                    # deduped, compiled, engine-ready
    ir: mvir.ViewIR                       # deduped IR (typed)
    fingerprints: tuple[str, ...]         # per *original* node
    rep_of: tuple[int, ...]               # original idx -> representative idx
    keep: tuple[int, ...]                 # kept original indices (ascending)
    name_map: dict[str, str]              # original name -> representative name
    shared: tuple[str, ...]               # representative names with ≥2 members
    classes: dict[str, tuple[int, ...]]   # rep name -> member original indices

    @property
    def n_merged_away(self) -> int:
        return self.source.n - self.workload.n


def merge_workload(
    workload: Workload,
    ir: mvir.ViewIR | None = None,
    device: str | torch.device | None = None,
) -> MergedWorkload:
    """Detect common subexpressions across the MV definitions of
    ``workload`` and rewrite it into the shared DAG.

    Each fingerprint equivalence class keeps its first member (minimum
    index — parents always precede children, so the kept list is already
    topological) and drops the rest; consumers are rewired to the
    representative, so a shared subtree is refreshed exactly once per round
    and its representative's planner benefit carries the full fan-out.
    Kept lifted non-scan nodes run compiled delta programs
    (``ir.compile_node``); scans and opaque closures keep their original
    fns. The merged workload drives ``run_scenario`` unchanged. Schema
    inference (when ``ir`` is not given) runs on ``device`` (default: the
    card, raising without one).
    """
    dev = resolve_device(device)
    if ir is None:
        ir = mvir.infer_schemas(mvir.lift_workload(workload), device=dev)
    if ir.n != workload.n:
        raise ValueError(
            f"IR/workload shape mismatch: {ir.n} vs {workload.n} nodes"
        )
    fps = node_fingerprints(ir)
    first: dict[str, int] = {}
    rep_of: list[int] = []
    for idx, fp in enumerate(fps):
        rep_of.append(first.setdefault(fp, idx))
    keep = sorted(set(rep_of))
    new_index = {orig: pos for pos, orig in enumerate(keep)}

    nodes: list[MVNode] = []
    ir_nodes: list[mvir.OpNode] = []
    for orig in keep:
        n = workload.nodes[orig]
        irn = ir.nodes[orig]
        parents = tuple(new_index[rep_of[p]] for p in n.parents)
        fn = n.fn
        if n.op != "SCAN" and n.parents and irn.lifted and n.fn is not None:
            fn = mvir.compile_node(irn, param_index=irn.param_src)
        nodes.append(dataclasses.replace(n, parents=parents, fn=fn))
        ir_nodes.append(dataclasses.replace(irn, parents=parents))

    members: dict[int, list[int]] = {}
    for idx, rep in enumerate(rep_of):
        members.setdefault(rep, []).append(idx)
    name_map = {
        workload.nodes[idx].name: workload.nodes[rep].name
        for idx, rep in enumerate(rep_of)
    }
    classes = {
        workload.nodes[rep].name: tuple(m) for rep, m in members.items()
    }
    shared = tuple(
        workload.nodes[rep].name
        for rep in keep
        if len(members[rep]) >= 2
    )
    meta = dict(workload.meta)
    meta["mqo"] = dict(
        n_source=workload.n,
        n_merged=len(keep),
        shared=shared,
        name_map=dict(name_map),
    )
    merged_wl = Workload(
        name=workload.name + "_mqo", nodes=nodes, meta=meta
    )
    merged_ir = dataclasses.replace(
        ir, nodes=tuple(ir_nodes), name=merged_wl.name
    )
    return MergedWorkload(
        source=workload,
        workload=merged_wl,
        ir=merged_ir,
        fingerprints=fps,
        rep_of=tuple(rep_of),
        keep=tuple(keep),
        name_map=name_map,
        shared=shared,
        classes=classes,
    )


def verify_merged_equivalence(
    merged: MergedWorkload, shared_store: DiskStore, ref_store: DiskStore
) -> None:
    """Assert every original MV is bitwise identical to its representative
    in the merged store — the MQO correctness contract: sharing may change
    how often a subtree executes, never the bytes any view stores. Each
    representative is read once and held against every MV it stands for,
    read side by side with them (one thread each)."""
    by_rep: dict[str, list[str]] = {}
    for node in merged.source.nodes:
        by_rep.setdefault(merged.name_map[node.name], []).append(node.name)
    with cf.ThreadPoolExecutor(1 + max(map(len, by_rep.values()), default=0)) as pool:
        for rep, names in by_rep.items():
            got = pool.submit(shared_store.read, rep)
            for name, want in zip(names, pool.map(ref_store.read, names)):
                T.assert_tables_bitwise(want, got.result(), f"{name}->{rep}")


# ---------------------------------------------------------------------------
# The canonical shared-prefix workload (benchmark + test substrate)
# ---------------------------------------------------------------------------

# View-distinct 5-op tails: the FIRST tail op differs across views so only
# the FILTER→JOIN prefix is common — tails must never merge.
_TAILS = (
    ("MAP", "FILTER", "PROJECT", "MAP", "AGG"),
    ("PROJECT", "MAP", "FILTER", "MAP", "AGG"),
    ("FILTER", "MAP", "PROJECT", "MAP", "AGG"),
    ("AGG", "MAP", "PROJECT", "FILTER", "MAP"),
)
_VIEW_BLOCK = 7  # FILTER + JOIN + 5 tail ops per view

# modeled output fraction of input bytes per op (midpoints of the
# generator's OP_SELECTIVITY ranges; calibration replaces these with
# measured bytes before any plan is solved)
_SEL = {"FILTER": 0.7, "PROJECT": 0.8, "MAP": 1.2, "JOIN": 1.0, "AGG": 0.2}


def shared_prefix_workload(
    n_views: int = 3,
    fact_bytes: float = 8e6,
    dim_bytes: float = 2e6,
    name: str | None = None,
) -> Workload:
    """2-4 views sharing a FILTER→JOIN prefix over one fact/dim scan pair.

    Layout: nodes 0-1 are the fact and dim SCANs; view ``v`` occupies the
    7-node block starting at ``2 + 7v`` — FILTER(fact), JOIN(filter, dim),
    then a 5-op view-distinct tail. Every view's FILTER sits at an index
    ``≡ 2 (mod 7)``, so ``filter_threshold`` gives all of them the *same*
    threshold: the per-view prefixes are genuinely identical and
    ``merge_workload`` collapses them to one FILTER and one JOIN. Realize
    with ``realize_workload`` as usual; the modeled sizes below only seed
    calibration.
    """
    if not (2 <= n_views <= len(_TAILS)):
        raise ValueError(f"n_views must be in [2, {len(_TAILS)}]")

    nodes: list[MVNode] = []

    def add(name_, op, parents, size, base_read=0.0):
        in_bytes = (
            sum(nodes[p].size for p in parents) if parents else base_read
        )
        nodes.append(MVNode(
            name=name_, parents=tuple(parents), op=op, size=size,
            compute=in_bytes / OP_THROUGHPUT[op], base_read=base_read,
        ))

    add("fact", "SCAN", (), fact_bytes * 0.08, base_read=fact_bytes)
    add("dim", "SCAN", (), dim_bytes * 0.08, base_read=dim_bytes)
    for v in range(n_views):
        base = len(nodes)
        assert base == 2 + _VIEW_BLOCK * v and base % _VIEW_BLOCK == 2
        add(f"v{v}_filter", "FILTER", (0,),
            nodes[0].size * _SEL["FILTER"])
        add(f"v{v}_join", "JOIN", (base, 1),
            (nodes[base].size + nodes[1].size) * _SEL["JOIN"])
        prev = base + 1
        for j, op in enumerate(_TAILS[v]):
            add(f"v{v}_t{j}_{op.lower()}", op, (prev,),
                nodes[prev].size * _SEL[op])
            prev = len(nodes) - 1
    return Workload(
        name=name or f"shared_prefix_v{n_views}",
        nodes=nodes,
        meta=dict(n_views=n_views, shared_prefix=True),
    )
