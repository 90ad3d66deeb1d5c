"""Must-fire fixtures for the MQO merge-soundness pass (DESIGN.md §11).

Forged merge — the MQO hazard ``analysis.mqo_check`` exists to catch: two
views whose "shared" FILTER prefix differs only in a captured threshold,
with the merge provenance tampered to claim they are one equivalence class.
``forged_threshold_merge`` hand-builds that ``MergedWorkload``;
``genuine_shared_prefix_merge`` is the quiet counterpart (a real
``merge_workload`` result the pass must not flag).

The counterpart of the MQO half of ``repro.analysis.fixtures``. Both
fixtures type their IR on a device (the card unless the caller asks for the
CPU). The jaxpr half of the reference module (``legacy_fused_map``,
``shipped_map_kernels`` and the ``*_FILTER_MASK_SRC`` sources) belongs to
the determinism lints, which the port does not have yet.
"""
from __future__ import annotations

import dataclasses as dc

import torch

__all__ = ["forged_threshold_merge", "genuine_shared_prefix_merge"]


def forged_threshold_merge(device: str | torch.device | None = None):
    """A tampered ``MergedWorkload``: two FILTERs over the same scan whose
    captured thresholds differ (node indices 1 and 2 are not congruent
    mod 7, so ``filter_threshold`` gives each a distinct value), forged to
    claim a single equivalence class. ``mqo_check.check_merged`` must emit
    ``unsound-merge`` on it."""
    from ..mv import ir as mvir
    from ..mv.mqo import MergedWorkload, node_fingerprints
    from ..mv.workloads import MVNode, Workload

    wl = Workload(name="forged_prefix", nodes=[
        MVNode("scan", (), "SCAN", 1e6, 0.0, base_read=1e6),
        MVNode("a_filter", (0,), "FILTER", 7e5, 1e-4),
        MVNode("b_filter", (0,), "FILTER", 7e5, 1e-4),
        MVNode("a_view", (1,), "MAP", 7e5, 1e-4),
        MVNode("b_view", (2,), "MAP", 7e5, 1e-4),
    ])
    ir = mvir.infer_schemas(mvir.lift_workload(wl), device=device)
    fps = list(node_fingerprints(ir))

    # The forgery: claim b_filter computes what a_filter computes and
    # rewire b_view onto the "shared" representative.
    fps[2] = fps[1]
    rep_of = (0, 1, 1, 3, 4)
    keep = (0, 1, 3, 4)
    new_index = {0: 0, 1: 1, 3: 2, 4: 3}
    nodes, ir_nodes = [], []
    for orig in keep:
        n = wl.nodes[orig]
        parents = tuple(new_index[rep_of[p]] for p in n.parents)
        nodes.append(dc.replace(n, parents=parents))
        ir_nodes.append(dc.replace(ir.nodes[orig], parents=parents))
    merged_wl = Workload(name="forged_prefix_mqo", nodes=nodes)
    merged_ir = dc.replace(
        ir, nodes=tuple(ir_nodes), name=merged_wl.name
    )
    return MergedWorkload(
        source=wl,
        workload=merged_wl,
        ir=merged_ir,
        fingerprints=tuple(fps),
        rep_of=rep_of,
        keep=keep,
        name_map={
            "scan": "scan", "a_filter": "a_filter",
            "b_filter": "a_filter", "a_view": "a_view",
            "b_view": "b_view",
        },
        shared=("a_filter",),
        classes={
            "scan": (0,), "a_filter": (1, 2),
            "a_view": (3,), "b_view": (4,),
        },
    )


def genuine_shared_prefix_merge(device: str | torch.device | None = None):
    """The quiet counterpart: an honest ``merge_workload`` over the
    shared-prefix MQO workload. The soundness pass must report nothing."""
    from ..mv.mqo import merge_workload, shared_prefix_workload

    return merge_workload(shared_prefix_workload(n_views=2), device=device)
