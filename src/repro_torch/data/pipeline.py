"""Training-data materialization pipeline, scheduled by S/C: the
counterpart of ``repro.data.pipeline``.

Every ingestion round refreshes a DAG of derived dataset artifacts

    ingest[i] ──► tokenize[i] ──► pack[i] ──► index  (+ stats per shard)

where every artifact is persisted (the restartability SLA) while consumers
read hot parents straight from the bounded Memory Catalog and persistence
runs on the background writer: the port's ``Controller`` and S/C Opt. The
tables live on the run's device (on the card the catalog is device
memory); the ingest draws with numpy from the reference's seeds, so every
table, and every batch, is bitwise the reference's.

The ``BatchIterator`` over packed shards is deterministic and
checkpointable (state = (epoch, cursor, seed), saved inside the training
checkpoint).
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from ..core import CostModel, solve
from ..device import resolve_device
from ..mv import Controller, DiskStore, MVNode, Workload


@dataclasses.dataclass(frozen=True)
class DataConfig:
    n_shards: int = 4
    docs_per_shard: int = 64
    doc_len: int = 512
    vocab_size: int = 1000
    seq_len: int = 128
    seed: int = 0
    catalog_budget_bytes: float = 64 << 20


def _ingest(shard: int, dcfg: DataConfig, device: torch.device):
    rng = np.random.default_rng(dcfg.seed * 1000 + shard)
    # zipf-ish synthetic corpus; "raw" docs as int64 (frontend stub)
    docs = rng.zipf(1.3, size=(dcfg.docs_per_shard, dcfg.doc_len))
    return {"docs": torch.from_numpy(np.asarray(docs, np.int64)).to(device)}


def _tokenize(table, dcfg: DataConfig):
    toks = ((table["docs"] % (dcfg.vocab_size - 2)) + 2).to(torch.int32)  # 0=pad, 1=eos
    toks[:, -1] = 1
    return {"tokens": toks}


def _pack(table, dcfg: DataConfig):
    flat = table["tokens"].reshape(-1)
    n = (len(flat) // dcfg.seq_len) * dcfg.seq_len
    return {"packed": flat[:n].reshape(-1, dcfg.seq_len)}


def _stats(table):
    toks = table["packed"]
    return {
        "n_seqs": torch.tensor([toks.shape[0]], dtype=torch.int64, device=toks.device),
        "token_hist": torch.bincount(toks.reshape(-1) % 64, minlength=64).to(torch.int64),
    }


def _index(tables):
    offsets, total = [], 0
    for t in tables:
        offsets.append(total)
        total += int(t["packed"].shape[0])
    dev = tables[0]["packed"].device
    return {"shard_offsets": torch.tensor(offsets, dtype=torch.int64, device=dev),
            "total": torch.tensor([total], dtype=torch.int64, device=dev)}


def build_pipeline_workload(dcfg: DataConfig,
                            device: str | torch.device | None = None) -> Workload:
    """The DAG above, its SCAN nodes making tables on ``device`` (default:
    the card)."""
    dev = resolve_device(device)
    nodes: list[MVNode] = []
    shard_bytes = dcfg.docs_per_shard * dcfg.doc_len * 8
    pack_nodes = []
    for i in range(dcfg.n_shards):
        ingest = len(nodes)
        nodes.append(MVNode(f"ingest{i}", (), "SCAN", shard_bytes, 0.01,
                            fn=(lambda inputs, i=i: _ingest(i, dcfg, dev))))
        tok = len(nodes)
        nodes.append(MVNode(f"tokenize{i}", (ingest,), "MAP", shard_bytes // 2,
                            0.01, fn=lambda inp: _tokenize(inp[0], dcfg)))
        pk = len(nodes)
        nodes.append(MVNode(f"pack{i}", (tok,), "PROJECT", shard_bytes // 2,
                            0.01, fn=lambda inp: _pack(inp[0], dcfg)))
        nodes.append(MVNode(f"stats{i}", (pk,), "AGG", 1 << 10, 0.005,
                            fn=lambda inp: _stats(inp[0])))
        pack_nodes.append(pk)
    nodes.append(MVNode("index", tuple(pack_nodes), "AGG", 1 << 10, 0.005,
                        fn=lambda inp: _index(inp)))
    return Workload("data_pipeline", nodes)


def materialize_dataset(dcfg: DataConfig, root: str | Path,
                        cost_model: CostModel | None = None,
                        device: str | torch.device | None = None) -> dict:
    """Run one S/C-scheduled refresh on ``device`` (default: the card);
    returns the plan, the run report, the workload and the store."""
    dev = resolve_device(device)
    cm = cost_model or CostModel()
    wl = build_pipeline_workload(dcfg, dev)
    graph = wl.to_graph(cm)
    plan = solve(graph, budget=dcfg.catalog_budget_bytes)
    store = DiskStore(root, device=dev)
    report = Controller(wl, store, dcfg.catalog_budget_bytes).run(plan)
    return {"plan": plan, "report": report, "workload": wl, "store": store}


# ---------------------------------------------------------------------------
# deterministic, checkpointable batch iterator
# ---------------------------------------------------------------------------

class BatchIterator:
    """Batches of ``batch_size`` packed rows on ``device`` (default: the
    card), in the reference's order: a numpy permutation per epoch seeded
    from ``(seed, epoch)``. ``tokens`` and ``labels`` are int32."""

    def __init__(self, root: str | Path, dcfg: DataConfig, batch_size: int,
                 device: str | torch.device | None = None):
        self.store = DiskStore(root, device=device)
        self.dcfg = dcfg
        self.batch_size = batch_size
        self._shards = [
            self.store.read(f"pack{i}")["packed"] for i in range(dcfg.n_shards)
        ]
        self.all = torch.cat(self._shards, dim=0)
        self.state = {"epoch": 0, "cursor": 0, "seed": dcfg.seed}
        self._perm = self._permutation()

    def _permutation(self) -> np.ndarray:
        rng = np.random.default_rng(self.state["seed"] * 7919 + self.state["epoch"])
        return rng.permutation(len(self.all))

    def set_state(self, state: dict) -> None:
        self.state = dict(state)
        self._perm = self._permutation()

    def get_state(self) -> dict:
        return dict(self.state)

    def next_batch(self) -> dict:
        b = self.batch_size
        if self.state["cursor"] + b > len(self.all):
            self.state["epoch"] += 1
            self.state["cursor"] = 0
            self._perm = self._permutation()
        idx = self._perm[self.state["cursor"]: self.state["cursor"] + b]
        self.state["cursor"] += b
        seqs = self.all[torch.from_numpy(idx).to(self.all.device)]
        return {
            "tokens": seqs[:, :-1].to(torch.int32),
            "labels": seqs[:, 1:].to(torch.int32),
        }
