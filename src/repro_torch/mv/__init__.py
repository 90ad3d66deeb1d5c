"""S/C materialization engine on PyTorch: the data plane and its CUDA
kernels, the table operators, the Memory Catalog, storage, the Controller
and the refresh engine."""
from . import dataplane
from .catalog import CatalogOverflowError, MemoryCatalog
from .engine import ScheduleCore, ThreadedEngine, simulate_events
from .executor import Controller, InjectedCrash, RunReport, calibrate_sizes
from .storage import DiskStore, partition_entry_name, table_nbytes
from .workloads import (
    MVNode,
    PAPER_WORKLOAD_SPECS,
    TPCDS_100GB_TABLES,
    UpdateSpec,
    Workload,
    generate_workload,
    incremental_view,
    paper_workloads,
    realize_workload,
    zipf_key_probs,
)

__all__ = [
    "dataplane",
    "MemoryCatalog",
    "CatalogOverflowError",
    "DiskStore",
    "table_nbytes",
    "partition_entry_name",
    "Controller",
    "RunReport",
    "InjectedCrash",
    "calibrate_sizes",
    "ScheduleCore",
    "ThreadedEngine",
    "simulate_events",
    "Workload",
    "MVNode",
    "UpdateSpec",
    "generate_workload",
    "incremental_view",
    "paper_workloads",
    "realize_workload",
    "zipf_key_probs",
    "PAPER_WORKLOAD_SPECS",
    "TPCDS_100GB_TABLES",
]
