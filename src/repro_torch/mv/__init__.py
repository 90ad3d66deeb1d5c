"""S/C materialization engine on PyTorch: the data plane and its CUDA
kernels, the table operators, the Memory Catalog, storage, the Controller,
the refresh engine and simulator, the incremental and hash-partitioned
(full-vs-incremental update) refresh subsystem, multi-host partitioned
refresh with per-host budgets and fault re-dispatch (``multihost``), and the
operator IR with its multi-query optimisation (``ir``, ``mqo``)."""
from . import dataplane
from .catalog import CatalogOverflowError, MemoryCatalog
from .engine import ScheduleCore, ThreadedEngine, simulate_events
from .executor import Controller, InjectedCrash, RunReport, calibrate_sizes
from .incremental import (
    FallbackRateEwma,
    IncrementalEngine,
    RoundReport,
    ScenarioReport,
    SimScenarioReport,
    run_scenario,
    simulate_scenario,
    verify_scenario_equivalence,
)
from .multihost import (
    FaultAction,
    FaultPlan,
    HostPool,
    MultiHostRoundReport,
    MultiHostScenarioReport,
    StragglerConfig,
    place_partitions,
    run_multihost_scenario,
)
from .mqo import (
    MergedWorkload,
    merge_workload,
    node_fingerprints,
    shared_prefix_workload,
    verify_merged_equivalence,
)
from .partition import (
    PartitionMap,
    PartitionedScenarioReport,
    concat_partitions,
    dirty_partitions,
    hierarchical_round_solver,
    partition_of,
    partition_table,
    partition_workload,
    run_partitioned_scenario,
    verify_partitioned_equivalence,
)
from .simulator import SimReport, simulate, speedup
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
    "PartitionMap",
    "PartitionedScenarioReport",
    "concat_partitions",
    "dirty_partitions",
    "partition_of",
    "partition_table",
    "partition_workload",
    "hierarchical_round_solver",
    "run_partitioned_scenario",
    "verify_partitioned_equivalence",
    "Controller",
    "RunReport",
    "InjectedCrash",
    "calibrate_sizes",
    "ScheduleCore",
    "ThreadedEngine",
    "simulate_events",
    "FallbackRateEwma",
    "IncrementalEngine",
    "RoundReport",
    "ScenarioReport",
    "SimScenarioReport",
    "run_scenario",
    "simulate_scenario",
    "verify_scenario_equivalence",
    "FaultAction",
    "FaultPlan",
    "HostPool",
    "MultiHostRoundReport",
    "MultiHostScenarioReport",
    "StragglerConfig",
    "place_partitions",
    "run_multihost_scenario",
    "MergedWorkload",
    "merge_workload",
    "node_fingerprints",
    "shared_prefix_workload",
    "verify_merged_equivalence",
    "simulate",
    "speedup",
    "SimReport",
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
