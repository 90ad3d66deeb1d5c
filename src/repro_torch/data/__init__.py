"""S/C-scheduled data materialization and a checkpointable batch iterator."""
from .pipeline import (
    BatchIterator,
    DataConfig,
    build_pipeline_workload,
    materialize_dataset,
)

__all__ = [
    "DataConfig",
    "build_pipeline_workload",
    "materialize_dataset",
    "BatchIterator",
]
