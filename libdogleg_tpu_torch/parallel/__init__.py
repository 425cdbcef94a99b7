from libdogleg_tpu_torch.parallel.mesh import make_mesh
from libdogleg_tpu_torch.parallel.sharded import (
    MeasurementShardedProblem,
    MeasurementShardedSparseProblem,
    measurement_sharded_products,
)
from libdogleg_tpu_torch.parallel.batched import (batched_optimize,
                                                   batched_optimize_compacted,
                                                   shard_batch)

__all__ = [
    "make_mesh",
    "MeasurementShardedProblem",
    "MeasurementShardedSparseProblem",
    "measurement_sharded_products",
    "batched_optimize",
    "batched_optimize_compacted",
    "shard_batch",
]
