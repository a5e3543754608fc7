"""Batched and multi-device frontends (counterpart of ``pygradflow_tpu/parallel``)."""

from .batch import BatchedSolver, BatchResult, ParametricProblem  # noqa: F401
from .distributed import (  # noqa: F401
    DistributedInfo,
    DistributedSolver,
    host_batch_slice,
    init_distributed,
)
from .mixed import MixedPrecisionSolver  # noqa: F401
from .multistart import MultistartResult, multistart_solve  # noqa: F401
from .shard import ShardedSolver  # noqa: F401
from ..integration.batch import ShardedIntegrationSolver  # noqa: F401
