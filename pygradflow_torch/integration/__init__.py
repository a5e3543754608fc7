"""The continuous engine (counterpart of ``pygradflow_tpu/integration``):
the restricted gradient flow integrated between events, on the host,
device and flat engines, and batched on the flat engine."""

from .batch import (  # noqa: F401
    BatchedIntegrationResult,
    BatchedIntegrationSolver,
    ShardedIntegrationSolver,
)
from .integration_solver import IntegrationSolver  # noqa: F401
