"""Batched frontends (counterpart of ``pygradflow_tpu/parallel``)."""

from .batch import BatchedSolver, BatchResult, ParametricProblem  # noqa: F401
from .mixed import MixedPrecisionSolver  # noqa: F401
from .multistart import MultistartResult, multistart_solve  # noqa: F401
