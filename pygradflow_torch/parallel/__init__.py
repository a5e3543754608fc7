"""Batched frontends (counterpart of ``pygradflow_tpu/parallel``)."""

from .batch import BatchedSolver, BatchResult, ParametricProblem  # noqa: F401
