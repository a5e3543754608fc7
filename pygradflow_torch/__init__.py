"""pygradflow_torch: the sequential-homotopy NLP solver of pygradflow_tpu,
ported to PyTorch and CUDA.

The JAX package ``pygradflow_tpu`` is the reference; this package keeps its
module names and its decisions, with plain torch functions on float64
tensors (float32 under ``Precision.Single``), ``torch.func`` derivatives,
an eager solve loop, and hand-written CUDA kernels where the JAX package
has TPU kernels.  It imports no JAX and
changes no global torch setting: every tensor gets an explicit dtype and the
device chosen at ``Solver`` construction.
"""

from .params import (  # noqa: F401
    ActiveSetType,
    DerivCheck,
    IntegrationMethod,
    LinearSolverType,
    NewtonType,
    Params,
    PenaltyUpdate,
    Precision,
    ScalingType,
    StepControlType,
    StepSolverType,
)
from .problem import FuncProblem, Problem, QuadraticProblem  # noqa: F401
from .result import SolverResult  # noqa: F401
from .scale import Scaling  # noqa: F401
from .solver import Solver  # noqa: F401
from .status import SolverStatus  # noqa: F401

__version__ = "0.1.0"
