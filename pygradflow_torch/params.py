"""Solver parameters and enums.

The same configuration surface as ``pygradflow_tpu.params``: every field,
default and enum member, so that a configuration written for the JAX
package carries over unchanged (``convert.params_from_jax``).
"""

import dataclasses
import enum
from dataclasses import dataclass
from enum import Enum, Flag, auto
from typing import Any, Callable, Optional

import numpy as np


class ActiveSetType(Enum):
    """Heuristic used to pick the tau parameter controlling the active-set
    projection point (reference ``pygradflow/step/newton_control.py:60-88``)."""

    Standard = auto()
    Explicit = auto()
    SmallestActiveSet = auto()
    LargestActiveSet = auto()


class NewtonType(Enum):
    """Semismooth Newton variant (reference ``pygradflow/newton.py``)."""

    Simplified = auto()
    """Derivative and active set frozen at the step origin (cheapest)."""
    Full = auto()
    """Re-evaluate derivatives and active set at every inner iteration."""
    ActiveSet = auto()
    """Derivatives frozen, active set recomputed each iterate."""
    Globalized = auto()
    """Full Newton with Armijo line search on the residual merit."""
    FixedActiveSet = auto()
    """User-fixed active set (``params.fixed_active_set``), derivatives
    re-evaluated + refactored each inner step.  The reference ships this
    as ``FixedActiveSetNewtonMethod`` (``newton.py:92-178``) but its
    ``__init__`` dereferences a module as an object (``newton.py:101``),
    so it is unreachable dead code there; this is a working equivalent in
    this package's active-set convention (True = pinned/clipped)."""


class StepSolverType(Enum):
    """KKT system formulation (reference ``pygradflow/step/solver/``)."""

    Standard = auto()
    """Raw unsymmetric implicit-function Jacobian ``[[I + dt P'H, dt P'J^T], [-dt J, I]]``."""
    Extended = auto()
    """Scaled, permuted formulation (dense: the same assembly as Asymmetric)."""
    Symmetric = auto()
    """Scaled symmetric saddle-point formulation (supports inertia correction)."""
    Asymmetric = auto()
    """Scaled full-size formulation with identity rows for active variables."""
    Schur = auto()
    """Block-structured formulation: block-diagonal Hessian elimination with
    a dense dual Schur complement (requires ``schur_block_size``); no
    reference counterpart — SURVEY §7.5c."""


class LinearSolverType(Enum):
    """Dense/iterative linear-algebra backend for the KKT solve.

    The reference binds native libraries (SuperLU/CHOLMOD/MA57/MUMPS/SSIDS,
    ``pygradflow/linear_solver/``); here each maps to a dense tier.
    """

    LU = auto()
    """Dense LU factorization; the default, maps reference LUSolver."""
    Cholesky = auto()
    """Dense Cholesky; fails (rejecting the step) on non-posdef matrices."""
    LDLT = auto()
    """Dense blocked LDL^T with inertia extraction (maps MA57/MUMPS/SSIDS)."""
    PallasLDLT = auto()
    """Mixed-precision LDL^T tier with inertia extraction.  The name is kept
    from the JAX package so configurations carry over; on this port it is
    the hand-written CUDA kernels (``csrc/ldlt.cu``) for the f32 factor,
    then f64 iterative refinement."""
    MINRES = auto()
    """Iterative MINRES (symmetric step solver only), pure JAX while_loop."""
    GMRES = auto()
    """Iterative GMRES, pure JAX."""


class StepControlType(Enum):
    Exact = auto()
    Fixed = auto()
    Optimizing = auto()
    BoxReduced = auto()
    ResiduumRatio = auto()
    DistanceRatio = auto()


class PenaltyUpdate(Enum):
    Constant = auto()
    DualNorm = auto()
    DualEquilibration = auto()
    ParetoDecrease = auto()
    ObjectiveFilter = auto()
    LagrangianFilter = auto()


class Precision(Enum):
    """Floating point precision used in all calculations
    (reference ``params.py:131-143``)."""

    Single = auto()
    Double = auto()


class DerivCheck(Flag):
    """Derivative checking flags (reference ``pygradflow/params.py:146-163``)."""

    NoCheck = 0
    CheckFirst = 1 << 0
    CheckSecond = 1 << 1
    CheckAll = CheckFirst | CheckSecond


class IntegrationMethod(Enum):
    """Stepper used by the IntegrationSolver's segment integrator.

    The reference delegates to scipy BDF
    (``pygradflow/integration/integration_solver.py:278-285``); the
    JAX package ships three one-step methods."""

    SDIRK4 = auto()
    """L-stable 5-stage SDIRK of order 4 (Hairer & Wanner II, Table 6.5,
    gamma=1/4) with an embedded 3rd-order error estimate; one Jacobian
    factorization per attempted step shared by all stages.  Matches the
    step counts of the reference's scipy BDF-5 (HS71: 194 vs 180, Tame:
    240 vs 239 at rho=1e-2) where TR-BDF2 needs 2.4-2.9x more; event
    sequences are identical in kind and order, but the higher accuracy
    typically converges before the final penalty rung fires (one fewer
    segment than the TR-BDF2/reference tail — see PARITY.md)."""

    TRBDF2 = auto()
    """L-stable one-step TR-BDF2 (trapezoidal + BDF2 composite, order 2
    with an embedded 3rd-order error estimate); one Jacobian
    factorization per attempted step.  Default: reproduces the
    reference's event/segment sequences exactly."""

    ImplicitEuler = auto()
    """Step-doubled implicit Euler with Richardson extrapolation; three
    full-Newton solves per attempted step.  Slower but maximally
    robust."""


class ScalingType(Enum):
    """Problem scaling strategy (reference ``pygradflow/scale.py:233-280``)."""

    NoScaling = auto()
    GradJac = auto()
    KKT = auto()
    Nominal = auto()
    Custom = auto()


@dataclass
class Params:
    """Parameters controlling a solve.

    Field names, semantics and defaults follow the reference
    (``pygradflow/params.py:197-266``) so configurations written for the
    reference carry over unchanged.
    """

    rho: float = 1e-8

    theta_max: float = 0.9
    theta_ref: float = 0.5

    lamb_init: float = 1.0
    lamb_min: float = 1e-12
    lamb_max: float = 1e12
    lamb_inc: float = 2.0
    lamb_red: float = 0.5

    K_P: float = 0.2
    K_I: float = 0.005

    opt_tol: float = 1e-6
    lamb_term: float = 1e-8
    active_tol: float = 1e-8

    local_infeas_tol: float = 1e-8

    active_set_type: ActiveSetType = ActiveSetType.Standard
    active_set_method: Optional[Callable[..., float]] = None
    active_set_tau: Optional[float] = None

    newton_type: NewtonType = NewtonType.Simplified
    newton_tol: float = 1e-8
    # explicit active set for NewtonType.FixedActiveSet (bool array over
    # the TRANSFORMED variables, True = pinned); None derives it from the
    # step-origin iterate via newton.active_set_from_iterate
    fixed_active_set: Optional[Any] = None

    step_control_type: StepControlType = StepControlType.DistanceRatio

    step_solver: Optional[Callable[..., Any]] = None
    step_solver_type: StepSolverType = StepSolverType.Symmetric
    linear_solver_type: LinearSolverType = LinearSolverType.LU
    penalty_update: PenaltyUpdate = PenaltyUpdate.DualNorm

    deriv_check: DerivCheck = DerivCheck.NoCheck
    deriv_pert: float = 1e-8
    deriv_tol: float = 1e-4

    precision: Precision = Precision.Double

    scaling_type: ScalingType = ScalingType.NoScaling

    scaling_primal: Optional[np.ndarray] = None
    scaling_dual: Optional[np.ndarray] = None

    scaling: Optional[Any] = None  # Scaling instance

    validate_input: bool = True

    iteration_limit: Optional[int] = None
    time_limit: float = float(np.inf)
    display_interval: float = 0.1
    display: bool = False

    obj_lower_limit: float = -1e10

    report_rcond: bool = False
    collect_path: bool = False

    inertia_correction: bool = False

    # --- knobs of the JAX package (no reference counterpart) -------------
    jit_chunk: int = 64
    """Outer iterations between two time-limit checks.  In the JAX package
    it is also the length of one compiled ``while_loop`` chunk; the eager
    loop of this port keeps only the time-limit cadence."""

    filter_capacity: int = 64
    """Fixed capacity of the penalty filters' Pareto front (the reference's
    filter list, ``pygradflow/penalty.py:186-238``, is unbounded)."""

    path_capacity: int = 4096
    """Maximum number of iterates recorded when ``collect_path`` is set."""

    iteration_limit_default: int = 10_000
    """Hard cap used when ``iteration_limit`` is None (the loop still
    terminates on convergence; this only bounds the path buffer)."""

    schur_block_size: Optional[int] = None
    schur_dual_block_size: Optional[int] = None
    """Hessian block size for StepSolverType.Schur: the (transformed)
    Hessian must be block diagonal with contiguous blocks of this size."""

    matrix_free: bool = False
    """Never materialize the dense ``(m, n)`` Jacobian or ``(n, n)``
    Hessian in the solve loop: KKT-residual J^T-products go through
    autodiff ``cons_vjp`` and, with ``StepSolverType.Schur`` +
    ``schur_dual_block_size``, the factorization is assembled from
    stage-local Jacobian/Hessian BLOCKS extracted by comb-basis
    jvp/hvp probes (``step/schur_staged.py``).  Requires derivatives
    consistent with autodiff of ``obj``/``cons`` (the default) and, for
    the staged factorization, the Schur tier's block structure: Hessian
    block-diagonal (``schur_block_size``), constraint block ``r``
    touching only stages ``r-1`` and ``r``.  The long-horizon
    optimal-control lever: per-iteration cost drops from O(n^2)-dense to
    O(stages) (`benchmarks/bench_control.py`)."""

    profile_dir: Optional[str] = None
    """When set, ``Solver.solve`` runs under ``torch.profiler`` and writes
    a Chrome trace of the solve into this directory."""

    newton_max_it: int = 10
    """Maximum inner Newton iterations of the Exact controller."""

    integration_method: IntegrationMethod = IntegrationMethod.TRBDF2
    """One-step method of the IntegrationSolver's segment integrator.
    TR-BDF2 (order 2) is the parity default — it reproduces the
    reference's event/segment sequences exactly.  Prefer SDIRK4 (order
    4) for perturbed/batched sweeps: its creep-phase step cost scales as
    (scale/tol)^(1/5) vs TR-BDF2's ^(1/3), and a rare start whose rho
    ladder climbs to 1e7 can cost TR-BDF2 tens of thousands of steps
    where SDIRK4 needs ~1.5k (PARITY.md residual-envelope note)."""

    integration_rtol: float = 1e-6
    integration_atol: float = 1e-9
    """Local error tolerances of the adaptive segment integrator
    (scipy-style per-component scale ``atol + rtol*|z|``).  Deliberately
    TIGHTER than the reference's BDF call (which passes no tolerances,
    so scipy defaults rtol=1e-3/atol=1e-6 apply,
    ``integration_solver.py:278-285``): scipy localizes events by
    root-finding on a smooth dense-output interpolant, so a loose path
    still yields accurate event times, whereas our vectorized
    discrete-crossing tests + bisection re-integration see the path
    itself — measured at scipy's defaults (benchmarks/probe_tol.py),
    HS71 wanders (1540 steps vs 194, converges 0.5 away from the
    optimum) while only Tame gets cheaper (93 vs 240 steps)."""

    integration_max_steps: int = 300_000
    """Hard cap on attempted steps per integration segment."""

    integration_device_loop: bool = False
    """Run the ENTIRE continuous solve (segments, event bisection,
    filter/penalty switches) as one device-resident loop
    (``integration/device_loop.py``) instead of the host-driven event
    loop: one dispatch per solve instead of several per segment —
    the latency path on accelerators behind slow links.  Incompatible
    with ``collect_path`` and live display (the host loop is used then).
    With a finite ``time_limit`` the solve runs through the flat chunked
    engine (``integration/flat_loop.py``) so the limit is enforced at
    chunk boundaries and no dispatch is unboundedly long."""

    integration_chunk: int = 512
    """Work units (step attempts / bisection probes) per dispatch of the
    flat chunked engine: batched continuous solves and time-limited
    device-loop solves.  Bounds dispatch length (a wedged dispatch
    cannot exceed one chunk) and sets the cadence of time-limit checks
    and converged-lane harvesting."""

    linesearch_max_it: int = 30
    """Maximum Armijo backtracking trials of the globalized Newton method."""

    def __post_init__(self):
        for key, attr in self.annotations():
            if isinstance(attr, enum.EnumMeta):
                val = getattr(self, key)
                if isinstance(val, str):
                    setattr(self, key, attr[val])

    @property
    def dtype(self):
        """The torch dtype of every floating-point tensor of a solve."""
        import torch

        if self.precision == Precision.Single:
            return torch.float32
        return torch.float64

    def annotations(self):
        return type(self).__annotations__.items()

    def write(self, filename):
        import yaml

        class Dumper(yaml.SafeDumper):
            def represent_data(self, data):
                if isinstance(data, enum.Enum):
                    return self.represent_data(data.name)
                # numpy arrays, tensors and numpy scalars (fixed_active_set,
                # scaling_primal/dual, ...) have no SafeDumper representer;
                # round-trip them through plain lists / python scalars
                if isinstance(data, np.generic) or (
                    not isinstance(data, (str, bytes, enum.Enum))
                    and type(data).__module__ not in ("builtins",)
                    and hasattr(data, "tolist")
                ):
                    return self.represent_data(data.tolist())
                return super().represent_data(data)

        with open(filename, "w") as f:
            yaml.dump(dataclasses.asdict(self), f, Dumper=Dumper)

    @staticmethod
    def read(filename):
        import yaml

        with open(filename, "r") as f:
            data = yaml.safe_load(f)
            return Params(**data)
