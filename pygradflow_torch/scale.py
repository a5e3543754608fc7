"""Power-of-2 problem scaling (counterpart of ``pygradflow_tpu/scale.py``).

Integer weights per variable, constraint and objective, applied to the
exponents only (``ldexp``), so scaling and unscaling change no mantissa.
The weights are computed on the host with numpy, as in the JAX package;
the derivatives they are computed from are evaluated once on the solver's
device and copied back.  During a solve they are int64 tensors on the
device of the values they scale.

``torch.ldexp`` equals ``np.ldexp`` bit for bit, overflowing and subnormal
results included, on the CPU (``tests/test_torch_problem_scale.py``) and on
the card (``tests/test_torch_cuda.py``).
"""

from typing import Optional

import numpy as np
import torch

from .params import Params, ScalingType
from .problem import Problem
from .util import PerDevice


def scale_symmetric(A: np.ndarray, max_it: int = 100) -> np.ndarray:
    """Iterative symmetric equilibration: integer exponent weights ``D``
    such that ``ldexp(A[i, j], D[i] + D[j])`` has row norms in [1, 2)
    (the dense loop of ``pygradflow_tpu/scale.py:19-45``)."""
    A = np.abs(np.asarray(A, dtype=np.float64))
    (n, _) = A.shape

    D = np.zeros((n,), dtype=int)

    for _ in range(max_it):
        R = A.sum(axis=0)
        R[R < 1e-10] = 1.0
        R = np.sqrt(R)

        Rsca = 1 - np.frexp(R)[1]
        if (Rsca == 0).all():
            break

        A = np.ldexp(A, Rsca[:, None] + Rsca[None, :])
        D += Rsca
    else:
        raise Exception("Equilibration failed to converge")

    return D


def _DeviceWeights(weights: np.ndarray) -> PerDevice:
    """Integer weights as int64 tensors, one copy per device, made once."""
    return PerDevice(lambda device: torch.as_tensor(weights, dtype=torch.int64, device=device))


class _Ldexp(torch.autograd.Function):
    """``torch.ldexp`` with its derivative ``ldexp(g, e)``: torch's own takes
    ``2**e`` in integer arithmetic, which is 0 for a negative ``e``.  Works
    under ``torch.func`` (grad, jvp, jacfwd, vmap)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, e):
        return torch.ldexp(x, e)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[1])
        ctx.save_for_forward(inputs[1])

    @staticmethod
    def backward(ctx, grad):
        (e,) = ctx.saved_tensors
        return _Ldexp.apply(grad, e), None

    @staticmethod
    def jvp(ctx, x_t, e_t):
        (e,) = ctx.saved_tensors
        return _Ldexp.apply(x_t, e)


def ldexp(x, weights: PerDevice):
    """``x * 2**weights``, exactly, and differentiable in ``x``."""
    return _Ldexp.apply(x, weights.on(x))


class Scaling:
    """Integer power-of-2 scaling weights (reference ``scale.py:47-150``)."""

    def __init__(self, var_weights, cons_weights, obj_weight: int = 0):
        var_weights = np.asarray(var_weights)
        cons_weights = np.asarray(cons_weights)
        for name, w in (("var_weights", var_weights), ("cons_weights", cons_weights)):
            if w.ndim != 1 or not np.issubdtype(w.dtype, np.integer):
                raise ValueError(f"{name} must be a 1-D integer array, got {w.dtype} of shape {w.shape}")

        self.var_weights = var_weights
        self.cons_weights = cons_weights
        self.obj_weight = int(obj_weight)
        self._var = _DeviceWeights(var_weights)
        self._neg_var = _DeviceWeights(-var_weights)
        dual = cons_weights - self.obj_weight
        self._dual = _DeviceWeights(dual)
        self._neg_dual = _DeviceWeights(-dual)
        bound = var_weights - self.obj_weight
        self._bound = _DeviceWeights(bound)
        self._neg_bound = _DeviceWeights(-bound)

    @staticmethod
    def zero(num_vars, num_cons):
        return Scaling(np.zeros((num_vars,), dtype=int), np.zeros((num_cons,), dtype=int))

    @staticmethod
    def weights_from_nominal_values(values):
        return 1 - np.frexp(np.asarray(values))[1]

    @staticmethod
    def from_nominal_values(var_values, cons_values, obj_value=1.0):
        return Scaling(
            Scaling.weights_from_nominal_values(var_values),
            Scaling.weights_from_nominal_values(cons_values),
            int(Scaling.weights_from_nominal_values(obj_value)),
        )

    @staticmethod
    def from_grad_jac(obj_grad, cons_jac):
        """Variable weights from the gradient's magnitudes; constraint
        weights from the row maxima of the prescaled Jacobian, truncated to
        integers (reference ``scale.py:79-104``)."""
        obj_grad = np.asarray(obj_grad)
        var_weights = -Scaling.weights_from_nominal_values(np.abs(obj_grad))

        if cons_jac is None or np.asarray(cons_jac).shape[0] == 0:
            return Scaling(var_weights, np.zeros((0,), dtype=int))

        jac = np.abs(np.asarray(cons_jac, dtype=np.float64))
        prescaled = np.ldexp(jac, -var_weights[None, :])
        max_values = prescaled.max(axis=1).astype(int)

        cons_weights = Scaling.weights_from_nominal_values(max_values)
        return Scaling(var_weights, cons_weights)

    @staticmethod
    def from_equilibrated_kkt(lag_hess, cons_jac):
        lag_hess = np.asarray(lag_hess)
        cons_jac = np.asarray(cons_jac)
        (m, n) = cons_jac.shape
        if lag_hess.shape != (n, n):
            raise ValueError(f"Hessian of shape {lag_hess.shape}, expected {(n, n)}")

        kkt = np.zeros((n + m, n + m))
        kkt[:n, :n] = lag_hess
        kkt[:n, n:] = cons_jac.T
        kkt[n:, :n] = cons_jac

        weights = scale_symmetric(kkt)
        return Scaling(-weights[:n], weights[n:].astype(int))

    @property
    def num_vars(self):
        return len(self.var_weights)

    @property
    def num_cons(self):
        return len(self.cons_weights)

    def scale_primal(self, x):
        return ldexp(x, self._var)

    def unscale_primal(self, x):
        return ldexp(x, self._neg_var)

    def scale_dual(self, y):
        return ldexp(y, self._neg_dual)

    def unscale_dual(self, y):
        return ldexp(y, self._dual)

    def scale_bounds_dual(self, d):
        return ldexp(d, self._neg_bound)

    def unscale_bounds_dual(self, d):
        return ldexp(d, self._bound)


class ScaledProblem(Problem):
    """Problem wrapper rescaling every evaluation by the power-of-2 weights
    (reference ``scale.py:153-230``).  The products (``cons_vjp``, ...)
    come from autodiff of the scaled functions, as in the JAX package."""

    def __init__(self, problem: Problem, scaling: Scaling):
        self.problem = problem
        self.scaling = scaling
        sc = scaling

        var_lb = np.ldexp(problem.var_lb, sc.var_weights)
        var_ub = np.ldexp(problem.var_ub, sc.var_weights)
        cons_lb = np.ldexp(problem.cons_lb, sc.cons_weights)
        cons_ub = np.ldexp(problem.cons_ub, sc.cons_weights)

        self._obj_w = _DeviceWeights(np.asarray(sc.obj_weight))
        self._cons_w = _DeviceWeights(sc.cons_weights)
        self._jac_w = _DeviceWeights(sc.cons_weights[:, None] - sc.var_weights[None, :])
        self._hess_w = _DeviceWeights(sc.obj_weight - sc.var_weights[:, None] - sc.var_weights[None, :])

        super().__init__(var_lb, var_ub, cons_lb=cons_lb, cons_ub=cons_ub)

    def _orig_x(self, x):
        return self.scaling.unscale_primal(x)

    def obj(self, x, *args):
        return ldexp(self.problem.obj(self._orig_x(x), *args), self._obj_w)

    def obj_grad(self, x, *args):
        grad = self.problem.obj_grad(self._orig_x(x), *args)
        return ldexp(ldexp(grad, self.scaling._neg_var), self._obj_w)

    def cons(self, x, *args):
        return ldexp(self.problem.cons(self._orig_x(x), *args), self._cons_w)

    def cons_jac(self, x, *args):
        return ldexp(self.problem.cons_jac(self._orig_x(x), *args), self._jac_w)

    def lag_hess(self, x, y, *args):
        y_orig = self.scaling.unscale_dual(y)
        hess = self.problem.lag_hess(self._orig_x(x), y_orig, *args)
        return ldexp(hess, self._hess_w)


def create_scaling(
    problem: Problem,
    params: Params,
    scaling_primal: Optional[np.ndarray],
    scaling_dual: Optional[np.ndarray],
    device="cpu",
) -> Optional[Scaling]:
    """Factory keyed on ``ScalingType`` (reference ``scale.py:233-280``):
    ``None`` for ``NoScaling``.  The derivatives the weights are computed
    from are evaluated on ``device``."""
    scaling_type = params.scaling_type

    if params.scaling is not None:
        if scaling_type != ScalingType.Custom:
            raise ValueError("params.scaling requires ScalingType.Custom")
        return params.scaling

    if scaling_type == ScalingType.NoScaling:
        return None
    elif scaling_type == ScalingType.Custom:
        raise ValueError("Custom scaling requires explicit scaling")

    if scaling_primal is None:
        raise ValueError("Primal point required for scaling computation")

    scaling_primal = np.asarray(scaling_primal)
    if scaling_primal.shape != (problem.num_vars,):
        raise ValueError(f"scaling_primal of shape {scaling_primal.shape}, expected {(problem.num_vars,)}")
    x0 = torch.as_tensor(scaling_primal, dtype=torch.float64, device=device)

    def host(t):
        return t.detach().cpu().numpy()

    if scaling_type == ScalingType.Nominal:
        if problem.num_cons > 0:
            cons_val = host(problem.cons(x0))
        else:
            cons_val = np.array([], dtype=scaling_primal.dtype)
        return Scaling.from_nominal_values(scaling_primal, cons_val)

    if problem.num_cons > 0:
        cons_jac = host(problem.cons_jac(x0))
    else:
        cons_jac = np.zeros((0, problem.num_vars))

    if scaling_type == ScalingType.GradJac:
        return Scaling.from_grad_jac(host(problem.obj_grad(x0)), cons_jac)
    elif scaling_type == ScalingType.KKT:
        if scaling_dual is None:
            raise ValueError("Dual point required for KKT scaling computation")
        scaling_dual = np.asarray(scaling_dual)
        if scaling_dual.shape != (problem.num_cons,):
            raise ValueError(f"scaling_dual of shape {scaling_dual.shape}, expected {(problem.num_cons,)}")
        y0 = torch.as_tensor(scaling_dual, dtype=torch.float64, device=device)
        return Scaling.from_equilibrated_kkt(host(problem.lag_hess(x0, y0)), cons_jac)
    raise ValueError(f"Unknown scaling type {scaling_type}")
