"""Primal-dual iterate with its first-order evaluations, and the
augmented-Lagrangian calculus and KKT residuals on it (counterpart of
``pygradflow_tpu/iterate.py``).  The Hessian is not stored: the step
solvers evaluate it when they factor.

Every function serves one instance and a lane stack alike: an iterate's
fields then carry a leading lane axis, a penalty ``rho`` is a (B,) tensor,
and each residual is one value per lane.
"""

from typing import Any, NamedTuple

import torch

from .eval import Fns
from .util import dot, inf_norm, lanes, matvec, norm_mult


class Iterate(NamedTuple):
    x: Any
    y: Any
    obj: Any
    obj_grad: Any
    cons: Any
    cons_jac: Any


def evaluate_iterate(fns: Fns, x, y) -> Iterate:
    """Evaluate obj, gradient, constraints and Jacobian once at ``(x, y)``.

    In matrix-free mode the Jacobian is not evaluated: ``cons_jac`` holds a
    (..., 0, n) placeholder, every J^T product goes through
    ``fns.cons_vjp`` (``_jac_t`` tells the placeholder by its shape and
    raises when no ``fns`` was passed), and ``aug_lag_deriv_xx`` raises
    where its J^T J term would read it."""
    if fns.matrix_free:
        jac = x.new_zeros(x.shape[:-1] + (0, x.shape[-1]))
    else:
        jac = fns.cons_jac(x)
    return Iterate(
        x=x,
        y=y,
        obj=fns.obj(x),
        obj_grad=fns.obj_grad(x),
        cons=fns.cons(x),
        cons_jac=jac,
    )


def iterate_eval_counts(m: int) -> dict:
    """Counter increments of one evaluate_iterate call."""
    if m > 0:
        return dict(obj=1, obj_grad=1, cons=1, cons_jac=1)
    return dict(obj=1, obj_grad=1)


# Augmented Lagrangian L_rho(x, y) = f + rho/2 |c|^2 + y^T c
# (reference iterate.py:78-110)


def aug_lag_violation(it: Iterate, rho):
    return rho / 2.0 * dot(it.cons, it.cons)


def aug_lag_dual(it: Iterate):
    return dot(it.cons, it.y)


def aug_lag(it: Iterate, rho):
    return it.obj + aug_lag_violation(it, rho) + aug_lag_dual(it)


def _jac_t(it: Iterate, w, fns=None):
    """``J(x)^T w``: from the stored Jacobian, or through ``fns.cons_vjp``
    when the iterate is matrix-free (its Jacobian the placeholder of
    ``evaluate_iterate``, so the iterate alone decides)."""
    if it.cons_jac.shape[-2] == w.shape[-1]:
        return matvec(it.cons_jac.mT, w)
    if fns is None:
        raise ValueError("a matrix-free iterate needs fns for its J^T products")
    return fns.cons_vjp(it.x, w)


def aug_lag_deriv_x(it: Iterate, rho, fns=None):
    return it.obj_grad + _jac_t(it, lanes(rho, 1) * it.cons + it.y, fns)


def aug_lag_deriv_y(it: Iterate):
    return it.cons


def aug_lag_deriv_xx(fns: Fns, it: Iterate, rho):
    """``H(x, y + rho c) + rho J^T J``; with ``rho == 0.0`` (a Python float)
    the ``J^T J`` term is dropped, as the scaled step solvers need.  A
    matrix-free iterate holds no Jacobian for that term and raises."""
    if isinstance(rho, float) and rho == 0.0:
        return fns.lag_hess(it.x, it.y + rho * it.cons)
    if it.cons_jac.shape[-2] != it.cons.shape[-1]:
        raise ValueError("a matrix-free iterate holds no Jacobian for the J^T J term")
    hess = fns.lag_hess(it.x, it.y + lanes(rho, 1) * it.cons)
    return hess + lanes(rho, 2) * (it.cons_jac.mT @ it.cons_jac)


class ActiveSet(NamedTuple):
    at_lower: Any
    at_upper: Any
    at_both: Any
    at_either: Any
    violated: Any

    @property
    def satisfied(self):
        return ~self.violated


def compute_active_set(x, lb, ub, active_tol) -> ActiveSet:
    """Bound activity masks at a point (reference ``active_set.py``)."""
    at_lower = torch.abs(x - lb) <= active_tol
    at_upper = torch.abs(ub - x) <= active_tol
    violated = (lb - x > active_tol) | (x - ub > active_tol)
    at_both = at_lower & at_upper
    return ActiveSet(
        at_lower=at_lower & ~at_both,
        at_upper=at_upper & ~at_both,
        at_both=at_both,
        at_either=at_lower | at_upper,
        violated=violated,
    )


# KKT residuals (reference iterate.py:140-181)


def bounds_dual(it: Iterate, lb, ub, active_tol, fns=None):
    """Bound multipliers ``d`` from projected stationarity."""
    r = -(it.obj_grad + _jac_t(it, it.y, fns))
    aset = compute_active_set(it.x, lb, ub, active_tol)
    d = torch.zeros_like(it.x)
    d = torch.where(aset.at_upper, torch.clamp(r, min=0.0), d)
    d = torch.where(aset.at_lower, torch.clamp(r, max=0.0), d)
    return torch.where(aset.at_both, r, d)


def bound_violation(it: Iterate, lb, ub):
    lower = inf_norm(torch.clamp(lb - it.x, min=0.0))
    upper = inf_norm(torch.clamp(it.x - ub, min=0.0))
    return torch.maximum(lower, upper)


def cons_violation(it: Iterate):
    return inf_norm(it.cons)


def stat_res(it: Iterate, lb, ub, active_tol, fns=None):
    d = bounds_dual(it, lb, ub, active_tol, fns)
    return inf_norm(it.obj_grad + _jac_t(it, it.y, fns) + d)


def total_res(it: Iterate, lb, ub, active_tol, fns=None):
    return torch.maximum(
        torch.maximum(cons_violation(it), bound_violation(it, lb, ub)),
        stat_res(it, lb, ub, active_tol, fns),
    )


def is_feasible(it: Iterate, lb, ub, tol):
    return (cons_violation(it) <= tol) & (bound_violation(it, lb, ub) <= tol)


def locally_infeasible(it: Iterate, lb, ub, active_tol, feas_tol, local_infeas_tol, fns=None):
    """Infeasible stationarity (reference ``iterate.py:115-134``): the
    constraints are violated while the projected gradient of the violation
    measure vanishes.  A 0-dim bool tensor."""
    r = _jac_t(it, it.cons, fns)
    aset = compute_active_set(it.x, lb, ub, active_tol)
    r = torch.where(aset.at_lower, torch.clamp(r, max=0.0), r)
    r = torch.where(aset.at_upper, torch.clamp(r, min=0.0), r)
    return (cons_violation(it) > feas_tol) & (inf_norm(r) <= local_infeas_tol)


def obj_nonlin(it: Iterate, other: Iterate):
    """Nonlinearity of the objective between two iterates (reference
    ``iterate.py:183-190``): the first-order model's error over |dx|^2, 0
    for a step close to 0."""
    dx = other.x - it.x
    pred = it.obj + dot(dx, it.obj_grad)
    dx_dot = dot(dx, dx)
    val = torch.abs(other.obj - pred) / torch.where(dx_dot == 0.0, 1.0, dx_dot)
    return torch.where(torch.isclose(dx_dot, torch.zeros_like(dx_dot)), 0.0, val)


def cons_nonlin(it: Iterate, other: Iterate, fns=None):
    """The same for each constraint (reference ``iterate.py:192-198``); the
    J dx product goes through ``fns.cons_jvp`` when ``fns`` is matrix-free."""
    dx = other.x - it.x
    if fns is not None and fns.matrix_free:
        jdx = fns.cons_jvp(it.x, dx)
    else:
        jdx = matvec(it.cons_jac, dx)
    pred = it.cons + jdx
    dx_dot = dot(dx, dx)
    val = (other.cons - pred) / lanes(torch.where(dx_dot == 0.0, 1.0, dx_dot), 1)
    close = torch.isclose(dx_dot, torch.zeros_like(dx_dot))
    return torch.where(lanes(close, 1), torch.zeros_like(val), val)


def dist(it: Iterate, other: Iterate):
    return norm_mult(it.x - other.x, it.y - other.y)
