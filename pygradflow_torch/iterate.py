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
from .util import dot, inf_norm, lanes, matvec


class Iterate(NamedTuple):
    x: Any
    y: Any
    obj: Any
    obj_grad: Any
    cons: Any
    cons_jac: Any


def evaluate_iterate(fns: Fns, x, y) -> Iterate:
    """Evaluate obj, gradient, constraints and Jacobian once at ``(x, y)``."""
    return Iterate(
        x=x,
        y=y,
        obj=fns.obj(x),
        obj_grad=fns.obj_grad(x),
        cons=fns.cons(x),
        cons_jac=fns.cons_jac(x),
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


def _jac_t(it: Iterate, w):
    return matvec(it.cons_jac.mT, w)


def aug_lag_deriv_x(it: Iterate, rho):
    return it.obj_grad + _jac_t(it, lanes(rho, 1) * it.cons + it.y)


def aug_lag_deriv_xx(fns: Fns, it: Iterate, rho):
    """``H(x, y + rho c) + rho J^T J``; with ``rho == 0.0`` (a Python float)
    the ``J^T J`` term is dropped, as the scaled step solvers need."""
    if isinstance(rho, float) and rho == 0.0:
        return fns.lag_hess(it.x, it.y + rho * it.cons)
    hess = fns.lag_hess(it.x, it.y + lanes(rho, 1) * it.cons)
    return hess + lanes(rho, 2) * (it.cons_jac.mT @ it.cons_jac)


class ActiveSet(NamedTuple):
    at_lower: Any
    at_upper: Any
    at_both: Any


def compute_active_set(x, lb, ub, active_tol) -> ActiveSet:
    """Bound activity masks at a point (reference ``active_set.py``)."""
    at_lower = torch.abs(x - lb) <= active_tol
    at_upper = torch.abs(ub - x) <= active_tol
    at_both = at_lower & at_upper
    return ActiveSet(
        at_lower=at_lower & ~at_both,
        at_upper=at_upper & ~at_both,
        at_both=at_both,
    )


# KKT residuals (reference iterate.py:140-181)


def bounds_dual(it: Iterate, lb, ub, active_tol):
    """Bound multipliers ``d`` from projected stationarity."""
    r = -(it.obj_grad + _jac_t(it, it.y))
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


def stat_res(it: Iterate, lb, ub, active_tol):
    d = bounds_dual(it, lb, ub, active_tol)
    return inf_norm(it.obj_grad + _jac_t(it, it.y) + d)


def total_res(it: Iterate, lb, ub, active_tol):
    return torch.maximum(
        torch.maximum(cons_violation(it), bound_violation(it, lb, ub)),
        stat_res(it, lb, ub, active_tol),
    )


def is_feasible(it: Iterate, lb, ub, tol):
    return (cons_violation(it) <= tol) & (bound_violation(it, lb, ub) <= tol)


def locally_infeasible(it: Iterate, lb, ub, active_tol, feas_tol, local_infeas_tol):
    """Infeasible stationarity (reference ``iterate.py:115-134``): the
    constraints are violated while the projected gradient of the violation
    measure vanishes.  A 0-dim bool tensor."""
    r = _jac_t(it, it.cons)
    aset = compute_active_set(it.x, lb, ub, active_tol)
    r = torch.where(aset.at_lower, torch.clamp(r, max=0.0), r)
    r = torch.where(aset.at_upper, torch.clamp(r, min=0.0), r)
    return (cons_violation(it) > feas_tol) & (inf_norm(r) <= local_infeas_tol)
