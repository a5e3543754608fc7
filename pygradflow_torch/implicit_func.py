"""Implicit (projection-residual) function of the implicit Euler step
(counterpart of ``pygradflow_tpu/implicit_func.py``).

For a step origin (x^, y^) and step size dt = 1/lambda the residual is

    F(x, y) = ( x - P_C(x^ - dt grad_x L_rho(x, y)),  y - (y^ + dt c(x)) )

or its variant scaled by lambda.  The active set is a boolean vector and
the projection clips only the active entries.
"""

from typing import Any, NamedTuple

import torch

from .iterate import Iterate, aug_lag_deriv_x

ACTIVE_EPS = 1e-8  # strict box tolerance (reference implicit_func.py:44)


class StepFunc(NamedTuple):
    """Step origin, step size (``lamb`` = 1/dt, a float) and bounds;
    ``scaled`` selects the lambda-scaled residual."""

    orig: Iterate
    lamb: float
    lb: Any
    ub: Any
    scaled: bool

    @property
    def dt(self):
        return 1.0 / self.lamb

    @property
    def proj_lb(self):
        return self.lamb * self.lb if self.scaled else self.lb

    @property
    def proj_ub(self):
        return self.lamb * self.ub if self.scaled else self.ub


def make_step_func(orig: Iterate, lamb, lb, ub, scaled: bool = True) -> StepFunc:
    return StepFunc(orig=orig, lamb=lamb, lb=lb, ub=ub, scaled=scaled)


def active_set_at_point(func: StepFunc, p):
    """Entries of ``p`` strictly outside the projection box."""
    return (p < func.proj_lb - ACTIVE_EPS) | (p > func.proj_ub + ACTIVE_EPS)


def project_box(func: StepFunc, p, active_set):
    """Clip only the active entries into the box."""
    return torch.where(active_set, torch.clamp(p, func.proj_lb, func.proj_ub), p)


def projection_initial(func: StepFunc, it: Iterate, rho):
    """Point whose projection defines the x-residual
    (``ActiveSetType.Standard``: no tau)."""
    d = aug_lag_deriv_x(it, rho)
    if func.scaled:
        return func.lamb * func.orig.x - d
    return func.orig.x - func.dt * d


def compute_active_set(func: StepFunc, it: Iterate, rho):
    return active_set_at_point(func, projection_initial(func, it, rho))


def value_at(func: StepFunc, it: Iterate, rho, active_set=None):
    """Residual value ``(rx, ry)``."""
    p = projection_initial(func, it, rho)
    if active_set is None:
        active_set = active_set_at_point(func, p)
    proj = project_box(func, p, active_set)

    if func.scaled:
        lamb = func.lamb
        rx = lamb * it.x - proj
        ry = -(lamb * it.y - (lamb * func.orig.y + it.cons))
    else:
        rx = it.x - proj
        ry = it.y - (func.orig.y + func.dt * it.cons)
    return rx, ry


def value_norm(func: StepFunc, it: Iterate, rho, active_set=None):
    rx, ry = value_at(func, it, rho, active_set)
    return torch.sqrt(torch.dot(rx, rx) + torch.dot(ry, ry))
