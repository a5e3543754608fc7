"""Implicit (projection-residual) function of the implicit Euler step
(counterpart of ``pygradflow_tpu/implicit_func.py``).

For a step origin (x^, y^) and step size dt = 1/lambda the residual is

    F(x, y) = ( x - P_C(x^ - dt grad_x L_rho(x, y)),  y - (y^ + dt c(x)) )

or its variant scaled by lambda.  The active set is a boolean vector and
the projection clips only the active entries.  ``lamb`` is a float for
one instance, or a (B,) tensor for a lane stack whose points are (B, n).
"""

from typing import Any, NamedTuple

import torch

from .iterate import Iterate, aug_lag_deriv_x
from .util import dot, lanes

ACTIVE_EPS = 1e-8  # strict box tolerance (reference implicit_func.py:44)


class StepFunc(NamedTuple):
    """Step origin, step size (``lamb`` = 1/dt) and bounds; ``scaled``
    selects the lambda-scaled residual."""

    orig: Iterate
    lamb: Any
    lb: Any
    ub: Any
    scaled: bool

    @property
    def dt(self):
        return 1.0 / self.lamb

    @property
    def proj_lb(self):
        return lanes(self.lamb, 1) * self.lb if self.scaled else self.lb

    @property
    def proj_ub(self):
        return lanes(self.lamb, 1) * self.ub if self.scaled else self.ub


def make_step_func(orig: Iterate, lamb, lb, ub, scaled: bool = True) -> StepFunc:
    return StepFunc(orig=orig, lamb=lamb, lb=lb, ub=ub, scaled=scaled)


def active_set_at_point(func: StepFunc, p):
    """Entries of ``p`` strictly outside the projection box."""
    return (p < func.proj_lb - ACTIVE_EPS) | (p > func.proj_ub + ACTIVE_EPS)


def project_box(func: StepFunc, p, active_set):
    """Clip only the active entries into the box."""
    return torch.where(active_set, torch.clamp(p, func.proj_lb, func.proj_ub), p)


def projection_initial(func: StepFunc, it: Iterate, rho, fns=None):
    """Point whose projection defines the x-residual
    (``ActiveSetType.Standard``: no tau).  ``fns`` carries the matrix-free
    J^T product (``iterate._jac_t``)."""
    d = aug_lag_deriv_x(it, rho, fns)
    if func.scaled:
        return lanes(func.lamb, 1) * func.orig.x - d
    return func.orig.x - lanes(func.dt, 1) * d


def compute_active_set(func: StepFunc, it: Iterate, rho, fns=None):
    return active_set_at_point(func, projection_initial(func, it, rho, fns))


def value_at(func: StepFunc, it: Iterate, rho, active_set=None, fns=None):
    """Residual value ``(rx, ry)``."""
    p = projection_initial(func, it, rho, fns)
    if active_set is None:
        active_set = active_set_at_point(func, p)
    proj = project_box(func, p, active_set)

    if func.scaled:
        lamb = lanes(func.lamb, 1)
        rx = lamb * it.x - proj
        ry = -(lamb * it.y - (lamb * func.orig.y + it.cons))
    else:
        rx = it.x - proj
        ry = it.y - (func.orig.y + lanes(func.dt, 1) * it.cons)
    return rx, ry


def value_norm(func: StepFunc, it: Iterate, rho, active_set=None, fns=None):
    rx, ry = value_at(func, it, rho, active_set, fns)
    return torch.sqrt(dot(rx, rx) + dot(ry, ry))
