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


def projection_initial(func: StepFunc, it: Iterate, rho, tau=None, fns=None):
    """Point whose projection defines the x-residual (reference
    ``implicit_func.py:134-147`` / ``:233-246``); ``tau`` is None for
    ``ActiveSetType.Standard``.  ``fns`` carries the matrix-free J^T product
    (``iterate._jac_t``)."""
    x0 = func.orig.x
    lamb = lanes(func.lamb, 1)
    d = aug_lag_deriv_x(it, rho, fns)
    if tau is not None:
        tau = lanes(tau, 1)

    if func.scaled:
        if tau is not None:
            f_x = lamb * (1.0 - tau * lamb)
            f_x0 = tau * lamb * lamb
            f_d = tau * lamb
            return f_x * it.x + f_x0 * x0 - f_d * d
        return lamb * x0 - d
    if tau is not None:
        return (1.0 - tau * lamb) * it.x + (tau * lamb) * x0 - tau * d
    return x0 - lanes(func.dt, 1) * d


def compute_active_set(func: StepFunc, it: Iterate, rho, tau=None, fns=None):
    return active_set_at_point(func, projection_initial(func, it, rho, tau, fns))


def value_at(func: StepFunc, it: Iterate, rho, active_set=None, fns=None):
    """Residual value ``(rx, ry)``."""
    p = projection_initial(func, it, rho, fns=fns)
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


def deriv(func: StepFunc, jac, hess, active_set):
    """Dense Newton matrix of the residual, ``P'`` zeroing the active rows:
    unscaled ``[[I + dt P'H, dt P'J^T], [-dt J, I]]`` (reference
    ``implicit_func.py:163-188``), scaled ``[[lamb I + P'H, P'J^T], [-J,
    lamb I]]`` (``:254-283``)."""
    n = hess.shape[-1]
    m = jac.shape[-2]
    inactive = (~active_set)[..., :, None]
    eye_n = torch.eye(n, dtype=hess.dtype, device=hess.device)
    eye_m = torch.eye(m, dtype=hess.dtype, device=hess.device).expand(jac.shape[:-2] + (m, m))

    if func.scaled:
        lamb = lanes(func.lamb, 2)
        F11 = lamb * eye_n + torch.where(inactive, hess, 0.0)
        F12 = torch.where(inactive, jac.mT, 0.0)
        F21 = -jac
        F22 = lamb * eye_m
    else:
        dt = lanes(func.dt, 2)
        F11 = eye_n + torch.where(inactive, dt * hess, 0.0)
        F12 = torch.where(inactive, dt * jac.mT, 0.0)
        F21 = -dt * jac
        F22 = eye_m

    top = torch.cat([F11, F12], dim=-1)
    bot = torch.cat([F21, F22], dim=-1)
    return torch.cat([top, bot], dim=-2)
