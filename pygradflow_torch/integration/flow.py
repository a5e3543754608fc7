"""Augmented-Lagrangian gradient flow (counterpart of
``pygradflow_tpu/integration/flow.py``).

Right-hand side of the projected flow ``z' = (-P grad_x L_rho(x, y), c(x))``
and its dense Jacobian, as torch functions of ``(z, rho)`` and a boolean
free-variable ``filter`` (pinned variables have their x-velocity zeroed).
Each function serves one point ``z`` (n+m,) with the per-instance closures
of ``eval.Fns`` and a lane stack (B, n+m) with the closures of
``eval.lane_fns``; ``rho`` is then a Python float, a 0-dim tensor or a (B,)
tensor.  The first-order values at a point (gradient, constraints,
Jacobian) are evaluated once per call: :func:`rhs_and_jac` gives the
right-hand side and its Jacobian from one evaluation.  Products and norms
over axes of up to ``util.UNROLL_MAX`` entries add in a fixed order
(``util.rowsum``): a lane of a stack, the same point alone, and the same
point on the CPU and on a card then give the same bits, which the engines'
event decisions need to agree.
"""

from typing import Any, NamedTuple

import numpy as np
import torch

from ..eval import Fns
from ..util import UNROLL_MAX, lanes, rowsum, small_matvec

EPS = float(np.finfo(np.float64).eps)
XTOL = 4 * EPS
ATOL = 4 * EPS


def isclose(x, y):
    """Tight closeness test (reference ``flow.py:5-7``); ``y`` a tensor or
    a number."""
    if not torch.is_tensor(y):
        y = torch.full_like(x, y)
    return torch.isclose(x, y, rtol=XTOL, atol=ATOL)


class FlowCtx(NamedTuple):
    fns: Fns
    lb: Any
    ub: Any

    @property
    def n(self):
        return self.fns.num_vars

    @property
    def m(self):
        return self.fns.num_cons


def split(ctx: FlowCtx, z):
    return z[..., : ctx.n], z[..., ctx.n :]


def norm(v):
    """Euclidean norm over the last axis (``util.rowsum``'s order)."""
    return torch.sqrt(rowsum(v * v))


class FirstOrder(NamedTuple):
    """Gradient, constraints and Jacobian at one point (or lane stack)."""

    x: Any
    y: Any
    g: Any
    c: Any
    J: Any


def first_order(ctx: FlowCtx, z) -> FirstOrder:
    x, y = split(ctx, z)
    fns = ctx.fns
    return FirstOrder(x, y, fns.obj_grad(x), fns.cons(x), fns.cons_jac(x))


def _deriv_x(fo: FirstOrder, rho):
    return fo.g + small_matvec(fo.J.mT, lanes(rho, 1) * fo.c + fo.y)


def _hessian(ctx: FlowCtx, fo: FirstOrder, rho):
    """``H(x, y + rho c) + rho J^T J`` (``iterate.aug_lag_deriv_xx``), the
    ``J^T J`` product summed in ``util.rowsum``'s order."""
    hess = ctx.fns.lag_hess(fo.x, fo.y + lanes(rho, 1) * fo.c)
    J = fo.J
    m = J.shape[-2]
    if m == 0:
        return hess
    if m > UNROLL_MAX:
        jtj = J.mT @ J
    else:
        jtj = J[..., 0, :, None] * J[..., 0, None, :]
        for i in range(1, m):
            jtj = jtj + J[..., i, :, None] * J[..., i, None, :]
    return hess + lanes(rho, 2) * jtj


def _rhs(fo: FirstOrder, rho, filter):
    dx = -_deriv_x(fo, rho)
    if filter is not None:
        dx = dx * filter
    return torch.cat([dx, fo.c], dim=-1)


def _rhs_jac(ctx: FlowCtx, fo: FirstOrder, rho, filter):
    H = _hessian(ctx, fo, rho)
    J = fo.J
    top = torch.cat([-H, -J.mT], dim=-1)
    if filter is not None:
        top = torch.where(filter[..., :, None], top, 0.0)
    zeros = J.new_zeros(J.shape[:-2] + (ctx.m, ctx.m))
    bot = torch.cat([J, zeros], dim=-1)
    return torch.cat([top, bot], dim=-2)


def aug_lag_deriv_x(ctx: FlowCtx, z, rho):
    return _deriv_x(first_order(ctx, z), rho)


def rhs(ctx: FlowCtx, z, rho, filter=None):
    """Flow right-hand side; ``filter`` (bool (n,)) zeroes pinned primal
    velocities (reference ``restricted_flow.py:78-88``)."""
    return _rhs(first_order(ctx, z), rho, filter)


def rhs_jac(ctx: FlowCtx, z, rho, filter=None):
    """Dense Jacobian ``[[-P'H, -P'J^T], [J, 0]]``
    (reference ``restricted_flow.py:98-113``)."""
    return _rhs_jac(ctx, first_order(ctx, z), rho, filter)


def rhs_and_jac(ctx: FlowCtx, z, rho, filter=None):
    """:func:`rhs` and :func:`rhs_jac` at ``z`` from one evaluation."""
    fo = first_order(ctx, z)
    return _rhs(fo, rho, filter), _rhs_jac(ctx, fo, rho, filter)


def rhs_deriv_x(ctx: FlowCtx, z, rho):
    """Time derivative of the x-velocity along the flow
    (reference ``flow.py:118-137``), used for second-order tie-breaks."""
    fo = first_order(ctx, z)
    H = _hessian(ctx, fo, rho)
    return small_matvec(H, _deriv_x(fo, rho)) - small_matvec(fo.J.mT, fo.c)


def residuum(ctx: FlowCtx, z, filter):
    """Norm of the restricted flow at rho=0
    (reference ``restricted_flow.py:123-124``)."""
    return norm(rhs(ctx, z, 0.0, filter))


def obj(ctx: FlowCtx, z):
    x, _ = split(ctx, z)
    return ctx.fns.obj(x)

