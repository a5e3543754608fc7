"""Evaluation layer: dtype casting, counters, validation (counterpart of
``pygradflow_tpu/eval.py``).

Counters are carried in an immutable ``Counters`` tuple of int64 tensors
on the solve's device: 0-dim for one instance, (B,) for a lane stack, so
that a CUDA graph of the loop advances them on every replay.  A non-finite
evaluation inside the loop does not raise: it surfaces as a non-finite
candidate, which the step controller rejects with doubled lambda.  Shapes
and finiteness at the initial point are checked eagerly.

:func:`lane_fns` turns the per-instance closures into closures over a lane
stack with ``torch.func.vmap``.
"""

from enum import Enum, auto
from typing import Callable, NamedTuple

import torch
from torch.func import vmap

from .params import Params
from .problem import Problem


class EvalError(ValueError):
    def __init__(self, msg, x=None):
        self.x = x
        super().__init__(msg)


class Component(Enum):
    Obj = auto()
    ObjGrad = auto()
    Cons = auto()
    ConsJac = auto()
    LagHess = auto()

    def name(self):
        return {
            Component.Obj: "Objective",
            Component.ObjGrad: "Objective Gradient",
            Component.Cons: "Constraints",
            Component.ConsJac: "Constraint Jacobian",
            Component.LagHess: "Lagrangian Hessian",
        }[self]


class Counters(NamedTuple):
    """Per-component evaluation counts (reference ``eval.py:60-85``)."""

    obj: int = 0
    obj_grad: int = 0
    cons: int = 0
    cons_jac: int = 0
    lag_hess: int = 0

    @staticmethod
    def zero(device="cpu", lead=()):
        """Zero counts of shape ``lead``: () for one instance, (B,) for a
        lane stack."""
        return Counters(*(torch.zeros(lead, dtype=torch.int64, device=device) for _ in range(5)))

    def add(self, *, obj=0, obj_grad=0, cons=0, cons_jac=0, lag_hess=0):
        return Counters(
            self.obj + obj,
            self.obj_grad + obj_grad,
            self.cons + cons,
            self.cons_jac + cons_jac,
            self.lag_hess + lag_hess,
        )

    def as_dict(self):
        return {
            Component.Obj: self.obj,
            Component.ObjGrad: self.obj_grad,
            Component.Cons: self.cons,
            Component.ConsJac: self.cons_jac,
            Component.LagHess: self.lag_hess,
        }


class Fns(NamedTuple):
    """dtype-cast evaluation closures of a (transformed) problem."""

    obj: Callable
    obj_grad: Callable
    cons: Callable
    cons_jac: Callable
    lag_hess: Callable
    num_vars: int
    num_cons: int
    # products J^T w, J v and H v by autodiff, without the (m, n) Jacobian
    # or the (n, n) Hessian
    cons_vjp: Callable = None
    cons_jvp: Callable = None
    lag_hvp: Callable = None
    # Params.matrix_free: the KKT residuals take J^T products through
    # cons_vjp, and the iterate holds no Jacobian
    matrix_free: bool = False


def make_fns(problem: Problem, params: Params) -> Fns:
    """Evaluation closures casting every result to ``params.dtype``; any
    trailing arguments (a parametric problem's data) pass through."""
    dtype = params.dtype
    n = problem.num_vars
    m = problem.num_cons

    def obj(x, *args):
        return problem.obj(x, *args).to(dtype)

    def obj_grad(x, *args):
        return problem.obj_grad(x, *args).to(dtype)

    def lag_hess(x, y, *args):
        return problem.lag_hess(x, y, *args).to(dtype)

    if m > 0:

        def cons(x, *args):
            return problem.cons(x, *args).to(dtype)

        def cons_jac(x, *args):
            return problem.cons_jac(x, *args).to(dtype)

        def cons_vjp(x, w, *args):
            return problem.cons_vjp(x, w, *args).to(dtype)

        def cons_jvp(x, v, *args):
            return problem.cons_jvp(x, v, *args).to(dtype)

    else:

        def cons(x, *args):
            return x.new_zeros(x.shape[:-1] + (0,), dtype=dtype)

        def cons_jac(x, *args):
            return x.new_zeros(x.shape[:-1] + (0, n), dtype=dtype)

        def cons_vjp(x, w, *args):
            return torch.zeros_like(x, dtype=dtype)

        def cons_jvp(x, v, *args):
            return x.new_zeros(x.shape[:-1] + (0,), dtype=dtype)

    def lag_hvp(x, y, v, *args):
        return problem.lag_hvp(x, y, v, *args).to(dtype)

    return Fns(
        obj, obj_grad, cons, cons_jac, lag_hess, n, m,
        cons_vjp=cons_vjp,
        cons_jvp=cons_jvp,
        lag_hvp=lag_hvp,
        matrix_free=params.matrix_free,
    )


def lane_fns(fns: Fns, data=None) -> Fns:
    """The closures of ``fns`` over a lane stack: points (B, n) and (B, m)
    in, values (B, ...) out, each lane evaluated on its own by
    ``torch.func.vmap``.  ``data``, a tuple of tensors with a leading lane
    dimension, goes through vmap as an argument of a parametric problem."""
    args = () if data is None else (data,)

    def lanes(f):
        batched = vmap(f)
        return lambda *xs: batched(*xs, *args)

    cons_fns = ("cons", "cons_jac", "cons_vjp", "cons_jvp")
    if fns.num_cons > 0:
        per_lane = {name: lanes(getattr(fns, name)) for name in cons_fns}
    else:  # no constraints: nothing to evaluate per lane
        per_lane = {}
    return fns._replace(
        obj=lanes(fns.obj),
        obj_grad=lanes(fns.obj_grad),
        lag_hess=lanes(fns.lag_hess),
        lag_hvp=lanes(fns.lag_hvp),
        **per_lane,
    )


def _finite(t) -> bool:
    return bool(torch.isfinite(t).all())


def validate_fns(fns: Fns, x0, y0) -> None:
    """Shapes and finiteness at the initial point; raises :class:`EvalError`
    like the reference ValidatingEvaluator (``eval.py:130-211``)."""
    n, m = fns.num_vars, fns.num_cons

    if not _finite(fns.obj(x0)):
        raise EvalError("Infinite objective", x0)

    grad = fns.obj_grad(x0)
    if tuple(grad.shape) != (n,):
        raise EvalError("Invalid shape of gradient", x0)
    if not _finite(grad):
        raise EvalError("Non-finite gradient", x0)

    if m > 0:
        cons = fns.cons(x0)
        if tuple(cons.shape) != (m,):
            raise EvalError("Invalid shape of constraints", x0)
        if not _finite(cons):
            raise EvalError("Non-finite constraints", x0)

        jac = fns.cons_jac(x0)
        if tuple(jac.shape) != (m, n):
            raise EvalError("Invalid shape of Jacobian", x0)
        if not _finite(jac):
            raise EvalError("Non-finite Jacobian", x0)

    hess = fns.lag_hess(x0, y0)
    if tuple(hess.shape) != (n, n):
        raise EvalError("Invalid shape of Hessian", x0)
    if not _finite(hess):
        raise EvalError("Non-finite Hessian", x0)

    if not torch.allclose(hess, hess.T, rtol=1e-5, atol=1e-8):
        from .log import logger

        logger.warning("Hessian not numerically symmetric")


def diagnose_eval_failure(fns: Fns, x, y):
    """Name the user callback that gives non-finite values at ``(x, y)``,
    or ``None`` when all are finite (the candidate itself was non-finite:
    a broken factorization, not an evaluation error)."""
    if not (_finite(x) and _finite(y)):
        return None

    checks = [
        (Component.Obj, lambda: fns.obj(x)),
        (Component.ObjGrad, lambda: fns.obj_grad(x)),
    ]
    if fns.num_cons > 0:
        checks += [
            (Component.Cons, lambda: fns.cons(x)),
            (Component.ConsJac, lambda: fns.cons_jac(x)),
        ]
    checks.append((Component.LagHess, lambda: fns.lag_hess(x, y)))

    for component, evaluate in checks:
        if not _finite(evaluate()):
            return component
    return None
