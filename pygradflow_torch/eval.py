"""Evaluation layer: dtype casting, counters, validation (counterpart of
``pygradflow_tpu/eval.py``).

Counters are plain ints carried in an immutable ``Counters`` tuple.  A
non-finite evaluation inside the loop does not raise: it surfaces as a
non-finite candidate, which the step controller rejects with doubled
lambda.  Shapes and finiteness at the initial point are checked eagerly.
"""

from enum import Enum, auto
from typing import Callable, NamedTuple

import torch

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
    def zero():
        return Counters()

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


def make_fns(problem: Problem, params: Params) -> Fns:
    """Evaluation closures casting every result to ``params.dtype``."""
    if params.matrix_free:
        raise NotImplementedError("matrix_free is not yet ported (ROADMAP A9)")
    dtype = params.dtype
    n = problem.num_vars
    m = problem.num_cons

    def obj(x):
        return problem.obj(x).to(dtype)

    def obj_grad(x):
        return problem.obj_grad(x).to(dtype)

    def lag_hess(x, y):
        return problem.lag_hess(x, y).to(dtype)

    if m > 0:

        def cons(x):
            return problem.cons(x).to(dtype)

        def cons_jac(x):
            return problem.cons_jac(x).to(dtype)

    else:

        def cons(x):
            return x.new_zeros((0,), dtype=dtype)

        def cons_jac(x):
            return x.new_zeros((0, n), dtype=dtype)

    return Fns(obj, obj_grad, cons, cons_jac, lag_hess, n, m)


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
