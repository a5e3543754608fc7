"""User-facing problem definition (counterpart of ``pygradflow_tpu/problem.py``).

A subclass defines ``obj(x)`` (and ``cons(x)`` when there are constraints)
as functions of a 1-D float64 tensor written with torch operations.  The
derivatives come from ``torch.func``: ``grad`` for the objective gradient,
``jacfwd`` for the dense constraint Jacobian, ``jacfwd`` of the Lagrangian
gradient for the Hessian, and ``jvp``/``vjp`` for the products.  A
subclass that defines a derivative method itself overrides the default.

Every evaluation method takes optional trailing arguments, ``*args``, and
passes them on to ``obj`` and ``cons``: a parametric problem receives its
per-instance data that way (``parallel/batch.py``), and a plain problem
receives none.
"""

import abc

import numpy as np
import torch
from torch.func import grad, jacfwd, jvp, vjp

from .util import PerDevice


class Problem(abc.ABC):
    """Nonlinear program ``min f(x)  s.t.  l <= c(x) <= u,  lx <= x <= ux``.

    Pass ``cons_lb``/``cons_ub`` for general constraint bounds, or
    ``num_cons`` for pure equality constraints ``c(x) = 0``.  Bounds are
    numpy arrays; the solver moves them to its device.
    """

    def __init__(self, var_lb, var_ub, **args) -> None:
        var_lb = np.asarray(var_lb, dtype=np.float64)
        var_ub = np.asarray(var_ub, dtype=np.float64)

        assert var_lb.shape == var_ub.shape
        assert var_lb.ndim == 1
        assert (var_lb <= var_ub).all()
        assert (var_lb < np.inf).all()
        assert (var_ub > -np.inf).all()

        self.var_lb = var_lb
        self.var_ub = var_ub

        num_cons = args.get("num_cons", None)
        cons_lb = args.get("cons_lb", None)
        cons_ub = args.get("cons_ub", None)

        if cons_lb is not None or cons_ub is not None:
            assert num_cons is None

            if cons_lb is not None:
                cons_lb = np.asarray(cons_lb, dtype=np.float64)
                (num_cons,) = cons_lb.shape
            else:
                cons_ub = np.asarray(cons_ub, dtype=np.float64)
                (num_cons,) = cons_ub.shape

            if cons_lb is None:
                cons_lb = np.zeros((num_cons,))
            if cons_ub is None:
                cons_ub = np.zeros((num_cons,))

            cons_lb = np.asarray(cons_lb, dtype=np.float64)
            cons_ub = np.asarray(cons_ub, dtype=np.float64)

            assert (cons_lb <= cons_ub).all()
            assert (cons_lb < np.inf).all()
            assert (cons_ub > -np.inf).all()
        else:
            if num_cons is None:
                num_cons = 0
            cons_lb = np.zeros((num_cons,))
            cons_ub = np.zeros((num_cons,))

        self.num_cons = int(num_cons)
        self.cons_lb = cons_lb
        self.cons_ub = cons_ub

    @property
    def num_vars(self) -> int:
        (num_vars,) = self.var_lb.shape
        return num_vars

    @abc.abstractmethod
    def obj(self, x):
        """Objective value ``f(x)`` as a 0-dim tensor."""
        raise NotImplementedError()

    def cons(self, x):
        """Constraint values ``c(x)``; only required when ``num_cons > 0``."""
        raise NotImplementedError()

    def _lag_grad(self, x, y, *args):
        g = grad(self.obj)(x, *args)
        if self.num_cons > 0:
            _, jtv = vjp(lambda x_: self.cons(x_, *args), x)
            g = g + jtv(y)[0]
        return g

    def obj_grad(self, x, *args):
        """Objective gradient; defaults to ``torch.func.grad(self.obj)``."""
        return grad(self.obj)(x, *args)

    def cons_jac(self, x, *args):
        """Dense constraint Jacobian ``(m, n)``; defaults to
        ``torch.func.jacfwd(self.cons)``."""
        return jacfwd(self.cons)(x, *args)

    def lag_hess(self, x, y, *args):
        """Dense Hessian of the Lagrangian ``f(x) + y^T c(x)``: forward mode
        over the reverse-mode Lagrangian gradient."""
        return jacfwd(lambda x_: self._lag_grad(x_, y, *args))(x)

    def lag_hvp(self, x, y, v, *args):
        """Hessian-vector product ``H(x, y) @ v`` without the Hessian."""
        return jvp(lambda x_: self._lag_grad(x_, y, *args), (x,), (v,))[1]

    def cons_vjp(self, x, w, *args):
        """``J(x)^T w`` without the Jacobian (reverse mode)."""
        _, jtv = vjp(lambda x_: self.cons(x_, *args), x)
        return jtv(w)[0]

    def cons_jvp(self, x, v, *args):
        """``J(x) v`` without the Jacobian (forward mode)."""
        return jvp(lambda x_: self.cons(x_, *args), (x,), (v,))[1]


class FuncProblem(Problem):
    """Problem built from plain functions instead of a subclass:
    ``FuncProblem(lb, ub, obj=f, cons=c, cons_lb=..., cons_ub=...)``, with
    ``f`` and ``c`` written with torch operations."""

    def __init__(self, var_lb, var_ub, obj, cons=None, **args):
        self._obj = obj
        self._cons = cons
        super().__init__(var_lb, var_ub, **args)

    def obj(self, x, *args):
        return self._obj(x, *args)

    def cons(self, x, *args):
        if self._cons is None:
            raise NotImplementedError()
        return self._cons(x, *args)


class QuadraticProblem(Problem):
    """Quadratic program ``min 1/2 x^T Q x + c^T x  s.t.  l <= Ax <= u`` with
    variable bounds.

    ``Q``, ``c`` and ``A`` (numpy arrays or tensors) are kept as float64
    tensors, and each evaluation reads them on the device of its point, where
    a copy is made once and kept.  A point of lower precision meets them in
    float64, as JAX promotes it, and the solve casts the values back
    (``eval.make_fns``).  The gradient, Jacobian and Hessian are written
    out, so no autodiff runs for a QP."""

    def __init__(self, Q, c, A=None, cons_lb=None, cons_ub=None, var_lb=None, var_ub=None):
        self.Q = torch.as_tensor(Q, dtype=torch.float64)
        self.c = torch.as_tensor(c, dtype=torch.float64)
        (n,) = self.c.shape
        self.A = None if A is None else torch.as_tensor(A, dtype=torch.float64)
        # _data(x): (Q, c, A) on the device of x
        self._data = PerDevice(
            lambda device: tuple(None if t is None else t.to(device) for t in (self.Q, self.c, self.A))
        ).on

        if var_lb is None:
            var_lb = np.full((n,), -np.inf)
        if var_ub is None:
            var_ub = np.full((n,), np.inf)

        if self.A is None:
            super().__init__(var_lb, var_ub)
        else:
            super().__init__(var_lb, var_ub, cons_lb=cons_lb, cons_ub=cons_ub)

    @staticmethod
    def _promoted(x, data):
        return x.to(torch.promote_types(x.dtype, data.dtype))

    def obj(self, x, *args):
        Q, c, _ = self._data(x)
        x = self._promoted(x, Q)
        return 0.5 * torch.dot(x, Q @ x) + torch.dot(c, x)

    def obj_grad(self, x, *args):
        Q, c, _ = self._data(x)
        return Q @ self._promoted(x, Q) + c

    def cons(self, x, *args):
        A = self._data(x)[2]
        return A @ self._promoted(x, A)

    def cons_jac(self, x, *args):
        return self._data(x)[2]

    def lag_hess(self, x, y, *args):
        return self._data(x)[0]

