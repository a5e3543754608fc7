"""User-facing problem definition (counterpart of ``pygradflow_tpu/problem.py``).

A subclass defines ``obj(x)`` (and ``cons(x)`` when there are constraints)
as functions of a 1-D float64 tensor written with torch operations.  The
derivatives come from ``torch.func``: ``grad`` for the objective gradient,
``jacfwd`` for the dense constraint Jacobian, ``jacfwd`` of the Lagrangian
gradient for the Hessian, and ``jvp``/``vjp`` for the products.  A
subclass that defines a derivative method itself overrides the default.
"""

import abc

import numpy as np
from torch.func import grad, jacfwd, jvp, vjp


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

    def _lag_grad(self, x, y):
        g = grad(self.obj)(x)
        if self.num_cons > 0:
            _, jtv = vjp(self.cons, x)
            g = g + jtv(y)[0]
        return g

    def obj_grad(self, x):
        """Objective gradient; defaults to ``torch.func.grad(self.obj)``."""
        return grad(self.obj)(x)

    def cons_jac(self, x):
        """Dense constraint Jacobian ``(m, n)``; defaults to
        ``torch.func.jacfwd(self.cons)``."""
        return jacfwd(self.cons)(x)

    def lag_hess(self, x, y):
        """Dense Hessian of the Lagrangian ``f(x) + y^T c(x)``: forward mode
        over the reverse-mode Lagrangian gradient."""
        return jacfwd(lambda x_: self._lag_grad(x_, y))(x)

    def lag_hvp(self, x, y, v):
        """Hessian-vector product ``H(x, y) @ v`` without the Hessian."""
        return jvp(lambda x_: self._lag_grad(x_, y), (x,), (v,))[1]

    def cons_vjp(self, x, w):
        """``J(x)^T w`` without the Jacobian (reverse mode)."""
        _, jtv = vjp(self.cons, x)
        return jtv(w)[0]

    def cons_jvp(self, x, v):
        """``J(x) v`` without the Jacobian (forward mode)."""
        return jvp(self.cons, (x,), (v,))[1]

