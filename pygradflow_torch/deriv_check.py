"""Derivative checks (counterpart of ``pygradflow_tpu/deriv_check.py``,
reference ``pygradflow/deriv_check.py``).

Derivatives default to autodiff, so the check serves mainly derivative
methods a user overrides: column-wise forward differences against the
derivative given, reporting the indices where they disagree.  It runs
eagerly on the host in float64 numpy, as in the JAX package; the problem's
functions are called on float64 tensors on the device of the point given,
and its derivatives at the point as the solve holds it.
"""

from typing import Any

import numpy as np
import torch

from .params import DerivCheck, Params


class DerivError(Exception):
    def __init__(self, deriv, findiff, atol, invalid_indices):
        self.deriv = deriv
        self.findiff = findiff
        self.atol = atol
        self.invalid_indices = invalid_indices
        super().__init__("Derivative check failed at indices {0}".format(invalid_indices))

    @property
    def invalid_deriv(self) -> Any:
        return self.deriv[tuple(self.invalid_indices.T)]

    @property
    def invalid_findiff(self) -> Any:
        return self.findiff[tuple(self.invalid_indices.T)]


def _host(v):
    if torch.is_tensor(v):
        v = v.detach().cpu().numpy()
    return np.asarray(v, dtype=np.float64)


def deriv_check(f, x, deriv, params: Params, device="cpu") -> None:
    """Forward differences of ``f`` at ``x``, column by column, against the
    derivative ``deriv`` (reference ``deriv_check.py:49-100``); raises
    :class:`DerivError` naming the entries off by more than
    ``params.deriv_tol``."""
    x = _host(x)
    deriv = np.atleast_2d(_host(deriv))
    eps = params.deriv_pert
    tol = params.deriv_tol

    def value(v):
        return np.atleast_1d(_host(f(torch.as_tensor(v, device=device))))

    (n,) = x.shape
    f0 = value(x)
    findiff = np.zeros_like(deriv)
    for j in range(n):
        xp = np.copy(x)
        xp[j] += eps
        findiff[:, j] = (value(xp) - f0) / eps

    invalid = ~np.isclose(deriv, findiff, atol=tol, rtol=0.0)
    if invalid.any():
        raise DerivError(deriv, findiff, tol, np.argwhere(invalid))


def deriv_check_problem(problem, params: Params, x, y) -> None:
    """Check the (transformed) problem's derivatives at ``(x, y)``
    (reference ``solver.py:103-131``): the first derivatives under
    ``DerivCheck.CheckFirst``, the Lagrangian's Hessian under
    ``CheckSecond``."""
    check = params.deriv_check
    if check == DerivCheck.NoCheck:
        return

    from .log import logger

    # the derivatives at the point as the solve holds it (its dtype), the
    # differences in float64
    x, y = torch.as_tensor(x), torch.as_tensor(y)
    device = x.device

    if check & DerivCheck.CheckFirst:
        logger.info("Checking objective derivative")
        deriv_check(problem.obj, x, problem.obj_grad(x), params, device)

        if problem.num_cons > 0:
            logger.info("Checking constraint derivative")
            deriv_check(problem.cons, x, problem.cons_jac(x), params, device)

    if check & DerivCheck.CheckSecond:
        logger.info("Checking Hessian")

        def lag_grad(x_):
            g = problem.obj_grad(x_)
            if problem.num_cons > 0:
                g = g + problem.cons_jac(x_).T @ y.to(x_.dtype)
            return g

        deriv_check(lag_grad, x, problem.lag_hess(x, y), params, device)

    logger.info("Finished derivative check")
