"""The optimality measure that a solver's ``opt_tol`` bounds, in plain
NumPy, for a stack of answers (one row per solve).

For ``min f(x) s.t. c(x) = 0, lb <= x <= ub`` and an answer (x, y):

- the bound multipliers d follow from projected stationarity: with
  r = -(grad f + J^T y), d = min(r, 0) where x is within ``active_tol`` of
  its lower bound only, max(r, 0) at its upper bound only, r at both, and 0
  elsewhere;
- ``stat`` = |grad f + J^T y + d|_inf, ``cons`` = |c(x)|_inf and ``bound``
  = the largest step outside a bound.

The solver reports Optimal when the largest of the three is at most
``opt_tol`` (pygradflow's ``iterate.py``: ``stat_res``,
``cons_violation``, ``bound_violation``).
"""

import numpy as np


def kkt_residuals(grad, jac_t_y, cons, x, lb, ub, active_tol):
    """``{"stat", "cons", "bound"}``, each (L,) float64, for L answers:
    ``grad``, ``jac_t_y`` and ``x`` are (L, n), ``cons`` (L, m), ``lb`` and
    ``ub`` (n,)."""
    x = np.asarray(x, dtype=np.float64)
    lagrangian = grad + jac_t_y
    r = -lagrangian
    with np.errstate(invalid="ignore"):
        at_lower = np.abs(x - lb) <= active_tol
        at_upper = np.abs(ub - x) <= active_tol
    both = at_lower & at_upper
    d = np.zeros_like(x)
    d = np.where(at_upper & ~both, np.maximum(r, 0.0), d)
    d = np.where(at_lower & ~both, np.minimum(r, 0.0), d)
    d = np.where(both, r, d)
    lanes = x.shape[0]
    with np.errstate(invalid="ignore"):
        outside = np.maximum(np.maximum(lb - x, 0.0), np.maximum(x - ub, 0.0))
    return {
        "stat": _inf_norm(lagrangian + d, lanes),
        "cons": _inf_norm(cons, lanes),
        "bound": _inf_norm(outside, lanes),
    }


def _inf_norm(a, lanes):
    """Row-wise max |a|; a non-finite entry gives inf, an empty row 0."""
    a = np.abs(np.asarray(a, dtype=np.float64).reshape(lanes, -1))
    if a.shape[1] == 0:
        return np.zeros(lanes)
    return np.where(np.isfinite(a).all(axis=1), a.max(axis=1, initial=0.0), np.inf)
