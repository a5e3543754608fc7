"""Projected-Newton solver for box-constrained subproblems (counterpart of
``pygradflow_tpu/step/box_solver.py``; Bertsekas, "Projected Newton
Methods for Optimization Problems with Simple Constraints").

Each iteration takes the epsilon-active set from ``isclose(x, lb/ub)`` (a
finite x is never close to an infinite bound), solves the reduced Newton
system with the active rows and columns replaced by identity through the
partial-pivot LU of ``linalg/plu.py``, and runs a projected Armijo search
of at most 20 trials (beta = 1/2, sigma = 1e-3).  Statuses: 0 running,
1 optimal, 2 unbounded (objective at or below ``obj_lower``), 3 iteration
limit, 4 error (no descent direction, or a failed search).

One instance (x of shape (n,)) or a lane stack ((B, n)).  The iterations
end when no lane still runs, read on the host once per iteration; a lane
that has finished keeps its x and its status bit for bit.  The search
reads on the host once per trial for one instance; on a lane stack it
runs all 20 trials, where a lane that has found its step keeps it.
"""

from typing import Any, Callable, NamedTuple

import torch

from ..linalg.plu import plu_factor, plu_solve
from ..util import any_running, dot, lanes

BOX_RUNNING = 0
BOX_OPTIMAL = 1
BOX_UNBOUNDED = 2
BOX_ITERATION_LIMIT = 3
BOX_ERROR = 4  # no descent direction, or the line search failed

LINESEARCH_TRIALS = 20
BETA = 0.5
SIGMA = 1e-3


class BoxSolverResult(NamedTuple):
    x: Any
    status: Any  # int64, one per lane
    iterations: Any


def _iteration(x, func: Callable, grad: Callable, hess: Callable, lb, ub, obj_lower, atol, rtol):
    """One projected-Newton iteration: the status it finds and the point it
    moves to (``x`` itself unless the status is running)."""
    batched = x.ndim > 1
    f = func(x)
    g = grad(x)
    unbounded = f <= obj_lower

    at_lower = torch.isclose(x, lb.expand_as(x))
    at_upper = torch.isclose(x, ub.expand_as(x))
    active = (at_lower & (g > 0)) | (at_upper & (g < 0))
    inactive = ~active

    residuals = -g
    residuals = torch.where(at_lower, torch.clamp(residuals, min=0.0), residuals)
    residuals = torch.where(at_upper, torch.clamp(residuals, max=0.0), residuals)
    residuum = torch.amax(torch.abs(residuals), dim=-1)
    grad_norm = torch.amax(torch.abs(g), dim=-1)
    optimal = (
        (grad_norm < atol)
        | (residuum < atol)
        | (residuum / torch.where(grad_norm == 0.0, 1.0, grad_norm) < rtol)
    )

    # the reduced Newton system, identity rows and columns for the active set
    both_inactive = inactive[..., :, None] & inactive[..., None, :]
    reduced = torch.where(both_inactive, hess(x), 0.0) + torch.diag_embed(active.to(x.dtype))
    direction = plu_solve(plu_factor(reduced), torch.where(inactive, -g, 0.0))
    direction = torch.where(inactive, direction, 0.0)
    bad_dir = (dot(direction, g) >= 0.0) | ~torch.isfinite(direction).all(dim=-1)

    # the projected Armijo search (reference box_solver.py:100-127)
    g_inactive = torch.where(inactive, g, 0.0)
    g_active = torch.where(active, g, 0.0)
    alpha = torch.ones_like(f)
    x_ls = x
    done = torch.isnan(f)
    for _ in range(LINESEARCH_TRIALS):
        if not batched and bool(done):
            break
        next_x = torch.clamp(x + lanes(alpha, 1) * direction, lb, ub)
        next_f = func(next_x)
        decrease = alpha * dot(g_inactive, direction) + dot(g_active, torch.where(active, x - next_x, 0.0))
        ok = ~done & torch.isfinite(next_f) & ((f - next_f) >= SIGMA * decrease)
        alpha = torch.where(~done & ~ok, alpha * BETA, alpha)
        x_ls = torch.where(lanes(ok, 1), next_x, x_ls)
        done = done | ok

    status = torch.where(
        unbounded,
        BOX_UNBOUNDED,
        torch.where(optimal, BOX_OPTIMAL, torch.where(bad_dir | ~done, BOX_ERROR, BOX_RUNNING)),
    )
    return torch.where(lanes(status == BOX_RUNNING, 1), x_ls, x), status


def solve_box_constrained(x0, func, grad, hess, lb, ub, obj_lower: float, max_it: int = 1000,
                          atol: float = 1e-6, rtol: float = 1e-6) -> BoxSolverResult:
    """Minimise ``func`` over the box [lb, ub] from ``x0``; ``func``,
    ``grad`` and ``hess`` take x of the shape of ``x0``."""
    x = torch.clamp(x0, lb, ub)
    status = torch.full(x.shape[:-1], BOX_RUNNING, dtype=torch.int64, device=x.device)
    iterations = torch.zeros_like(status)
    for _ in range(max_it):
        running = status == BOX_RUNNING
        if not any_running(running, "box"):
            break
        x_n, status_n = _iteration(x, func, grad, hess, lb, ub, obj_lower, atol, rtol)
        x = torch.where(lanes(running, 1), x_n, x)
        status = torch.where(running, status_n, status)
        iterations = iterations + running
    status = torch.where(status == BOX_RUNNING, BOX_ITERATION_LIMIT, status)
    return BoxSolverResult(x=x, status=status, iterations=iterations)
