"""Event functions of the restricted flow, vectorized (counterpart of
``pygradflow_tpu/integration/events.py``).

All events are one fixed-size vector function evaluated at every accepted
integrator step; crossings are detected by directional sign changes
between steps.

Layout (size 3n + 3):
    [0:n)    lower-bound crossings   x_j - lb_j      (free j, finite lb; dir -1)
    [n:2n)   upper-bound crossings   x_j - ub_j      (free j, finite ub; dir +1)
    [2n:3n)  pinned-gradient flips   (-grad L)_j     (pinned j; dir +1 at lb,
                                                      -1 at ub)
    [3n]     convergence             residuum - opt_tol        (any dir)
    [3n+1]   unboundedness           obj - obj_lower_limit     (any dir)
    [3n+2]   penalty criterion       <rhs, grad L>             (dir +1)

Inactive slots hold the constant 1.0 so they never cross.  Every function
serves one point and a lane stack (a leading lane axis) alike.
"""

from typing import Any, NamedTuple

import torch

from ..util import lanes, rowdot
from . import flow as fl

EV_CONVERGED = "converged"

class EventCfg(NamedTuple):
    ctx: Any  # FlowCtx
    opt_tol: float
    obj_lower_limit: float
    active_tol: float = 1e-8
    """Deadband for pinned-gradient release events: a pinned variable is
    released only once its inward gradient exceeds this tolerance, which
    keeps near-degenerate bounds from pin/release chatter."""


def num_events(n: int) -> int:
    return 3 * n + 3


def event_values(cfg: EventCfg, z, rho, filter, grad_dirs):
    """Evaluate the event vector.  ``grad_dirs`` (n,) holds the direction
    (+1/-1/0) of each pinned-gradient event, computed at segment start."""
    ctx = cfg.ctx
    fo = fl.first_order(ctx, z)
    x = fo.x

    finite_lb = torch.isfinite(ctx.lb)
    finite_ub = torch.isfinite(ctx.ub)

    lb_vals = torch.where(filter & finite_lb, x - torch.where(finite_lb, ctx.lb, 0.0), 1.0)
    ub_vals = torch.where(filter & finite_ub, x - torch.where(finite_ub, ctx.ub, 0.0), 1.0)

    aug_dx = fl._deriv_x(fo, rho)
    neg_grad = -aug_dx
    # deadband in the release direction (see EventCfg); grows with rho
    # because gradient noise at a pinned variable scales like
    # rho * (integration error of c)
    deadband = cfg.active_tol * (1.0 + rho)
    grad_vals = torch.where(grad_dirs != 0.0, neg_grad - lanes(deadband, 1) * grad_dirs, 1.0)

    conv = fl.norm(fl._rhs(fo, 0.0, filter)) - cfg.opt_tol
    unb = ctx.fns.obj(x) - cfg.obj_lower_limit

    r = fl._rhs(fo, rho, filter)
    n = ctx.n
    penalty = rowdot(r[..., :n], aug_dx) + rowdot(r[..., n:], fo.c)

    return torch.cat([lb_vals, ub_vals, grad_vals, torch.stack([conv, unb, penalty], dim=-1)], dim=-1)


def event_directions(cfg: EventCfg, filter, grad_dirs):
    """Per-event crossing direction (+1, -1, or 0 = any)."""
    n = cfg.ctx.n
    lead = grad_dirs.shape[:-1]
    lb_dirs = grad_dirs.new_full(lead + (n,), -1.0)
    ub_dirs = grad_dirs.new_full(lead + (n,), 1.0)
    # (0, 0, 1), made on the device without a host copy
    tail = (torch.arange(3, device=grad_dirs.device) == 2).to(grad_dirs.dtype).expand(lead + (3,))
    return torch.cat([lb_dirs, ub_dirs, grad_dirs, tail], dim=-1)


def crossings(prev_vals, cur_vals, directions):
    """Directional sign-change detection between two accepted steps."""
    down = (prev_vals > 0.0) & (cur_vals <= 0.0)
    up = (prev_vals < 0.0) & (cur_vals >= 0.0)
    any_cross = down | up
    return torch.where(directions < 0.0, down, torch.where(directions > 0.0, up, any_cross))


def grad_event_dirs(ctx, z, filter, lb, ub):
    """Directions of the pinned-gradient events: a variable pinned at its
    lower bound is released when its negative gradient turns positive
    (dir +1), at the upper bound when it turns negative (dir -1); equal
    bounds never release (reference ``problem_switches.py:150-162``)."""
    x, _ = fl.split(ctx, z)
    at_lb = fl.isclose(x, lb)
    at_ub = fl.isclose(x, ub)
    both = at_lb & at_ub
    pinned = ~filter

    one = torch.ones_like(x)
    dirs = torch.where(at_lb, one, torch.where(at_ub, -one, 0.0))
    return torch.where(pinned & ~both, dirs, 0.0)
