"""Slack transformation (counterpart of ``pygradflow_tpu/cons_problem.py``).

Rewrites a problem so the core algorithm only sees equality constraints
``c(x) = 0`` plus box bounds: one slack variable per non-equality
constraint (its bounds move onto the slack) and equality right-hand sides
shifted to zero.  Slack positions are fixed at construction from the
bound arrays.
"""

import numpy as np
import torch

from .problem import Problem
from .util import PerDevice


class ConstrainedProblem(Problem):
    def __init__(self, problem: Problem):
        self.problem = problem

        cons_lb = problem.cons_lb
        cons_ub = problem.cons_ub
        num_cons = problem.num_cons

        is_eq = cons_lb == cons_ub
        self.slack_positions = np.where(~is_eq)[0]
        num_slacks = len(self.slack_positions)
        self.num_slacks = num_slacks

        # rhs offset for equality constraints with nonzero rhs
        cons_offsets = np.where(is_eq, -cons_lb, 0.0)
        self.cons_offsets = cons_offsets if (cons_offsets != 0.0).any() else None

        var_lb = problem.var_lb
        var_ub = problem.var_ub

        if num_slacks > 0:
            var_lb = np.concatenate([var_lb, cons_lb[self.slack_positions]])
            var_ub = np.concatenate([var_ub, cons_ub[self.slack_positions]])

            # dense (num_cons, num_slacks) block with -1 at (pos_i, i)
            slack_jac = np.zeros((num_cons, num_slacks))
            slack_jac[self.slack_positions, np.arange(num_slacks)] = -1.0
            self._slack_jac = slack_jac

        super().__init__(var_lb, var_ub, num_cons=num_cons)
        # constant data on the device of a point, copied there once (no
        # host copy inside a CUDA graph's capture)
        self._positions = PerDevice(lambda device: torch.as_tensor(self.slack_positions, device=device)).on
        self._offsets = PerDevice(
            lambda device: torch.as_tensor(self.cons_offsets, dtype=torch.float64, device=device)
        ).on
        self._slack = PerDevice(
            lambda device: torch.as_tensor(self._slack_jac, dtype=torch.float64, device=device)
        ).on

    def orig_vals(self, x):
        return x[..., : self.problem.num_vars]

    def slack_vals(self, x):
        return x[..., self.problem.num_vars :]

    def obj(self, x, *args):
        return self.problem.obj(self.orig_vals(x), *args)

    def obj_grad(self, x, *args):
        grad = self.problem.obj_grad(self.orig_vals(x), *args)
        if self.num_slacks == 0:
            return grad
        return torch.cat([grad, grad.new_zeros(self.num_slacks)])

    def cons(self, x, *args):
        c = self.problem.cons(self.orig_vals(x), *args)
        if self.cons_offsets is not None:
            c = c + self._offsets(c).to(c.dtype)
        if self.num_slacks == 0:
            return c
        # the slacks join c in its dtype, as JAX's scatter-add casts them
        return c.index_add(0, self._positions(x), -self.slack_vals(x).to(c.dtype))

    def cons_jac(self, x, *args):
        jac = self.problem.cons_jac(self.orig_vals(x), *args)
        if self.num_slacks == 0:
            return jac
        slack = self._slack(jac).to(jac.dtype)
        return torch.cat([jac, slack], dim=1)

    def lag_hess(self, x, y, *args):
        hess = self.problem.lag_hess(self.orig_vals(x), y, *args)
        if self.num_slacks == 0:
            return hess
        return torch.nn.functional.pad(hess, (0, self.num_slacks, 0, self.num_slacks))

    def transform_sol(self, orig_x, orig_y, *args):
        """Append the initial slack values: the constraint values clipped
        into their bounds."""
        if self.num_slacks == 0:
            return (orig_x, orig_y)
        pos = self._positions(orig_x)
        lb = torch.as_tensor(self.problem.cons_lb, dtype=orig_x.dtype, device=orig_x.device)
        ub = torch.as_tensor(self.problem.cons_ub, dtype=orig_x.dtype, device=orig_x.device)
        slack_vals = torch.clamp(self.problem.cons(orig_x, *args)[pos], lb[pos], ub[pos])
        return (torch.cat([orig_x, slack_vals]), orig_y)

    def restore_sol(self, x, y, d):
        if self.num_slacks == 0:
            return (x, y, d)
        return (self.orig_vals(x), y, self.orig_vals(d))
