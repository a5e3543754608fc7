"""Problem transformation pipeline (counterpart of
``pygradflow_tpu/transform.py``): user problem -> (scaling, not yet ported)
-> ``ConstrainedProblem`` (slacks).  Afterwards the solver sees only
equality constraints ``c(x) = 0`` plus box bounds.
"""

import numpy as np
import torch

from .cons_problem import ConstrainedProblem
from .eval import make_fns
from .params import Params
from .problem import Problem
from .scale import create_scaling


class Transformation:
    def __init__(self, orig_problem: Problem, params: Params):
        self.orig_problem = orig_problem
        self.params = params

        self.scaling = create_scaling(
            orig_problem, params, params.scaling_primal, params.scaling_dual
        )
        self.scaled_problem = orig_problem
        self.trans_problem = ConstrainedProblem(self.scaled_problem)
        self.fns = make_fns(self.trans_problem, params)

    def create_transformed_initial(self, x0, y0, device):
        """Initial point on ``device``: x0 defaults to 0 clipped into the
        bounds, y0 to 0; then the slacks are appended."""
        orig_problem = self.orig_problem
        dtype = self.params.dtype

        def vector(v, size, default):
            if v is None:
                return torch.as_tensor(default, dtype=torch.float64, device=device)
            if torch.is_tensor(v) and v.device != torch.device(device):
                raise ValueError(
                    f"initial point on {v.device}, but the solver runs on {device}"
                )
            v = torch.as_tensor(v, dtype=torch.float64, device=device)
            return torch.broadcast_to(v, (size,)).clone()

        n, m = orig_problem.num_vars, orig_problem.num_cons
        x = vector(x0, n, np.clip(np.zeros((n,)), orig_problem.var_lb, orig_problem.var_ub))
        y = vector(y0, m, np.zeros((m,)))
        x, y = self.trans_problem.transform_sol(x, y)
        return x.to(dtype), y.to(dtype)

    def restore_sol(self, x, y, d):
        return self.trans_problem.restore_sol(x, y, d)
