"""Example: a constrained solve with the live display, a checkpoint and
the continuous-flow engine, on the PyTorch port.

HS71 (Hock-Schittkowski 71): nonlinear objective, one inequality and one
equality constraint, variable bounds.  The checkpoint goes into a temporary
directory, removed when the solve ends.

    python3 docs/torch/solve_constrained.py          # on the card
    python3 docs/torch/solve_constrained.py cpu      # on the CPU
"""

import logging
import os
import sys
import tempfile

import numpy as np
import torch

from pygradflow_torch import Params, Problem, Solver
from pygradflow_torch.integration import IntegrationSolver

logging.basicConfig(level=logging.INFO, format="%(message)s")


class HS71(Problem):
    def __init__(self):
        super().__init__(
            var_lb=np.ones(4),
            var_ub=np.full(4, 5.0),
            cons_lb=np.array([25.0, 40.0]),
            cons_ub=np.array([np.inf, 40.0]),
        )

    def obj(self, x):
        return x[0] * x[3] * (x[0] + x[1] + x[2]) + x[2]

    def cons(self, x):
        return torch.stack([torch.prod(x), torch.dot(x, x)])


def main(device=None):
    """Solve on ``device`` (default: the current CUDA card); returns the
    discrete and the continuous ``SolverResult``."""
    problem = HS71()
    x0 = np.array([1.0, 5.0, 5.0, 1.0])

    # discrete implicit-Euler homotopy with live display, snapshotted at
    # every jit_chunk boundary
    params = Params(display=True)
    with tempfile.TemporaryDirectory() as tmp:
        result = Solver(problem, params, device=device).solve(x0, checkpoint_path=os.path.join(tmp, "hs71.npz"))
    print(f"\nSolver:            {result.status.name}  x = {result.x.cpu().numpy()}")

    # continuous flow with event detection
    flow = IntegrationSolver(problem, Params(rho=1e-2), device=device).solve(x0)
    print(f"IntegrationSolver: {flow.status.name}  x = {flow.x.cpu().numpy()}")
    return result, flow


if __name__ == "__main__":
    main(*sys.argv[1:2])
