"""Example: solve the 2D Rosenbrock problem with the PyTorch port and print
the solve report.

    python3 docs/torch/solve_rosenbrock.py          # on the card
    python3 docs/torch/solve_rosenbrock.py cpu      # on the CPU

Expected: Optimal in 30 iterations (25 accepted), x ~ (1, 1), the counts of
the JAX package's ``docs/solve_rosenbrock.py``.
"""

import logging
import sys

import numpy as np

from pygradflow_torch import Params, Problem, Solver

logging.basicConfig(level=logging.INFO, format="%(message)s")


class Rosenbrock(Problem):
    def __init__(self):
        super().__init__(np.full(2, -np.inf), np.full(2, np.inf))

    def obj(self, v):
        return (1.0 - v[0]) ** 2 + 100.0 * (v[1] - v[0] ** 2) ** 2


def main(device=None):
    """Solve on ``device`` (default: the current CUDA card) and return the
    ``SolverResult``."""
    problem = Rosenbrock()
    params = Params()

    solver = Solver(problem, params, device=device)
    result = solver.solve(np.array([0.0, 0.0]))

    print()
    print(f"Status:     {result.status.name}")
    print(f"Iterations: {result.iterations} ({result.num_accepted_steps} accepted)")
    print(f"Solution:   {result.x.cpu().numpy()}")
    return result


if __name__ == "__main__":
    main(*sys.argv[1:2])
