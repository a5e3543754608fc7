"""Example: batched and sharded instance sweeps on the PyTorch port.

Solves a batch of perturbed Rosenbrock instances in lockstep with the
batched solver (one device), then, when more than one card is visible, the
same batch sharded over every card.

    python3 docs/torch/batched_sweep.py            # on the card
    python3 docs/torch/batched_sweep.py cpu 8      # on the CPU, 8 lanes
"""

import sys

import numpy as np
import torch

from pygradflow_torch import Params
from pygradflow_torch.parallel import BatchedSolver, ShardedSolver
from pygradflow_torch.parallel.batch import ParametricProblem


class ParamRosenbrock(ParametricProblem):
    """Rosenbrock with per-instance (a, b) coefficients: the optimum of each
    instance is (a, a^2)."""

    def __init__(self):
        super().__init__(
            np.array([-np.inf, -np.inf]),
            np.array([np.inf, np.inf]),
            example_data=(torch.tensor(1.0, dtype=torch.float64), torch.tensor(100.0, dtype=torch.float64)),
        )

    def p_obj(self, v, data):
        a, b = data
        return (a - v[0]) ** 2 + b * (v[1] - v[0] ** 2) ** 2


def main(device=None, B=64):
    """Solve ``B`` instances on ``device`` (default: the current CUDA card);
    returns the ``BatchResult`` and, when the batch was also sharded over
    several cards, the sharded one (else None)."""
    rng = np.random.default_rng(0)
    x0s = rng.uniform(-1.0, 1.0, size=(B, 2))
    a = torch.as_tensor(rng.uniform(0.5, 2.0, B))
    b = torch.as_tensor(rng.uniform(50.0, 150.0, B))

    problem = ParamRosenbrock()

    res = BatchedSolver(problem, Params(), device=device).solve(x0s, data=(a, b))
    success = res.success.double().mean().item()
    err = (res.x[:, 0].cpu() - a).abs().max().item()
    print(f"batched: {success:.0%} optimal, max |x - (a, a^2)| = {err:.2e}")

    sharded = None
    nd = torch.cuda.device_count()
    if device in (None, "cuda") and nd > 1 and B % nd == 0:
        sharded = ShardedSolver(problem, Params()).solve(x0s, data=(a, b))
        print(f"sharded over {nd} devices: {sharded.success.double().mean().item():.0%} optimal")
    return res, sharded


if __name__ == "__main__":
    main(*sys.argv[1:2], *map(int, sys.argv[2:3]))
