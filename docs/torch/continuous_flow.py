"""Example: the continuous-flow (ODE and event) engine of the PyTorch port.

Solves HS71 three ways and prints the segment and step accounting:

1. the host event loop (adaptive TR-BDF2),
2. the device loop (the whole event-driven solve, segments, bisection
   and penalty switches, driven from the device with few host reads;
   SDIRK4 here),
3. a lockstep batch of perturbed starts on one device (use
   ``ShardedIntegrationSolver`` for several cards).

Expected: Optimal, 10 segments with rho rising from 1e-2 to 1e6 under
TR-BDF2, as in the JAX package's ``docs/continuous_flow.py``.

HS71's derivatives are written out here: the event decisions of the flow
amplify last-bit differences, and elementwise formulas evaluate in one
order on the CPU, on the card and in every lane of a batch, where
autodiff's reductions need not.

    python3 docs/torch/continuous_flow.py           # on the card
    python3 docs/torch/continuous_flow.py cpu 2     # on the CPU, 2 lanes
"""

import sys

import numpy as np
import torch

from pygradflow_torch import IntegrationMethod, Params, Problem
from pygradflow_torch.integration import BatchedIntegrationSolver, IntegrationSolver


class HS71(Problem):
    """HS71 with the product constraint through an explicit slack
    (``prod(x) - s = 25``, ``s >= 0``) and the sum of squares equal to 40."""

    def __init__(self):
        super().__init__(
            np.array([1.0, 1.0, 1.0, 1.0, 0.0]),
            np.array([5.0, 5.0, 5.0, 5.0, np.inf]),
            num_cons=2,
        )

    def obj(self, x):
        return x[0] * x[3] * (x[0] + x[1] + x[2]) + x[2]

    def obj_grad(self, x):
        s = x[0] + x[1] + x[2]
        x0x3 = x[0] * x[3]
        return torch.stack([x[3] * s + x0x3, x0x3, x0x3 + 1.0, x[0] * s, torch.zeros_like(s)])

    def cons(self, x):
        return torch.stack(
            [x[0] * x[1] * x[2] * x[3] - x[4] - 25.0, x[0] * x[0] + x[1] * x[1] + x[2] * x[2] + x[3] * x[3] - 40.0]
        )

    def cons_jac(self, x):
        a, b, c, d = x[0], x[1], x[2], x[3]
        zero = torch.zeros_like(a)
        return torch.stack(
            [
                torch.stack([b * c * d, a * c * d, a * b * d, a * b * c, zero - 1.0]),
                torch.stack([2.0 * a, 2.0 * b, 2.0 * c, 2.0 * d, zero]),
            ]
        )

    def lag_hess(self, x, y):
        a, b, c, d = x[0], x[1], x[2], x[3]
        y0, y1 = y[0], y[1]
        zero = torch.zeros_like(a)
        diag = 2.0 * y1
        h01 = d + y0 * (c * d)
        h02 = d + y0 * (b * d)
        h03 = (2.0 * a + b + c) + y0 * (b * c)
        h12 = y0 * (a * d)
        h13 = a + y0 * (a * c)
        h23 = a + y0 * (a * b)
        return torch.stack(
            [
                torch.stack([2.0 * d + diag, h01, h02, h03, zero]),
                torch.stack([h01, diag, h12, h13, zero]),
                torch.stack([h02, h12, diag, h23, zero]),
                torch.stack([h03, h13, h23, diag, zero]),
                torch.stack([zero, zero, zero, zero, zero]),
            ]
        )


def main(device=None, B=8):
    """Solve on ``device`` (default: the current CUDA card), with a batch of
    ``B`` perturbed starts; returns the host-loop and device-loop results
    and the batch's ``BatchedIntegrationResult``."""
    x0 = np.array([1.0, 5.0, 5.0, 1.0, 0.0])
    y0 = np.zeros(2)
    problem = HS71()

    results = {}
    for label, params in [
        ("host loop / TR-BDF2", Params(rho=1e-2, iteration_limit=1000)),
        (
            "device loop / SDIRK4",
            Params(
                rho=1e-2,
                iteration_limit=1000,
                integration_method=IntegrationMethod.SDIRK4,
                integration_device_loop=True,
            ),
        ),
    ]:
        result = IntegrationSolver(problem, params, device=device).solve(x0, y0)
        results[label] = result
        print(
            f"{label:22s} {result.status.name}: "
            f"{result.iterations} segments, "
            f"{result.num_integration_steps} steps, x = {result.x.cpu().numpy()}"
        )

    # lockstep batch of perturbed starts (SDIRK4)
    rng = np.random.default_rng(0)
    x0s = np.clip(
        x0[None, :] + rng.uniform(-0.1, 0.1, size=(B, 5)),
        np.array([1.0, 1.0, 1.0, 1.0, 0.0]),
        np.array([5.0, 5.0, 5.0, 5.0, 2.0]),
    )
    batch = BatchedIntegrationSolver(
        problem,
        Params(rho=1e-2, iteration_limit=1000, integration_method=IntegrationMethod.SDIRK4),
        device=device,
    ).solve(x0s, np.tile(y0, (B, 1)))
    segments = sorted(set(batch.iterations.tolist()))
    print(f"batched B={B:<15d} {int(batch.success.sum())}/{B} optimal, segments {segments}")
    return results["host loop / TR-BDF2"], results["device loop / SDIRK4"], batch


if __name__ == "__main__":
    main(*sys.argv[1:2], *map(int, sys.argv[2:3]))
