"""Example: block-structured optimal control with the Schur step solver, on
the PyTorch port.

Solves the discretized pendulum swing-up NLP.  The interleaved formulation
orders the variables per stage ``(theta_k, omega_k, u_k)``, so the
Lagrangian Hessian is 3x3-block-diagonal, which the Schur step solver
exploits: the primal block is factored as a batch of small LDL^T factors
and only the dual Schur complement needs a full factorization.  With
``matrix_free=True`` the Jacobian and Hessian are never formed: the stage
blocks are probed out by batched products, and the block-tridiagonal dual
goes to the mixed-precision tier (an f32 factor on the card with f64
refinement) where a factor is dense.

    python3 docs/torch/optimal_control.py          # on the card
    python3 docs/torch/optimal_control.py cpu 16   # on the CPU, N = 16
"""

import sys

import numpy as np

from pygradflow_torch import LinearSolverType, Params, Solver, StepSolverType
from pygradflow_torch.runners.control import PendulumControlInterleaved


def main(device=None, N=64):
    """Solve the swing-up with horizon ``N`` on ``device`` (default: the
    current CUDA card) and return the ``SolverResult``."""
    problem = PendulumControlInterleaved(N=N)

    params = Params(
        step_solver_type=StepSolverType.Schur,
        schur_block_size=3,  # (theta, omega, u) per stage
        # stage-local constraints (dual block r touches stages r-1, r):
        # with matrix_free=True the dense Jacobian and Hessian are never
        # formed, and the cost per iteration is O(N) (step/schur_staged.py)
        schur_dual_block_size=2,
        matrix_free=True,
        linear_solver_type=LinearSolverType.PallasLDLT,
        validate_input=False,
    )

    solver = Solver(problem, params, device=device)
    result = solver.solve(problem.x0_trajectory())

    print("status:", result.status.name)
    print("iterations:", result.iterations)
    print("objective:", result.final_scaled_obj)

    # final state of the swing-up: theta should be near pi (upright)
    x = result.x.cpu().numpy()
    theta_final = x[3 * (problem.N - 1)]
    print("final angle:", theta_final, "(target pi = %.6f)" % np.pi)
    return result


if __name__ == "__main__":
    main(*sys.argv[1:2], *map(int, sys.argv[2:3]))
