"""The hand-written CUDA kernels and the slice on a card (``cuda`` marker).

Without a card these tests skip.  The machine with the card has no JAX, so
this file imports none, and the tests there run without the suite's
conftest::

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from pygradflow_torch import LinearSolverType, Params, Solver
from pygradflow_torch.linalg import ldlt_kernels as lk
from pygradflow_torch.linalg.ldlt import ldlt_num_neg_eigvals
from pygradflow_torch.runners.control import PendulumControl

from .torch_parity import saddle

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("key,shape", [("rl", (386, 258)), ("ll", (770, 514))])
def test_kernel_matches_plain(cuda, key, shape):
    name = {"rl": "ldlt_factor_rl", "ll": "ldlt_factor_ll"}[key]
    n, m = shape
    a32 = torch.tensor(saddle(np.random.default_rng(7), n, m), dtype=torch.float32, device=cuda)
    before = lk.LAUNCHES[key]
    packed = getattr(lk, name)(a32)
    ref = getattr(lk, name + "_ref")(a32)
    assert lk.LAUNCHES[key] == before + 1
    torch.testing.assert_close(torch.tril(packed), torch.tril(ref), rtol=2e-3, atol=2e-3)
    assert int(ldlt_num_neg_eigvals(packed)) == m


def test_pendulum_on_cuda_matches_cpu(cuda):
    params = Params(linear_solver_type=LinearSolverType.PallasLDLT, validate_input=False)
    problem = PendulumControl(N=8)
    x0 = problem.x0_trajectory()
    ref = Solver(problem, params).solve(x0)
    before = lk.LAUNCHES["rl"]
    res = Solver(problem, params, device=cuda).solve(torch.tensor(x0, device=cuda))
    assert lk.LAUNCHES["rl"] - before == res.iterations
    assert (res.status, res.iterations, res.num_accepted_steps) == (
        ref.status, ref.iterations, ref.num_accepted_steps,
    )
    np.testing.assert_allclose(res.x.cpu().numpy(), ref.x.numpy(), rtol=0, atol=1e-6)
