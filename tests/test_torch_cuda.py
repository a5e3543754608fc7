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


def test_batched_kernel_equals_single_kernel(cuda):
    """B2' on each instance of a stack equals B1' on it bit for bit, and the
    plain version within the card's f32 bound."""
    rng = np.random.default_rng(7)
    a32 = torch.tensor(
        np.stack([saddle(rng, 194, 130) for _ in range(5)]), dtype=torch.float32, device=cuda
    )
    before = lk.LAUNCHES["rl_batched"]
    packed = lk.ldlt_factor_rl_batched(a32)
    assert lk.LAUNCHES["rl_batched"] == before + 1
    for i in range(a32.shape[0]):
        assert torch.equal(packed[i], lk.ldlt_factor_rl(a32[i].contiguous()))
    ref = lk.ldlt_factor_rl_batched_ref(a32)
    torch.testing.assert_close(torch.tril(packed), torch.tril(ref), rtol=2e-3, atol=2e-3)
    assert ldlt_num_neg_eigvals(packed).tolist() == [130] * 5


def test_two_level_factor_matches_plain(cuda):
    """The two-level factor at n = 2050 (the dual Schur complement at
    N = 1024): two 1025-wide diagonal blocks through B1', one launch each,
    against the same factor on the CPU, where the blocks take B1's plain
    version."""
    from pygradflow_torch.linalg.two_level_ldlt import ldlt_factor_two_level

    a = saddle(np.random.default_rng(7), 1250, 800)
    a32 = torch.tensor(a, dtype=torch.float32)
    before = lk.LAUNCHES["rl"]
    packed = ldlt_factor_two_level(a32.to(cuda))
    assert lk.LAUNCHES["rl"] == before + 2
    ref = ldlt_factor_two_level(a32)
    torch.testing.assert_close(torch.tril(packed).cpu(), torch.tril(ref), rtol=2e-3, atol=2e-3)
    assert int(ldlt_num_neg_eigvals(packed)) == 800
    b = torch.tensor(np.random.default_rng(8).standard_normal(2050), device=cuda)
    a64 = torch.tensor(a, device=cuda)
    x = lk.refine_solve(packed, a64, b)
    assert (a64 @ x - b).abs().max().item() <= 1e-8


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
