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


BITWISE_CASES = [
    ("rl", 1, 386, 258),
    ("rl", 1, 60, 40),
    ("rl_batched", 4, 194, 130),
    ("rl_batched", 4, 60, 40),
    ("ll", 1, 770, 514),
    ("ll", 1, 30, 20),
]


def _kernel_and_plain(key):
    name = {"rl": "ldlt_factor_rl", "ll": "ldlt_factor_ll", "rl_batched": "ldlt_factor_rl_batched"}[key]
    return getattr(lk, name), getattr(lk, name + "_ref")


@pytest.mark.parametrize("key,batch,n,m", BITWISE_CASES)
def test_first_panel_is_bitwise(cuda, key, batch, n, m):
    """The panel factor does the plain version's arithmetic in its order, so
    the first NB columns (which no update touches before the first panel is
    factored) are bit for bit equal, and so is the whole factor at n <= NB."""
    kernel, plain = _kernel_and_plain(key)
    block = lk.LL_BLOCK if key == "ll" else lk.RL_BLOCK
    rng = np.random.default_rng(7)
    a = np.stack([saddle(rng, n, m) for _ in range(batch)])
    a32 = torch.tensor(a if key == "rl_batched" else a[0], dtype=torch.float32, device=cuda)
    packed, ref = kernel(a32), plain(a32)
    assert torch.equal(packed[..., :block], ref[..., :block])


@pytest.mark.parametrize("key", ["rl", "rl_batched", "ll"])
@pytest.mark.parametrize("edge", [-1, 0])
def test_zero_pivot_at_panel_edge_gives_nan(cuda, key, edge):
    """A zero pivot at a panel's last column (k = NB - 1) or the next
    panel's first (k = NB) poisons the factor from k on (lane 1 only, in a
    stack)."""
    kernel, _ = _kernel_and_plain(key)
    k = (lk.LL_BLOCK if key == "ll" else lk.RL_BLOCK) + edge
    rng = np.random.default_rng(7)
    a = np.stack([saddle(rng, 194, 130) for _ in range(3)])
    a[1, k, :] = 0.0
    a[1, :, k] = 0.0
    a32 = torch.tensor(a if key == "rl_batched" else a[1], dtype=torch.float32, device=cuda)
    packed = kernel(a32)
    diag = torch.diagonal(packed, dim1=-2, dim2=-1)
    if key == "rl_batched":
        assert torch.isnan(diag[1, k:]).any()
        assert torch.isfinite(torch.tril(packed[[0, 2]])).all()
    else:
        assert torch.isnan(diag[k:]).any()
        assert torch.isfinite(torch.tril(packed[:k, :k])).all()


@pytest.mark.parametrize("key", ["rl", "ll"])
@pytest.mark.parametrize("pivot", [2.0**127, 2.0**-130], ids=["huge", "subnormal"])
def test_pivot_outside_the_fast_reciprocal_range(cuda, key, pivot):
    """A pivot whose reciprocal the fast path cannot round exactly (a
    subnormal result, an overflow) takes the division: the first panel is
    still bit for bit the plain version's, NaN and infinity included."""
    kernel, plain = _kernel_and_plain(key)
    block = lk.LL_BLOCK if key == "ll" else lk.RL_BLOCK
    rng = np.random.default_rng(7)
    a = saddle(rng, 120, 80)
    a[5, :] = 0.0
    a[:, 5] = 0.0
    a[5, 5] = pivot
    a32 = torch.tensor(a, dtype=torch.float32, device=cuda)
    packed, ref = kernel(a32), plain(a32)
    torch.testing.assert_close(packed[:, :block], ref[:, :block], rtol=0, atol=0, equal_nan=True)


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
    ref = Solver(problem, params, device="cpu").solve(x0)
    before = lk.LAUNCHES["rl"]
    res = Solver(problem, params, device=cuda).solve(torch.tensor(x0, device=cuda))
    assert lk.LAUNCHES["rl"] - before == res.iterations
    assert (res.status, res.iterations, res.num_accepted_steps) == (
        ref.status, ref.iterations, ref.num_accepted_steps,
    )
    np.testing.assert_allclose(res.x.cpu().numpy(), ref.x.numpy(), rtol=0, atol=1e-6)
