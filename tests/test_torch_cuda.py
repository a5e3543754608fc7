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


@pytest.mark.parametrize(
    "batch,n,m",
    [(2, 120, 80), (2, 386, 258), (2, 615, 410), (128, 194, 130)],
    ids=["n200", "n644", "n1025", "fleet128x324"],
)
def test_trailing_update_over_lower_tiles(cuda, batch, n, m):
    """The trailing update of B1' and B2' computes only the tiles at or
    below each block row's diagonal block (32- or 64-wide, as the grid
    asks): ragged block counts, both tile shapes and a stack of 128.  tril
    stays within the f32 bound of the plain version, and B2' equals B1' on
    every lane bit for bit, since the tile shape does not change what an
    element sums."""
    rng = np.random.default_rng(7)
    a32 = torch.tensor(
        np.stack([saddle(rng, n, m) for _ in range(batch)]), dtype=torch.float32, device=cuda
    )
    stacked = lk.ldlt_factor_rl_batched(a32)
    for i in range(batch):
        single = lk.ldlt_factor_rl(a32[i].contiguous())
        assert torch.equal(stacked[i], single)
    ref = lk.ldlt_factor_rl_batched_ref(a32)
    torch.testing.assert_close(torch.tril(stacked), torch.tril(ref), rtol=2e-3, atol=2e-3)
    assert ldlt_num_neg_eigvals(stacked).tolist() == [m] * batch


@pytest.mark.parametrize("n,m", [(770, 514), (1229, 819)], ids=["n1284", "n2048"])
def test_left_update_split_k_is_deterministic(cuda, n, m):
    """B3' with the split-K left update (K up to 1984): tril within the f32
    bound of the plain version, and two calls give the same bits (the
    partial tiles are summed in chunk order, never in order of arrival)."""
    a32 = torch.tensor(saddle(np.random.default_rng(7), n, m), dtype=torch.float32, device=cuda)
    before = lk.LAUNCHES["ll"]
    packed, again = lk.ldlt_factor_ll(a32), lk.ldlt_factor_ll(a32)
    assert lk.LAUNCHES["ll"] == before + 2
    assert torch.equal(packed, again)
    ref = lk.ldlt_factor_ll_ref(a32)
    torch.testing.assert_close(torch.tril(packed), torch.tril(ref), rtol=2e-3, atol=2e-3)
    assert int(ldlt_num_neg_eigvals(packed)) == m


@pytest.mark.parametrize("k", [639, 640, 1280])
def test_left_update_carries_a_zero_pivot(cuda, k):
    """A zero pivot in a late panel of B3' at n = 1284, where the left
    update splits K over many chunks (at k = 1280, the last panel, 80 of
    them), still poisons the factor from k on and leaves the leading k x k
    factor finite."""
    a = saddle(np.random.default_rng(7), 770, 514)
    a[k, :] = 0.0
    a[:, k] = 0.0
    packed = lk.ldlt_factor_ll(torch.tensor(a, dtype=torch.float32, device=cuda))
    assert torch.isnan(torch.diagonal(packed)[k:]).any()
    assert torch.isfinite(torch.tril(packed[:k, :k])).all()


def test_ldexp_on_cuda_equals_numpy(cuda):
    """``torch.ldexp`` on the card, which the power-of-2 scaling applies,
    against ``np.ldexp`` bit for bit on the seeded pairs of the CPU test
    (|e| up to 1100: overflowing and subnormal results, zeros, infinities);
    and the scaling's own ``ldexp`` with its int64 weights on the card."""
    from pygradflow_torch.scale import _DeviceWeights, ldexp

    from .torch_parity import ldexp_pairs

    x, e = ldexp_pairs()
    with np.errstate(over="ignore"):
        ref = np.ldexp(x, e).view(np.int64)
    ours = torch.ldexp(torch.tensor(x, device=cuda), torch.tensor(e, device=cuda)).cpu().numpy()
    np.testing.assert_array_equal(ours.view(np.int64), ref)
    scaled = ldexp(torch.tensor(x, device=cuda), _DeviceWeights(e)).cpu().numpy()
    np.testing.assert_array_equal(scaled.view(np.int64), ref)


def test_full_newton_pendulum_on_cuda_matches_cpu(cuda):
    """Full Newton at N = 16 on PallasLDLT: one B1' launch per inner Newton
    step on the card, the same status and counts as the CPU run (B1's plain
    version), x to 1e-6."""
    params = Params(
        linear_solver_type=LinearSolverType.PallasLDLT, iteration_limit=3000, validate_input=False, newton_type="Full"
    )
    problem = PendulumControl(N=16)
    x0 = problem.x0_trajectory()
    ref = Solver(problem, params, device="cpu").solve(x0)
    before = dict(lk.LAUNCHES)
    res = Solver(problem, params, device=cuda).solve(torch.tensor(x0, device=cuda))
    launched = {k: lk.LAUNCHES[k] - before[k] for k in before}
    assert launched["rl"] > res.iterations and launched["ll"] == launched["rl_batched"] == 0
    assert (res.status, res.iterations, res.num_accepted_steps) == (ref.status, ref.iterations, ref.num_accepted_steps)
    np.testing.assert_allclose(res.x.cpu().numpy(), ref.x.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("batched", [False, True], ids=["single", "lanes"])
def test_minres_on_cuda_is_independent_of_check_every(cuda, batched):
    """MINRES reads ``done`` on the host every iteration or every 16: the
    same bits on the card, and the same solution as on the CPU to 1e-10."""
    from pygradflow_torch.linalg.minres import minres

    rng = np.random.default_rng(3)
    q = np.linalg.qr(rng.standard_normal((3, 60, 60)))[0]
    eig = rng.uniform(1.0, 10.0, (3, 60)) * np.where(np.arange(60) % 3 == 0, -1.0, 1.0)
    a = np.einsum("bij,bj,bkj->bik", q, eig, q)
    b = rng.standard_normal((3, 60))
    a_d, b_d = torch.tensor(a, device=cuda), torch.tensor(b, device=cuda)
    if not batched:
        a, b, a_d, b_d = a[0], b[0], a_d[0], b_d[0]
    every = minres(a_d, b_d, check_every=1)
    assert torch.equal(every, minres(a_d, b_d, check_every=16))
    cpu = minres(torch.tensor(a), torch.tensor(b))
    np.testing.assert_allclose(every.cpu().numpy(), cpu.numpy(), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("N,key", [(16, None), (128, "rl")])
def test_rcond_on_cuda_equals_cpu(cuda, N, key):
    """``report_rcond`` on the pendulum: the same probes on the card and on
    the CPU, so the same counts and ``final_rcond`` to 1e-8 relative; at
    N = 128 the estimate's solves add no launch of B1'."""
    problem = PendulumControl(N=N)
    x0 = problem.x0_trajectory()
    params = Params(linear_solver_type=LinearSolverType.PallasLDLT, iteration_limit=3000, validate_input=False,
                    report_rcond=True)
    cpu = Solver(problem, params, device="cpu").solve(torch.tensor(x0))
    before = dict(lk.LAUNCHES)
    card = Solver(problem, params, device=cuda).solve(torch.tensor(x0, device=cuda))
    assert (card.status, card.iterations, card.num_accepted_steps) == (cpu.status, cpu.iterations, cpu.num_accepted_steps)
    np.testing.assert_allclose(card.final_rcond, cpu.final_rcond, rtol=1e-8)
    if key is not None:
        assert lk.LAUNCHES[key] - before[key] == card.iterations


@pytest.mark.parametrize("batched", [False, True], ids=["single", "lanes"])
def test_gmres_cuda_graph_equals_eager(cuda, batched, monkeypatch):
    """GMRES replays its restarts as a CUDA graph: the same bits as the same
    restarts launched one kernel at a time, and the CPU's solution to
    1e-10."""
    from pygradflow_torch.linalg import gmres as gmres_module

    rng = np.random.default_rng(4)
    a = rng.standard_normal((3, 80, 80)) + 2.0 * np.sqrt(80) * np.eye(80) * np.array([1.0, 0.3, 0.1])[:, None, None]
    b = rng.standard_normal((3, 80))
    a_d, b_d = torch.tensor(a, device=cuda), torch.tensor(b, device=cuda)
    if not batched:
        a, b, a_d, b_d = a[2], b[2], a_d[2], b_d[2]
    graphed = gmres_module.gmres(a_d, b_d)
    monkeypatch.setattr(gmres_module, "cuda_graphed", lambda fn, example: fn)
    assert torch.equal(graphed, gmres_module.gmres(a_d, b_d))
    cpu = gmres_module.gmres(torch.tensor(a), torch.tensor(b))
    np.testing.assert_allclose(graphed.cpu().numpy(), cpu.numpy(), rtol=1e-10, atol=1e-12)


def _hs71_lanes(B=8):
    """The first B of bench_integration_batch.py's perturbed HS71 starts."""
    rng = np.random.default_rng(7)
    x0s = np.clip(
        np.array([1.0, 5.0, 5.0, 1.0, 0.0]) + rng.uniform(-0.1, 0.1, size=(B, 5)),
        np.array([1.0, 1.0, 1.0, 1.0, 0.0]), np.array([5.0, 5.0, 5.0, 5.0, 2.0]),
    )
    return x0s, np.zeros((B, 2))


def test_flat_chunk_graph_equals_eager_units(cuda):
    """The flat engine's chunk replays a CUDA graph pair of one work unit.
    On 8 HS71 lanes advanced 24 units, steps of up to 3 on six lanes make
    the fast graph's frozen Newton fail, so the full graph is replayed too;
    the next 48 units give the bits of the same units launched one kernel
    at a time, and the CPU's counts."""
    from pygradflow_torch import IntegrationMethod
    from pygradflow_torch.integration import BatchedIntegrationSolver

    from .torch_parity import HS71Explicit

    params = Params(iteration_limit=1000, rho=1e-2, integration_method=IntegrationMethod.SDIRK4,
                    integration_chunk=48)
    x0s, y0s = _hs71_lanes()
    h = torch.tensor([1e-4, 0.3, 1.0, 3.0] * 2, dtype=torch.float64)
    states = {}
    for device in (cuda, "cpu"):
        solver = BatchedIntegrationSolver(HS71Explicit(), params, device=device)
        runner = solver.runner
        x, y = torch.func.vmap(solver.inner.transform.transform_sol)(
            torch.tensor(x0s, device=device), torch.tensor(y0s, device=device)
        )
        start = dict(runner._chunk(runner.init(x, y), 24, 1), h=h.to(device))
        states[str(device)] = runner.chunk({k: v.clone() for k, v in start.items()})
        if device == cuda:
            assert runner._pair.replays["fast"] == 48 and runner._pair.replays["full"] > 0
            eager = runner._chunk({k: v.clone() for k, v in start.items()}, 48, 1)
    graph, cpu = states[str(cuda)], states["cpu"]
    for key, value in graph.items():
        assert torch.equal(value, eager[key]), key
    for key in ("status", "iteration", "steps", "newtons", "units", "mode"):
        assert torch.equal(graph[key].cpu(), cpu[key]), key
    np.testing.assert_allclose(graph["z"].cpu().numpy(), cpu["z"].numpy(), rtol=0, atol=1e-12)


def test_integration_solver_defaults_to_cuda(cuda):
    from pygradflow_torch.integration import IntegrationSolver

    from .torch_parity import HS71Explicit

    params = Params(iteration_limit=2, rho=1e-2)
    solver = IntegrationSolver(HS71Explicit(), params)
    assert solver.device.type == "cuda"
    res = solver.solve(torch.tensor([1.0, 5.0, 5.0, 1.0, 0.0], device=cuda), torch.zeros(2, dtype=torch.float64, device=cuda))
    assert res.x.device.type == "cuda"
    cpu = IntegrationSolver(HS71Explicit(), params, device="cpu").solve(torch.tensor([1.0, 5.0, 5.0, 1.0, 0.0]),
                                                                         torch.zeros(2, dtype=torch.float64))
    assert (res.status, res.iterations, res.num_integration_steps, res.num_newton_steps) == (
        cpu.status, cpu.iterations, cpu.num_integration_steps, cpu.num_newton_steps)
