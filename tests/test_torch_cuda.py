"""The hand-written CUDA kernels and the slice on a card (``cuda`` marker).

Without a card these tests skip.  The machine with the card has no JAX, so
this file imports none, and the tests there run without the suite's
conftest::

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from pygradflow_torch import LinearSolverType, Params, Solver, graphs, util
from pygradflow_torch.linalg import ldlt_kernels as lk
from pygradflow_torch.linalg.ldlt import ldlt_num_neg_eigvals
from pygradflow_torch.runners.control import PendulumControl

from .test_cutest import fake_pycutest  # noqa: F401 (fixture)
from .torch_parity import saddle

pytestmark = pytest.mark.cuda


def replays(first_terminal, jit_chunk):
    """The bodies a graphed solve replays when its ``first_terminal``-th
    body (from 1) is the first to leave a terminal state: every body of the
    chunks before that body's chunk, and in its chunk up to
    ``graphs.LOOKAHEAD - 1`` bodies past it (``graphs.replay_until_done``)."""
    full = (first_terminal - 1) // jit_chunk
    return full * jit_chunk + min(jit_chunk, first_terminal - full * jit_chunk + graphs.LOOKAHEAD - 1)


def graphed_launches(iterations, jit_chunk=Params().jit_chunk):
    """A kernel's launches in a graphed single solve that launches it once
    per iteration: one per body replayed (the body after the last iteration
    finds the status terminal; the bodies replayed after it have their
    results masked) and one in the capture's warm-up."""
    return replays(iterations + 1, jit_chunk) + 1


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
    assert lk.LAUNCHES["rl"] - before == graphed_launches(res.iterations)
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
    if key is not None:  # the graphed loop's, as in test_pendulum_on_cuda_matches_cpu
        assert lk.LAUNCHES[key] - before[key] == graphed_launches(card.iterations)


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


SINGLE = dict(precision="Single", opt_tol=1e-4, lamb_min=1e-6)


@pytest.mark.parametrize("case", ["hs71", "pendulum"])
def test_single_solver_on_cuda_matches_cpu(cuda, case):
    """An f32 solve on the card (HS71 on the LU tier; the pendulum at N=16
    through B1' on f32 matrices with f32 refinement) takes the CPU run's
    steps and stays f32; x within 1e-2, the tolerance of the pendulum's f32
    solves against the JAX package's (``test_torch_precision.py``)."""
    from .torch_parity import HS71

    if case == "hs71":
        problem, params, x0 = HS71(), Params(**SINGLE), np.array([1.0, 5.0, 5.0, 1.0, 0.0])
    else:
        problem = PendulumControl(N=16)
        params = Params(linear_solver_type=LinearSolverType.PallasLDLT, iteration_limit=3000,
                        validate_input=False, **SINGLE)
        x0 = problem.x0_trajectory()
    before = lk.LAUNCHES["rl"]
    ours = Solver(problem, params).solve(torch.tensor(x0, device=cuda))
    cpu = Solver(problem, params, device="cpu").solve(torch.tensor(x0))
    assert ours.x.dtype == torch.float32 and ours.x.device.type == "cuda"
    assert (ours.status, ours.iterations, ours.num_accepted_steps) == (cpu.status, cpu.iterations, cpu.num_accepted_steps)
    np.testing.assert_allclose(ours.x.cpu().numpy(), cpu.x.numpy(), rtol=0, atol=1e-2)
    assert (lk.LAUNCHES["rl"] > before) == (case == "pendulum")


def test_checkpoint_resume_on_cuda_is_bitwise(cuda, tmp_path):
    """On the card an interrupted solve resumed from its snapshot equals the
    uninterrupted one bit for bit; a snapshot written on the CPU restores
    on the card to the CPU state's bits, and the card goes on from it to
    the CPU run's counts."""
    from pygradflow_torch.checkpoint import load_state

    from .torch_parity import Rosenbrock

    x0 = np.array([-1.2, 1.0])
    full = Solver(Rosenbrock(), Params()).solve(torch.tensor(x0, device=cuda))
    path = str(tmp_path / "card.npz")
    Solver(Rosenbrock(), Params(jit_chunk=4, iteration_limit=12)).solve(torch.tensor(x0, device=cuda), checkpoint_path=path)
    resumed = Solver(Rosenbrock(), Params(jit_chunk=4)).solve(torch.tensor(x0, device=cuda), checkpoint_path=path,
                                                                resume=True)
    assert (resumed.iterations, resumed.num_accepted_steps) == (full.iterations, full.num_accepted_steps)
    assert torch.equal(resumed.x, full.x) and torch.equal(resumed.y, full.y)

    cpu_path = str(tmp_path / "cpu.npz")
    cpu_full = Solver(Rosenbrock(), Params(), device="cpu").solve(torch.tensor(x0))
    Solver(Rosenbrock(), Params(jit_chunk=4, iteration_limit=12), device="cpu").solve(torch.tensor(x0),
                                                                                     checkpoint_path=cpu_path)
    solver = Solver(Rosenbrock(), Params(jit_chunk=4))
    x, y = solver.transform.create_transformed_initial(x0, None, solver.device)
    state = load_state(cpu_path, solver._loop.init_state(x, y))
    with np.load(cpu_path) as data:
        assert torch.equal(state.it.x.cpu(), torch.tensor(data["leaf.it.x"]))
        assert state.lamb == float(data["leaf.lamb"]) and state.iteration == 12
    on_card = solver.solve(torch.tensor(x0, device=cuda), checkpoint_path=cpu_path, resume=True)
    assert on_card.x.device.type == "cuda"
    assert (on_card.iterations, on_card.num_accepted_steps) == (cpu_full.iterations, cpu_full.num_accepted_steps)
    np.testing.assert_allclose(on_card.x.cpu().numpy(), cpu_full.x.numpy(), rtol=0, atol=1e-8)


def _eager(solver):
    """``solver`` with every chunk through its loop's eager route."""
    loop = solver._loop if hasattr(solver, "_loop") else solver.loop
    loop.use_graphs = False
    return solver


@pytest.mark.parametrize("case", ["rosenbrock", "hs71", "pendulum"])
@pytest.mark.parametrize("batched", [False, True], ids=["single", "lanes"])
def test_graphed_loop_equals_eager_loop(cuda, case, batched):
    """The solve loop replayed as a CUDA graph gives the eager loop's bits,
    reads the host once per chunk, and captures nothing on a second solve."""
    from pygradflow_torch.parallel import BatchedSolver
    from pygradflow_torch.util import HOST_READS

    from .torch_parity import HS71, Rosenbrock

    if case == "pendulum":
        problem = PendulumControl(N=16)
        x0, y0 = problem.x0_trajectory(), None
        params = Params(linear_solver_type=LinearSolverType.PallasLDLT, validate_input=False, jit_chunk=8)
    else:
        problem = Rosenbrock() if case == "rosenbrock" else HS71()
        x0 = np.array([0.0, 0.0]) if case == "rosenbrock" else np.array([1.0, 5.0, 5.0, 1.0, 0.0])
        y0 = None if case == "rosenbrock" else np.zeros(2)
        params = Params(jit_chunk=8)
    if batched:
        x0 = x0 + 1e-3 * np.random.default_rng(3).standard_normal((3, x0.shape[0]))
        y0 = None if y0 is None else np.tile(y0, (3, 1))

    def make():
        return (BatchedSolver if batched else Solver)(problem, params, device=cuda)

    graphed, eager = make(), _eager(make())
    HOST_READS.clear()
    res = graphed.solve(x0, y0)
    # a single solve reads its start's input check once, under validate_input
    starts = {} if batched or not params.validate_input else {"start": 1}
    assert dict(HOST_READS, chunk=0) == dict(starts, chunk=0)
    iters = int(res.iterations.max()) if batched else res.iterations
    assert HOST_READS["chunk"] <= -(-(iters + 1) // 8) + 1
    loop = graphed.loop if batched else graphed._loop
    assert loop.graph.captures == 1
    again = graphed.solve(x0, y0)
    assert loop.graph.captures == 1
    ref = eager.solve(x0, y0)
    fields = ("x", "y", "d", "status", "iterations", "accepted_steps") if batched else ("x", "y", "d")
    for r in (res, again):
        for field in fields:
            assert torch.equal(getattr(r, field), getattr(ref, field)), field
        if not batched:
            assert (r.status, r.iterations, r.num_accepted_steps) == (ref.status, ref.iterations, ref.num_accepted_steps)


@pytest.mark.parametrize("jit_chunk", [1, 7, 64])
@pytest.mark.parametrize("case", ["rosenbrock", "hs71"])
@pytest.mark.parametrize("batched", [False, True], ids=["single", "lanes"])
def test_replays_stop_after_the_terminal_body(cuda, case, batched, jit_chunk, monkeypatch):
    """A graphed chunk stops its replays ``graphs.LOOKAHEAD - 1`` bodies after
    the first terminal one (``ChunkGraph.replayed``, summed over the chunks,
    counts them by that rule) and gives, bit for bit, the eager loop's
    answer and that of the same solve with every chunk replayed whole."""
    from pygradflow_torch.parallel import BatchedSolver

    from .torch_parity import HS71, Rosenbrock

    problem = Rosenbrock() if case == "rosenbrock" else HS71()
    x0 = np.array([0.0, 0.0]) if case == "rosenbrock" else np.array([1.0, 5.0, 5.0, 1.0, 0.0])
    y0 = None if case == "rosenbrock" else np.zeros(2)
    if batched:
        x0 = x0 + 1e-3 * np.random.default_rng(5).standard_normal((3, x0.shape[0]))
        y0 = None if y0 is None else np.tile(y0, (3, 1))
    params = Params(jit_chunk=jit_chunk)

    def solve(solver):
        graph = (solver.loop if batched else solver._loop).graph
        run, counted = graph.run, {"bodies": 0, "stopped": 0}

        def counting(state, k):  # each chunk's replays
            out = run(state, k)
            counted["bodies"] += graph.replayed
            counted["stopped"] += int(graph.replayed < k)
            return out

        graph.run = counting
        return solver.solve(x0, y0), counted

    def make():
        return (BatchedSolver if batched else Solver)(problem, params, device=cuda)

    res, counted = solve(make())
    # a lane's body runs the iteration, then the terminal tests; the single
    # body tests first, so it finds the status terminal one body later
    iters = int(res.iterations.max()) if batched else res.iterations
    first_terminal = iters if batched else iters + 1
    assert counted["bodies"] == replays(first_terminal, jit_chunk)
    in_last_chunk = first_terminal - (first_terminal - 1) // jit_chunk * jit_chunk
    assert counted["stopped"] == int(in_last_chunk + graphs.LOOKAHEAD - 1 < jit_chunk)

    def every_body(replay, done, k, lookahead):
        for i in range(k):
            replay(i)
        return k

    ref = _eager(make()).solve(x0, y0)
    with monkeypatch.context() as m:
        m.setattr(graphs, "replay_until_done", every_body)
        whole, whole_counted = solve(make())
    assert whole_counted == {"bodies": -(-first_terminal // jit_chunk) * jit_chunk, "stopped": 0}
    fields = ("x", "y", "d", "status", "iterations", "accepted_steps") if batched else ("x", "y", "d")
    for other in (ref, whole):
        for field in fields:
            assert torch.equal(getattr(res, field), getattr(other, field)), field
        if not batched:
            assert (res.status, res.iterations, res.num_accepted_steps) == (
                other.status, other.iterations, other.num_accepted_steps)


def test_captures_counted_once_per_width(cuda):
    """``util.CAPTURES`` counts the process's graph captures: a batched
    solver captures one graph, and adds to the capture time, at each width
    new to it, and none at a width it has."""
    from pygradflow_torch.parallel import BatchedSolver
    from pygradflow_torch.util import CAPTURES

    from .torch_parity import Rosenbrock

    solver = BatchedSolver(Rosenbrock(), Params(jit_chunk=8), compact=False, device=cuda)
    x0 = np.random.default_rng(4).uniform(-1.5, 1.5, (16, 2))
    for width, new in ((8, 1), (8, 0), (16, 1), (4, 1), (16, 0)):
        graphs, ns, captures = CAPTURES["graphs"], CAPTURES["ns"], solver.loop.graph.captures
        solver.solve(x0[:width])
        assert CAPTURES["graphs"] - graphs == new == solver.loop.graph.captures - captures, width
        assert (CAPTURES["ns"] > ns) == bool(new), width


def test_host_reading_problem_raises_on_the_card(cuda):
    """A problem whose objective branches on a tensor cannot be captured:
    the solve raises and names the objective.  The process goes on: HS71
    solved as a graph before and after the failed capture gives the same
    bits."""
    from pygradflow_torch import Problem
    from pygradflow_torch.graphs import GraphCaptureError

    from .torch_parity import HS71

    class Branching(Problem):
        def __init__(self):
            super().__init__(np.full(2, -np.inf), np.full(2, np.inf))

        def obj(self, x):
            return torch.dot(x, x) if bool(x[0] > 0) else torch.dot(x, x) + 1.0

    x0, y0 = np.array([1.0, 5.0, 5.0, 1.0, 0.0]), np.zeros(2)
    before = Solver(HS71(), Params(), device=cuda).solve(x0, y0)
    with pytest.raises(GraphCaptureError, match="objective"):
        Solver(Branching(), Params(validate_input=False), device=cuda).solve(np.array([1.0, 1.0]))
    solver = Solver(HS71(), Params(), device=cuda)
    after = solver.solve(x0, y0)
    assert solver._loop.graphed and solver._loop.graph.captures == 1
    assert (after.status, after.iterations, after.num_accepted_steps) == (before.status, before.iterations,
                                                                         before.num_accepted_steps)
    for field in ("x", "y", "d"):
        assert torch.equal(getattr(after, field), getattr(before, field)), field


def test_host_reading_problem_raises_at_the_start_graph(cuda):
    """Under ``validate_input`` the first graph a solve captures is its
    start: a problem whose objective branches on a tensor fails there with
    the error that the loop's graph gives, naming the objective, and no
    loop graph is captured."""
    from pygradflow_torch import Problem
    from pygradflow_torch.graphs import GraphCaptureError

    class Branching(Problem):
        def __init__(self):
            super().__init__(np.full(2, -np.inf), np.full(2, np.inf))

        def obj(self, x):
            return torch.dot(x, x) if bool(x[0] > 0) else torch.dot(x, x) + 1.0

    solver = Solver(Branching(), Params(validate_input=True), device=cuda)
    with pytest.raises(GraphCaptureError, match="objective"):
        solver.solve(np.array([1.0, 1.0]))
    assert solver._loop.graph.captures == 0


def _start_cases(cuda):
    """(make problem, params, starts): the benchmark's shifted Rosenbrock
    and its chain at nh = 16, each instance's data overwritten in place
    (``example_data``), and HS71; each start ``((x0, y0), data)``, data
    None for a plain problem."""
    from . import cops_chain as cc
    from .torch_parity import HS71

    def rosenbrock():
        config = cc.MANIFEST.config_module("rosenbrock")
        return config.make_problem(cc.MANIFEST.config_numbers("rosenbrock"), {}, cuda, torch.float64)

    rng = np.random.default_rng(21)
    rosen = [((rng.uniform(-1.5, 1.5, 2), None), (rng.uniform(-1.0, 1.0, 2),)) for _ in range(3)]
    hs71 = [((np.array([1.0, 5.0, 5.0, 1.0, 0.0]) + 0.1 * k, np.zeros(2)), None) for k in range(2)]
    chains = [((x0, None), (delta,)) for delta, x0 in cc.instances(cc.problem(16), 23, 2)]
    return {
        "rosenbrock": (rosenbrock, Params(), rosen),
        "hs71": (lambda: HS71(), Params(), hs71),
        "cops-chain-nh16": (lambda: cc.problem(16, cuda), cc.params(), chains),
    }


def _pose(problem, data):
    """Overwrite a parametric problem's data in place with ``data``."""
    for buf, value in zip(getattr(problem, "example_data", ()), data or ()):
        buf.copy_(torch.as_tensor(value, dtype=buf.dtype, device=buf.device))


@pytest.mark.parametrize("case", ["rosenbrock", "hs71", "cops-chain-nh16"])
def test_graphed_start_equals_eager_start(cuda, case):
    """A solve whose start is one replay of the start graph gives the eager
    route's solve bit for bit, call after call on instances overwritten in
    place; the first solve captures the start graph and the loop's, every
    later one captures none and replays the start once."""
    from pygradflow_torch.util import CAPTURES, HOST_READS, STARTS

    make, params, starts = _start_cases(cuda)[case]
    prob_g, prob_e = make(), make()
    graphed = Solver(prob_g, params, device=cuda)
    eager = _eager(Solver(prob_e, params, device=cuda))
    for call, ((x0, y0), data) in enumerate(starts):
        _pose(prob_g, data)
        _pose(prob_e, data)
        counts, graphs, reads = dict(STARTS), CAPTURES["graphs"], HOST_READS["start"]
        res = graphed.solve(x0, y0)
        assert STARTS["graphed"] - counts.get("graphed", 0) == 1
        assert CAPTURES["graphs"] - graphs == (2 if call == 0 else 0)
        assert graphed._loop.graph.captures == 1 and HOST_READS["start"] - reads == 1
        ref = eager.solve(x0, y0)
        assert STARTS["eager"] - counts.get("eager", 0) == 1 and STARTS["fallback"] == counts.get("fallback", 0)
        assert res.status.name == "Optimal"
        assert (res.status, res.iterations, res.num_accepted_steps) == (ref.status, ref.iterations,
                                                                         ref.num_accepted_steps)
        assert res.num_evals == ref.num_evals
        for field in ("x", "y", "d"):
            assert torch.equal(getattr(res, field), getattr(ref, field)), field


def test_nan_start_on_the_graphed_route_raises_then_solves(cuda):
    """A NaN in the start, on the graphed route, raises the eager check's
    error through the fallback; the same solver then solves a sound start
    to the eager route's bits, without a new capture."""
    from pygradflow_torch.eval import EvalError
    from pygradflow_torch.util import STARTS

    from .torch_parity import HS71

    x0, y0 = np.array([1.0, 5.0, 5.0, 1.0, 0.0]), np.zeros(2)
    solver = Solver(HS71(), Params(), device=cuda)
    fallback = STARTS["fallback"]
    with pytest.raises(Exception, match="Failed to evaluate initial iterate") as err:
        solver.solve(np.array([1.0, 5.0, np.nan, 1.0, 0.0]), y0)
    assert isinstance(err.value.__cause__, EvalError) and str(err.value.__cause__) == "Infinite objective"
    assert STARTS["fallback"] - fallback == 1
    res = solver.solve(x0, y0)
    ref = _eager(Solver(HS71(), Params(), device=cuda)).solve(x0, y0)
    assert solver._loop.graph.captures == 1 and STARTS["fallback"] - fallback == 1
    assert (res.status, res.iterations, res.num_accepted_steps) == (ref.status, ref.iterations,
                                                                     ref.num_accepted_steps)
    for field in ("x", "y", "d"):
        assert torch.equal(getattr(res, field), getattr(ref, field)), field


def test_check_input_span_is_graphed_on_the_card(cuda):
    """On the card's graphed route ``pgf.check_input`` stays a child of
    ``pgf.prepare`` and carries ``graphed`` true; on the eager route false."""
    from torch.profiler import profile

    from .torch_parity import Rosenbrock

    for solver, graphed in ((Solver(Rosenbrock(), Params(), device=cuda), True),
                            (_eager(Solver(Rosenbrock(), Params(), device=cuda)), False)):
        solver.solve(np.zeros(2))
        util.SPANS.clear()
        with profile():
            solver.solve(np.zeros(2))
        (prepare,) = [sp for sp in util.SPANS if sp.name == "pgf.prepare"]
        (check,) = [sp for sp in util.SPANS if sp.name == "pgf.check_input"]
        assert check.parent == prepare.index and check.attrs == {"graphed": graphed}
        util.SPANS.clear()


def test_launches_counted_after_a_first_graph_without_kernels(cuda):
    """In a fresh process whose first graphed solve launches no counted
    kernel (HS71 on LU, before the wrappers' module is imported), a later
    graphed PallasLDLT solve still counts the launches of B1' on the device:
    one per body replayed and one in the capture's warm-up."""
    import os
    import subprocess
    import sys

    code = """
import numpy as np, sys
from pygradflow_torch import LinearSolverType, Params, Solver
from pygradflow_torch.runners.control import PendulumControl
from tests.torch_parity import HS71
Solver(HS71(), Params(), device="cuda").solve(np.array([1.0, 5.0, 5.0, 1.0, 0.0]), np.zeros(2))
assert "pygradflow_torch.linalg.ldlt_kernels" not in sys.modules
problem = PendulumControl(N=16)
params = Params(linear_solver_type=LinearSolverType.PallasLDLT, validate_input=False)
res = Solver(problem, params, device="cuda").solve(problem.x0_trajectory())
from pygradflow_torch.linalg import ldlt_kernels as lk
print(res.status.name, res.iterations, lk.LAUNCHES["rl"])
"""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    status, iterations, launches = out.stdout.split()[-3:]
    assert status == "Optimal" and int(launches) == graphed_launches(int(iterations))


def test_host_evaluating_problems_take_the_eager_loop(cuda, fake_pycutest):
    """Problems that evaluate on the host by design (CUTEst's callbacks,
    ``--debug_nans``'s checks) solve on the card through the eager loop,
    to the CPU run's counts and, for the checked HS71, to the graphed
    solve's bits."""
    from pygradflow_torch.runners.cutest_runner import CUTEstRunner
    from pygradflow_torch.runners.hs import HS_BY_NAME
    from pygradflow_torch.runners.hs_runner import HSInstance
    from pygradflow_torch.util import HOST_READS

    runner = CUTEstRunner()
    for inst in runner.get_instances(runner.parser().parse_args([])):
        ours, cpu = inst.solve(Params(), cuda), inst.solve(Params(), "cpu")
        assert ours.success and ours.x.device.type == "cuda", inst.name
        assert (ours.iterations, ours.num_accepted_steps) == (cpu.iterations, cpu.num_accepted_steps), inst.name
        np.testing.assert_allclose(ours.x.cpu().numpy(), cpu.x.numpy(), rtol=0, atol=1e-8)

    hs71 = HSInstance(HS_BY_NAME["hs71"])
    graphed = hs71.solve(Params(), cuda)
    HOST_READS.clear()
    checked = hs71.solve(Params(), cuda, debug_nans=True)
    assert HOST_READS["eager"] > 0
    assert (checked.status, checked.iterations) == (graphed.status, graphed.iterations)
    for field in ("x", "y", "d"):
        assert torch.equal(getattr(checked, field), getattr(graphed, field)), field


def test_graphed_solves_in_concurrent_processes(cuda):
    """Four processes solve the parity harness's HS and option cases on one
    card at once, each through the graphed loop, the card time-sliced
    between them: every process holds every case to
    the JAX rows and exits 0.  (A conditional IF node around the captured
    body failed here at random with an unspecified launch failure.)"""
    import os
    import subprocess
    import sys

    from tools import torch_parity_cases as pc

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cases = [c.name for c in pc.cases() if c.kind in ("hs", "option")]
    cmd = [sys.executable, os.path.join(root, "tools", "torch_parity_check.py"), "--side", "torch", "--device",
           "cuda", "--max-iterations", "200", "--cases", *cases]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
        assert " 0 failed " in out.strip().splitlines()[-1], out[-3000:]


def test_cops_chain_graphed_equals_eager(cuda):
    """The benchmark's COPS hanging chain at nh = 200 (KKT 1409, B3') on
    its normal path: the graphed solve gives the eager route's bits; B3' is
    launched once per body replayed, plus once in the capture's warm-up on
    the first solve, and once per iteration on the eager route; both routes
    count two refined KKT solves and six float64 sweeps per factor
    (``ldlt_kernels.REFINED``, on the device inside the graph)."""
    from pygradflow_torch import SolverStatus

    from . import cops_chain as cc

    prob_g, prob_e = cc.problem(200, cuda), cc.problem(200, cuda)
    graphed = Solver(prob_g, cc.params(), device=cuda)
    eager = _eager(Solver(prob_e, cc.params(), device=cuda))
    for call, (delta, x0) in enumerate(cc.instances(prob_g, 19, 2)):
        counts = []
        for solver, prob in ((graphed, prob_g), (eager, prob_e)):
            launches, refined = lk.LAUNCHES["ll"], dict(lk.REFINED)
            res = cc.solve(solver, prob, delta, x0)
            counts.append((res, lk.LAUNCHES["ll"] - launches, {k: lk.REFINED[k] - refined[k] for k in refined}))
        (res, ll, refined), (ref, ll_eager, refined_eager) = counts
        assert res.status == SolverStatus.Optimal and res.x.device.type == "cuda"
        assert (res.status, res.iterations, res.num_accepted_steps) == (ref.status, ref.iterations,
                                                                         ref.num_accepted_steps)
        for field in ("x", "y", "d"):
            assert torch.equal(getattr(res, field), getattr(ref, field)), field
        assert graphed._loop.graph.captures == 1
        warm_up = 1 if call == 0 else 0
        assert ll == graphed._loop.graph.replayed + warm_up == replays(res.iterations + 1, 64) + warm_up
        assert ll_eager == ref.iterations
        assert refined == {"solves": 2 * ll, "sweeps": 6 * ll}
        assert refined_eager == {"solves": 2 * ll_eager, "sweeps": 6 * ll_eager}
