"""The port's ``BatchedSolver`` against the JAX package's on the
configurations of ``tests/test_batch.py``, and on a pendulum MPC fleet with
the mixed-precision LDL^T tier.

Each lane must give the JAX lane's status, iteration and accepted-step
counts, with x and y within 1e-6; and each lane must equal the port's own
single ``Solver`` on that instance, evaluation counts included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygradflow_torch
from pygradflow_torch.linalg import ldlt_kernels as lk
from pygradflow_torch.parallel import BatchedSolver
from pygradflow_torch.runners.control import PendulumControl as TPendulum
from pygradflow_torch.util import tree_map
from pygradflow_tpu.parallel import BatchedSolver as JBatchedSolver
from pygradflow_tpu.runners.control import PendulumControl as JPendulum

from .torch_parity import ANCHOR, numpy, params_pair, tensor

SOL_TOL = 1e-6


def _check_lanes(tr, jr):
    assert [pygradflow_torch.SolverStatus(int(s)).name for s in tr.status] == [
        pygradflow_torch.SolverStatus(int(s)).name for s in jr.status
    ]
    np.testing.assert_array_equal(numpy(tr.iterations), jr.iterations)
    np.testing.assert_array_equal(numpy(tr.accepted_steps), jr.accepted_steps)
    np.testing.assert_allclose(numpy(tr.x), jr.x, rtol=0, atol=SOL_TOL)
    np.testing.assert_allclose(numpy(tr.y), jr.y, rtol=0, atol=SOL_TOL)
    np.testing.assert_allclose(numpy(tr.d), jr.d, rtol=0, atol=SOL_TOL)


def _check_single(tr, lane, single):
    """Lane ``lane`` of a batched result against a single solve."""
    assert int(tr.status[lane]) == int(single.status)
    assert (int(tr.iterations[lane]), int(tr.accepted_steps[lane])) == (
        single.iterations, single.num_accepted_steps,
    )
    np.testing.assert_allclose(numpy(tr.x[lane]), numpy(single.x), rtol=0, atol=SOL_TOL)
    np.testing.assert_allclose(numpy(tr.y[lane]), numpy(single.y), rtol=0, atol=SOL_TOL)
    assert [int(c[lane]) for c in tr.counters] == list(single.num_evals.values())


def _problems(name):
    import tests.problems as jprob

    from . import torch_parity as tprob

    return getattr(jprob, name)(), getattr(tprob, name)()


def test_batched_rosenbrock_matches_jax():
    jprob, tprob = _problems("Rosenbrock")
    x0s = np.array([[0.0, 0.0], [0.5, -0.3], [-1.2, 1.0], [2.0, 2.0]])
    jp, tp = params_pair()
    jr = JBatchedSolver(jprob, jp).solve(x0s)
    tr = BatchedSolver(tprob, tp, device="cpu").solve(x0s)
    _check_lanes(tr, jr)
    assert bool(tr.success.all())
    for lane, x0 in enumerate(x0s):
        _check_single(tr, lane, pygradflow_torch.Solver(tprob, tp, device="cpu").solve(tensor(x0)))


def test_batched_constrained_matches_jax():
    """HS71 with y0 given, one lane perturbed."""
    jprob, tprob = _problems("HS71")
    x0s = np.tile(np.array([1.0, 5.0, 5.0, 1.0, 0.0]), (3, 1))
    x0s[1, 1] = 4.0
    y0s = np.zeros((3, 2))
    jp, tp = params_pair()
    jr = JBatchedSolver(jprob, jp).solve(x0s, y0s)
    tr = BatchedSolver(tprob, tp, device="cpu").solve(x0s, y0s)
    _check_lanes(tr, jr)
    for lane in range(3):
        single = pygradflow_torch.Solver(tprob, tp, device="cpu").solve(tensor(x0s[lane]), tensor(y0s[lane]))
        _check_single(tr, lane, single)


def _param_data(seed, size):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.5, 2.0, size=size), rng.uniform(10.0, 100.0, size=size)


@pytest.mark.parametrize("compact", [False, True], ids=["plain", "compacting"])
def test_parametric_batch_matches_jax(compact):
    """Per-lane (a, b) passed through vmap as an argument; with compaction
    the data follows its lanes through every repack."""
    from tests.test_batch import ParamRosenbrock as JParamRosenbrock

    from .torch_parity import ParamRosenbrock, Rosenbrock

    a, b = _param_data(5, 10)
    x0s = np.zeros((10, 2))
    kwargs = dict(compact=True, harvest_chunk=4, min_tier=2) if compact else dict(compact=False)
    jp, tp = params_pair()
    jr = JBatchedSolver(JParamRosenbrock(), jp, **kwargs).solve(x0s, data=(jnp.asarray(a), jnp.asarray(b)))
    tr = BatchedSolver(ParamRosenbrock(), tp, device="cpu", **kwargs).solve(x0s, data=(a, b))
    _check_lanes(tr, jr)
    np.testing.assert_allclose(numpy(tr.x), np.stack([a, a**2], axis=1), atol=1e-5)
    for lane in (0, 7):
        single = pygradflow_torch.Solver(Rosenbrock(a[lane], b[lane]), tp, device="cpu").solve(tensor(x0s[lane]))
        _check_single(tr, lane, single)


def test_compacting_matches_plain_and_jax():
    """Harvest and compaction only permute lanes: the results equal the
    non-compacting run bit for bit on the CPU, over several shrinks."""
    jprob, tprob = _problems("Rosenbrock")
    x0s = np.random.default_rng(3).uniform(-2.0, 2.0, size=(12, 2))
    jp, tp = params_pair()
    plain = BatchedSolver(tprob, tp, compact=False, device="cpu").solve(x0s)
    compacted = BatchedSolver(tprob, tp, compact=True, harvest_chunk=4, min_tier=2, device="cpu").solve(x0s)
    tree_map(lambda ours, ref: torch.testing.assert_close(ours, ref, rtol=0, atol=0), compacted, plain)
    assert len(set(numpy(plain.iterations).tolist())) > 4  # several harvests
    jr = JBatchedSolver(jprob, jp, compact=True, harvest_chunk=4, min_tier=2).solve(x0s)
    _check_lanes(compacted, jr)


def _fleet_x0(problem, batch):
    """Start points of ``benchmarks/bench_control.py:56-60``."""
    rng = np.random.default_rng(0)
    return problem.x0_trajectory()[None, :] + 0.02 * rng.standard_normal((batch, problem.num_vars))


def test_pendulum_fleet_matches_jax():
    """N = 8, B = 4 with the mixed-precision tier: the batched plain kernel
    (KKT 44, padded to 128) serves every factor."""
    x0s = _fleet_x0(JPendulum(N=8), 4)
    jp, tp = params_pair(**ANCHOR)
    jr = JBatchedSolver(JPendulum(N=8), jp).solve(x0s)
    before = dict(lk.LAUNCHES)
    tr = BatchedSolver(TPendulum(N=8), tp, device="cpu").solve(x0s)
    assert lk.LAUNCHES == before  # CPU tensors take the plain versions
    _check_lanes(tr, jr)
    assert [(int(i), int(a)) for i, a in zip(tr.iterations, tr.accepted_steps)] == [
        (15, 10), (17, 11), (17, 11), (15, 10)
    ]
    for lane in range(4):
        single = pygradflow_torch.Solver(TPendulum(N=8), tp, device="cpu").solve(tensor(x0s[lane]))
        _check_single(tr, lane, single)


def test_batched_iteration_limit():
    _, tprob = _problems("Rosenbrock")
    _, tp = params_pair(iteration_limit=3)
    res = BatchedSolver(tprob, tp, device="cpu").solve(np.zeros((2, 2)))
    assert [pygradflow_torch.SolverStatus(int(s)).name for s in res.status] == ["IterationLimit"] * 2
    assert numpy(res.iterations).tolist() == [3, 3]


def test_parametric_batch_needs_data():
    from .torch_parity import ParamRosenbrock

    with pytest.raises(ValueError, match="needs batched data"):
        BatchedSolver(ParamRosenbrock(), device="cpu").solve(np.zeros((2, 2)))
