"""The port's multi-device frontends on a simulated CPU mesh: ``ShardedSolver``
and ``ShardedIntegrationSolver`` over ``["cpu"] * k``, and
``distributed_schur_solve``, against the port's single-device solvers (bit
for bit) and against the JAX package's sharded solvers on its 8-device CPU
mesh (``tests/conftest.py``), on the inputs of ``tests/test_batch.py``,
``tests/test_schur.py`` and ``tests/test_integration_batch.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygradflow_tpu
from pygradflow_torch import Params, SolverStatus
from pygradflow_torch.integration import BatchedIntegrationSolver, ShardedIntegrationSolver
from pygradflow_torch.parallel import BatchedSolver, ShardedSolver
from pygradflow_torch.parallel.schur import distributed_schur_solve
from pygradflow_tpu.parallel import ShardedSolver as JShardedSolver
from tests import problems

from .torch_parity import HS71Explicit, ParamRosenbrock, Rosenbrock, numpy, tensor

X_TOL = 1e-8
"""x of a port solve against the JAX package's."""

SCHUR_RTOL, SCHUR_ATOL = 1e-9, 1e-10
"""``tests/test_schur.py``'s bound against the dense solve."""

MESH = ["cpu"] * 4


def _assert_bitwise(ours, ref):
    """Every field of two batch results equal bit for bit."""
    for field in ours._fields:
        a, b = getattr(ours, field), getattr(ref, field)
        if a is None or b is None:
            assert a is b, field
        elif isinstance(a, tuple):
            assert all(torch.equal(u, v) for u, v in zip(a, b)), field
        else:
            assert torch.equal(a, b), field


def _assert_matches_jax(tr, jr):
    assert [SolverStatus(int(s)).name for s in tr.status] == [
        pygradflow_tpu.SolverStatus(int(s)).name for s in jr.status
    ]
    np.testing.assert_array_equal(numpy(tr.iterations), np.asarray(jr.iterations))
    np.testing.assert_array_equal(numpy(tr.accepted_steps), np.asarray(jr.accepted_steps))
    np.testing.assert_allclose(numpy(tr.x), np.asarray(jr.x), rtol=0, atol=X_TOL)


def test_sharded_matches_batched_and_jax():
    """``tests/test_batch.py:113-132``: 16 Rosenbrock starts."""
    x0s = np.random.default_rng(0).uniform(-1.5, 1.5, size=(16, 2))
    sharded = ShardedSolver(Rosenbrock(), Params(), mesh=MESH).solve(x0s)
    batched = BatchedSolver(Rosenbrock(), Params(), device="cpu").solve(x0s)
    _assert_bitwise(sharded, batched)
    assert sharded.success.all()
    assert len(jax.devices()) == 8
    jr = JShardedSolver(problems.Rosenbrock(), pygradflow_tpu.Params()).solve(x0s)
    _assert_matches_jax(sharded, jr)


def test_sharded_parametric_matches_batched_and_jax():
    """``tests/test_batch.py:134-152``: per-instance data sharded with the
    states."""
    from tests.test_batch import ParamRosenbrock as JParamRosenbrock

    rng = np.random.default_rng(5)
    a, b = rng.uniform(0.5, 2.0, 8), rng.uniform(10.0, 100.0, 8)
    x0s = np.zeros((8, 2))
    sharded = ShardedSolver(ParamRosenbrock(), Params(), mesh=MESH).solve(x0s, data=(a, b))
    batched = BatchedSolver(ParamRosenbrock(), Params(), device="cpu").solve(x0s, data=(a, b))
    _assert_bitwise(sharded, batched)
    assert sharded.success.all()
    np.testing.assert_allclose(numpy(sharded.x), np.stack([a, a**2], axis=1), atol=1e-5)
    jr = JShardedSolver(JParamRosenbrock(), pygradflow_tpu.Params()).solve(
        x0s, data=(jnp.asarray(a), jnp.asarray(b))
    )
    _assert_matches_jax(sharded, jr)


def test_sharded_time_limit_and_uneven_batch():
    x0s = np.random.default_rng(0).uniform(-1.5, 1.5, size=(8, 2))
    res = ShardedSolver(Rosenbrock(), Params(time_limit=0.0, jit_chunk=1), mesh=MESH).solve(x0s)
    assert (res.status == int(SolverStatus.TimeLimit)).all()
    assert (res.iterations == 1).all()
    with pytest.raises(ValueError, match="divisible by the mesh size 4"):
        ShardedSolver(Rosenbrock(), Params(), mesh=MESH).solve(x0s[:6])


def test_sharded_loops_reused_across_solves():
    """Each shard's lane loop is built once and serves every later solve
    (JAX's ``test_jitted_callables_reused_across_solves``)."""
    solver = ShardedSolver(Rosenbrock(), Params(), mesh=MESH)
    x0s = np.random.default_rng(1).uniform(-1.5, 1.5, size=(8, 2))
    first = solver.solve(x0s)
    loops = dict(solver._loops)
    assert len(loops) == 4
    second = solver.solve(x0s)
    assert solver._loops == loops and all(solver._loops[k] is loops[k] for k in loops)
    _assert_bitwise(first, second)


def _schur_inputs():
    """``tests/test_schur.py:57-95``'s system and its dense solution."""
    rng = np.random.default_rng(3)
    nb, b, m = 16, 4, 6
    n = nb * b
    blocks = []
    for _ in range(nb):
        bk = rng.standard_normal((b, b))
        blocks.append(bk @ bk.T + b * np.eye(b))
    h_blocks = np.stack(blocks)
    A = np.zeros((n, n))
    for k in range(nb):
        A[k * b : (k + 1) * b, k * b : (k + 1) * b] = h_blocks[k]
    J = rng.standard_normal((m, n))
    M22 = -0.7 * np.eye(m)
    rhs_x = rng.standard_normal(n)
    rhs_y = rng.standard_normal(m)
    dense = np.linalg.solve(np.block([[A, J.T], [J, M22]]), np.concatenate([rhs_x, rhs_y]))
    return (h_blocks, J, M22, rhs_x, rhs_y), dense, n


@pytest.mark.parametrize("devices", [1, 4, 8])
def test_distributed_schur_matches_jax_and_dense(devices):
    from pygradflow_tpu.parallel.schur import distributed_schur_solve as jax_schur

    args, dense, n = _schur_inputs()
    sx, sy = distributed_schur_solve(*(tensor(a) for a in args), mesh=["cpu"] * devices)
    np.testing.assert_allclose(numpy(sx), dense[:n], rtol=SCHUR_RTOL, atol=SCHUR_ATOL)
    np.testing.assert_allclose(numpy(sy), dense[n:], rtol=SCHUR_RTOL, atol=SCHUR_ATOL)
    jx, jy = jax_schur(*(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(numpy(sx), np.asarray(jx), rtol=0, atol=1e-10)
    np.testing.assert_allclose(numpy(sy), np.asarray(jy), rtol=0, atol=1e-10)


def test_distributed_schur_needs_blocks_divisible():
    args, _, _ = _schur_inputs()
    with pytest.raises(ValueError, match="must divide over 3 devices"):
        distributed_schur_solve(*(tensor(a) for a in args), mesh=["cpu"] * 3)


def _integration_starts():
    """``tests/test_integration_batch.py:164-191``'s 8 perturbed HS71 lanes."""
    inst = problems.hs71_instance()
    rng = np.random.default_rng(11)
    lo = np.array([1.0, 1.0, 1.0, 1.0, 0.0])
    hi = np.array([5.0, 5.0, 5.0, 5.0, 2.0])
    return np.clip(inst.x_0[None, :] + rng.uniform(-0.1, 0.1, (8, 5)), lo, hi)


def _nudged(x0, j, ulps):
    x0 = x0.copy()
    for _ in range(abs(ulps)):
        x0[j] = np.nextafter(x0[j], np.inf if ulps > 0 else -np.inf)
    return x0


# (lane, coordinate, ulps): the JAX package's batched lane from that start
# takes the port's trajectory (ROADMAP Queue C, "Counts that rounding parts")
INTEG_NUDGES = [(0, 0, -1), (1, 0, -1), (6, 1, -3), (7, 0, -1)]
JAX_ENGINES_AGREE = [2, 5]
"""Lanes on which the JAX package's own sharded and batched runs give equal
counts; on lanes 0, 1, 3, 4 and 7 they part (Queue C)."""


def _counts(res):
    return [
        (int(s), int(i), int(k), int(n))
        for s, i, k, n in zip(
            np.asarray(res.status), np.asarray(res.iterations),
            np.asarray(res.num_integration_steps), np.asarray(res.num_newton_steps),
        )
    ]


def test_sharded_integration_matches_batched_and_jax():
    """Two shards of four lanes on the flat engine: bit for bit the port's
    batched lanes; each lane with the counts of the JAX package's batched
    lane from the same start or, on a knife edge, from the nudged start;
    against JAX's sharded run (one lane per device) the same statuses, x
    within its own test's 1e-6, and equal counts where JAX's two engines
    agree."""
    from pygradflow_tpu.integration import BatchedIntegrationSolver as JBatched
    from pygradflow_tpu.integration import ShardedIntegrationSolver as JSharded

    params = Params(iteration_limit=1000, rho=1e-2)
    x0s = _integration_starts()
    ours = ShardedIntegrationSolver(HS71Explicit(), params, mesh=["cpu"] * 2).solve(tensor(x0s))
    _assert_bitwise(ours, BatchedIntegrationSolver(HS71Explicit(), params, device="cpu").solve(tensor(x0s)))
    assert ours.success.all()

    jparams = pygradflow_tpu.Params(iteration_limit=1000, rho=1e-2)
    starts = np.concatenate([x0s, [_nudged(x0s[lane], j, u) for lane, j, u in INTEG_NUDGES]])
    jbatched = JBatched(problems.HS71(), jparams).solve(starts, np.zeros((len(starts), 2)))
    match = list(range(8))
    for k, (lane, _, _) in enumerate(INTEG_NUDGES):
        match[lane] = 8 + k
    assert _counts(ours) == [_counts(jbatched)[k] for k in match]
    np.testing.assert_allclose(numpy(ours.x), np.asarray(jbatched.x)[match], rtol=0, atol=X_TOL)

    jsharded = JSharded(problems.HS71(), jparams).solve(x0s, np.zeros((8, 2)))
    np.testing.assert_array_equal(numpy(ours.status), np.asarray(jsharded.status))
    np.testing.assert_allclose(numpy(ours.x), np.asarray(jsharded.x), rtol=0, atol=1e-6)
    for lane in JAX_ENGINES_AGREE:
        assert _counts(ours)[lane] == _counts(jsharded)[lane] == _counts(jbatched)[lane]


def test_sharded_integration_time_limit_and_uneven_batch():
    inst = problems.hs71_instance()
    params = Params(iteration_limit=1000, rho=1e-2, time_limit=1e-9, integration_chunk=8)
    x0s = np.stack([inst.x_0, inst.x_0 + 0.01])
    res = ShardedIntegrationSolver(HS71Explicit(), params, mesh=["cpu"] * 2).solve(tensor(x0s))
    assert (res.status == int(SolverStatus.TimeLimit)).all()
    assert (res.units == 8).all()
    with pytest.raises(ValueError, match="divisible by the mesh size 2"):
        ShardedIntegrationSolver(HS71Explicit(), params, mesh=["cpu"] * 2).solve(tensor(x0s[:1]))


def test_sharded_entry_points_need_a_card_or_a_mesh():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for make in (
        lambda: ShardedSolver(Rosenbrock(), Params()),
        lambda: ShardedIntegrationSolver(HS71Explicit(), Params()),
        lambda: distributed_schur_solve(*(tensor(a) for a in _schur_inputs()[0])),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
