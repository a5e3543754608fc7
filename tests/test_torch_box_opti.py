"""The port's BoxReduced and Optimizing step controls against the JAX
package: the projected-Newton box solver and the primal-dual interior
point on seeded box QPs (the case of ``tests/test_opti_control.py`` and
m = 0 included), the step-control sweep of ``tests/test_solver.py`` on
HS71, the boxed and unbounded QPs of ``tests/test_qp.py``, Optimizing on
Rosenbrock, and 8 lockstep lanes of Rosenbrock under each control against
the JAX lanes and the port's single ``Solver``."""

import jax.numpy as jnp
import numpy as np
import pytest

import pygradflow_torch
import pygradflow_tpu
from pygradflow_torch.eval import lane_fns, make_fns
from pygradflow_torch.linalg import LinearSolverType, linear_solver
from pygradflow_torch.parallel import BatchedSolver
from pygradflow_torch.problem import Problem, QuadraticProblem
from pygradflow_torch.step.box_solver import solve_box_constrained
from pygradflow_torch.step.ip_solver import solve_ip
from pygradflow_tpu.eval import make_fns as j_make_fns
from pygradflow_tpu.parallel import BatchedSolver as JBatchedSolver
from pygradflow_tpu.step.box_solver import solve_box_constrained as j_solve_box_constrained
from pygradflow_tpu.step.ip_solver import solve_ip as j_solve_ip

from .test_torch_batch import _check_lanes, _check_single
from .torch_parity import Rosenbrock, assert_same_solve, numpy, params_pair, solve_both, tensor

HS71_X0 = np.array([1.0, 5.0, 5.0, 1.0, 0.0])


def _box_qp(case):
    """(H, g, lb, ub, x0, obj_lower) of a seeded box QP ``1/2 x'Hx + g'x``."""
    rng = np.random.default_rng(case)
    n = 6
    a = rng.standard_normal((n, n))
    H = a @ a.T + 0.5 * np.eye(n)
    g = 3.0 * rng.standard_normal(n)
    lb, ub = -np.ones(n), np.ones(n)
    obj_lower = -1e20
    if case == 1:  # half-infinite bounds
        lb[::2], ub[1::2] = -np.inf, np.inf
    if case == 2:  # indefinite, no bounds: the Newton direction is no descent
        H = H - 4.0 * np.outer(a[:, 0], a[:, 0]) / np.dot(a[:, 0], a[:, 0]) * np.linalg.norm(H, 2)
        lb[:], ub[:] = -np.inf, np.inf
    if case == 3:  # a minimum below obj_lower: unbounded
        H = H * 1e-6
        lb[:], ub[:] = -np.inf, np.inf
        obj_lower = -1e3
    return H, g, lb, ub, rng.uniform(-2.0, 2.0, n), obj_lower


def _quadratic(H, g, lib):
    if lib == "jax":
        H, g = jnp.asarray(H), jnp.asarray(g)
        return (lambda x: 0.5 * x @ H @ x + g @ x), (lambda x: H @ x + g), (lambda x: H)
    H, g = tensor(H), tensor(g)
    dot = lambda u, v: (u * v).sum(-1)  # noqa: E731
    return (
        lambda x: 0.5 * dot(x, (x @ H.mT)) + dot(g, x),
        lambda x: x @ H.mT + g,
        lambda x: H.expand(x.shape[:-1] + H.shape),
    )


@pytest.mark.parametrize("case", [0, 1, 2, 3], ids=["box", "half_infinite", "indefinite", "unbounded"])
def test_solve_box_constrained_matches_jax(case):
    H, g, lb, ub, x0, obj_lower = _box_qp(case)
    ref = j_solve_box_constrained(jnp.asarray(x0), *_quadratic(H, g, "jax"), jnp.asarray(lb), jnp.asarray(ub), obj_lower)
    ours = solve_box_constrained(tensor(x0), *_quadratic(H, g, "torch"), tensor(lb), tensor(ub), obj_lower)
    assert (int(ours.status), int(ours.iterations)) == (int(ref.status), int(ref.iterations))
    assert int(ref.status) == {2: 4, 3: 2}.get(case, 1)
    np.testing.assert_allclose(numpy(ours.x), np.asarray(ref.x), rtol=1e-10, atol=1e-12)


def test_solve_box_constrained_lanes_equal_single():
    """Four start points of one QP as lanes: each lane finishes after its own
    iterations and keeps its x, as the single solve gives it."""
    H, g, lb, ub, _, obj_lower = _box_qp(0)
    x0s = np.random.default_rng(5).uniform(-3.0, 3.0, (4, 6))
    x0s[3] = np.clip(-np.linalg.solve(H, g), lb, ub) + 1e-3  # a few iterations only
    fns = _quadratic(H, g, "torch")
    lanes = solve_box_constrained(tensor(x0s), *fns, tensor(lb), tensor(ub), obj_lower)
    for lane in range(4):
        single = solve_box_constrained(tensor(x0s[lane]), *fns, tensor(lb), tensor(ub), obj_lower)
        assert (int(lanes.status[lane]), int(lanes.iterations[lane])) == (int(single.status), int(single.iterations))
        np.testing.assert_allclose(numpy(lanes.x[lane]), numpy(single.x), rtol=1e-13, atol=1e-15)
    assert len(set(lanes.iterations.tolist())) > 1


class _OptiBoxQP(Problem):
    """``tests/test_opti_control.py:34-45``: min (x0-2)^2 + (x1+1)^2 s.t.
    x0 + x1 = 1, 0 <= x <= 1.5."""

    def __init__(self):
        super().__init__(np.zeros(2), np.full(2, 1.5), num_cons=1)

    def obj(self, v):
        return (v[0] - 2.0) ** 2 + (v[1] + 1.0) ** 2

    def cons(self, v):
        return (v[0] + v[1] - 1.0)[None]


class _Bounded(Problem):
    """``tests/test_opti_control.py:88-95``: m = 0, x* = (0, 2) on [0, 2]^2."""

    def __init__(self):
        super().__init__(np.zeros(2), np.full(2, 2.0))

    def obj(self, v):
        return (v[0] + 1.0) ** 2 + (v[1] - 3.0) ** 2


def _jax_twin(name):
    from pygradflow_tpu.problem import Problem as JProblem

    if name == "opti_box_qp":

        class J(JProblem):
            def __init__(self):
                super().__init__(np.zeros(2), np.full(2, 1.5), num_cons=1)

            def obj(self, v):
                return (v[0] - 2.0) ** 2 + (v[1] + 1.0) ** 2

            def cons(self, v):
                return jnp.array([v[0] + v[1] - 1.0])

        return J(), _OptiBoxQP()

    class JB(JProblem):
        def __init__(self):
            super().__init__(np.zeros(2), np.full(2, 2.0))

        def obj(self, v):
            return (v[0] + 1.0) ** 2 + (v[1] - 3.0) ** 2

    return JB(), _Bounded()


IP_CASES = {
    # tests/test_opti_control.py:28: lamb 1e-4, rho 1, centre (1, 0)
    "opti_box_qp": (1e-4, 1.0, [1.0, 0.0], [0.0]),
    "opti_box_qp_far": (0.5, 0.1, [1.4, 1.2], [0.3]),
    "bounded_m0": (1e-2, 0.0, [1.0, 1.0], []),
}


def _ip_both(name):
    lamb, rho, xhat, yhat = IP_CASES[name]
    jprob, tprob = _jax_twin("bounded" if name == "bounded_m0" else "opti_box_qp")
    jp, tp = params_pair()
    jlin = pygradflow_tpu.linalg.linear_solver(pygradflow_tpu.LinearSolverType.LDLT, symmetric=True)
    tlin = linear_solver(LinearSolverType.LDLT, symmetric=True)
    ref = j_solve_ip(
        j_make_fns(jprob, jp), lambda K, b: jlin.solve(jlin.factor(K), b), jnp.asarray(xhat), jnp.asarray(yhat),
        jnp.asarray(lamb), jnp.asarray(rho), jnp.asarray(jprob.var_lb), jnp.asarray(jprob.var_ub),
    )
    tfns = make_fns(tprob, tp)
    fs = lambda K, b: tlin.solve(tlin.factor(K), b)  # noqa: E731
    lb, ub = tensor(tprob.var_lb), tensor(tprob.var_ub)
    ours = solve_ip(tfns, fs, tensor(xhat), tensor(np.asarray(yhat, dtype=float)), lamb, rho, lb, ub)
    return ref, ours, (tfns, fs, lamb, rho, xhat, yhat, lb, ub)


@pytest.mark.parametrize("name", list(IP_CASES))
def test_solve_ip_matches_jax(name):
    ref, ours, _ = _ip_both(name)
    assert bool(ref.converged) and bool(ours.converged)
    assert int(ours.iterations) == int(ref.iterations)
    np.testing.assert_allclose(numpy(ours.x), np.asarray(ref.x), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(numpy(ours.nu), np.asarray(ref.nu), rtol=1e-10, atol=1e-12)


def test_solve_ip_lanes_equal_single():
    """Three proximal centres as lanes (``lamb`` and ``rho`` per lane)."""
    _, _, (tfns, fs, _, _, _, _, lb, ub) = _ip_both("opti_box_qp")
    lambs, rhos = [1e-4, 0.5, 2.0], [1.0, 0.1, 0.0]
    xhats, yhats = np.array([[1.0, 0.0], [1.4, 1.2], [0.2, 0.9]]), np.array([[0.0], [0.3], [-1.0]])
    lanes = solve_ip(lane_fns(tfns), fs, tensor(xhats), tensor(yhats), tensor(lambs), tensor(rhos), lb, ub)
    assert len(set(lanes.iterations.tolist())) > 1
    for i in range(3):
        single = solve_ip(tfns, fs, tensor(xhats[i]), tensor(yhats[i]), lambs[i], rhos[i], lb, ub)
        assert int(lanes.iterations[i]) == int(single.iterations) and bool(lanes.converged[i])
        np.testing.assert_allclose(numpy(lanes.x[i]), numpy(single.x), rtol=1e-13, atol=1e-15)
        np.testing.assert_allclose(numpy(lanes.nu[i]), numpy(single.nu), rtol=1e-13, atol=1e-15)


def _hs71():
    from tests.problems import HS71 as JHS71

    from .torch_parity import HS71

    return JHS71(), HS71()


@pytest.mark.parametrize("control,counts", [("BoxReduced", (11, 8)), ("Optimizing", (7, 7))])
def test_step_control_sweep_matches_jax(control, counts):
    """``tests/test_solver.py::test_step_control_sweep`` (``rho=1e-1``)."""
    jprob, tprob = _hs71()
    jr, tr = solve_both(jprob, tprob, HS71_X0, np.zeros(2), step_control_type=control, rho=1e-1)
    assert (jr.status.name, jr.iterations, jr.num_accepted_steps) == ("Optimal",) + counts
    assert_same_solve(tr, jr)


def _qp(kind):
    from tests.test_qp import _boxed_qp, _unbounded_qp

    if kind == "boxed":
        jprob, lb = _boxed_qp()
        x0 = np.maximum(lb, 0.0)
    else:
        jprob, x0 = _unbounded_qp(), 0.0
    tprob = QuadraticProblem(np.asarray(jprob.Q), np.asarray(jprob.c), var_lb=jprob.var_lb, var_ub=jprob.var_ub)
    return jprob, tprob, x0


@pytest.mark.parametrize(
    "kind,kwargs,expect",
    [
        ("boxed", dict(lamb_init=1e-12, iteration_limit=1000), ("Optimal", 15, 1)),
        ("unbounded", dict(), ("Unbounded", 27, 12)),
    ],
    ids=["boxed", "unbounded"],
)
def test_box_reduced_qps_match_jax(kind, kwargs, expect):
    """BoxReduced on the boxed QP (n = 49, from ``max(lb, 0)``) and on the
    unbounded QP (n = 199) of ``tests/test_qp.py``, whose x reaches 1e4 and
    is held to 1e-10 relative."""
    jprob, tprob, x0 = _qp(kind)
    jr, tr = solve_both(jprob, tprob, x0, step_control_type="BoxReduced", **kwargs)
    assert (jr.status.name, jr.iterations, jr.num_accepted_steps) == expect
    if kind == "boxed":
        assert_same_solve(tr, jr)
        return
    assert (tr.status.name, tr.iterations, tr.num_accepted_steps) == expect
    assert {c.name(): int(n) for c, n in tr.num_evals.items()} == {c.name(): int(n) for c, n in jr.num_evals.items()}
    np.testing.assert_allclose(numpy(tr.x), jr.x, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("problem", ["rosenbrock", "bounded_m0"])
def test_optimizing_matches_jax(problem):
    """Optimizing on Rosenbrock (``rho=1e-1``, 8/8) and on the bounded
    problem of ``tests/test_opti_control.py`` (m = 0, the optimum on its
    bounds)."""
    if problem == "rosenbrock":
        from tests.problems import Rosenbrock as JRosenbrock

        jr, tr = solve_both(JRosenbrock(), Rosenbrock(), np.zeros(2), step_control_type="Optimizing", rho=1e-1)
        assert (jr.iterations, jr.num_accepted_steps) == (8, 8)
    else:
        jprob, tprob = _jax_twin("bounded")
        jr, tr = solve_both(jprob, tprob, np.ones(2), step_control_type="Optimizing")
        np.testing.assert_allclose(numpy(tr.x), [0.0, 2.0], atol=1e-6)
    assert jr.status.name == "Optimal"
    assert_same_solve(tr, jr)


@pytest.mark.parametrize("control", ["Optimizing", "BoxReduced"])
def test_batched_rosenbrock_controls_match_jax_and_single(control):
    """8 lanes of Rosenbrock at ``bench.py``'s starts (``validate_input=False``,
    ``rho=1e-1``): each lane equals the JAX lane, lanes 0 and 3 the port's
    single ``Solver``."""
    from tests.problems import Rosenbrock as JRosenbrock

    x0s = np.random.default_rng(0).uniform(-1.5, 1.5, size=(8, 2))
    jp, tp = params_pair(step_control_type=control, rho=1e-1, validate_input=False)
    jr = JBatchedSolver(JRosenbrock(), jp).solve(x0s)
    tr = BatchedSolver(Rosenbrock(), tp, device="cpu").solve(x0s)
    _check_lanes(tr, jr)
    assert (tr.status == int(pygradflow_torch.SolverStatus.Optimal)).all()
    expect = {"Optimizing": [8, 8, 7, 8, 7, 8, 8, 8], "BoxReduced": [10, 11, 12, 15, 10, 10, 10, 10]}[control]
    assert numpy(tr.iterations).tolist() == expect
    for lane in (0, 3):
        _check_single(tr, lane, pygradflow_torch.Solver(Rosenbrock(), tp, device="cpu").solve(tensor(x0s[lane])))
    assert tr.rcond is None  # report_rcond is off
