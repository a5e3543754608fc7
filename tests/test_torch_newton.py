"""The port's Newton types, step-solver formulations and the tau variants of
the implicit function against the JAX package: the Newton x step-solver
sweep of ``tests/test_solver.py``, the QP Newton sweep of
``tests/test_qp.py``, ``tests/test_newton.py``, and the pendulum at N = 16
on the mixed-precision tier (B1's plain version).  Solves give equal
status, counts and evaluation counts, x, y and d within 1e-8 (1e-6 on
PallasLDLT); module values agree to 1e-10."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygradflow_torch
import pygradflow_tpu
from pygradflow_torch import implicit_func as t_impl
from pygradflow_torch import iterate as t_iter
from pygradflow_torch.eval import Counters, make_fns
from pygradflow_torch.newton import NewtonCfg, active_set_from_iterate, make_newton
from pygradflow_torch.problem import QuadraticProblem
from pygradflow_torch.runners.control import PendulumControl as TPendulum
from pygradflow_torch.step.solvers import step_solver_def
from pygradflow_tpu import implicit_func as j_impl
from pygradflow_tpu import iterate as j_iter
from pygradflow_tpu.eval import make_fns as j_make_fns
from pygradflow_tpu.runners.control import PendulumControl as JPendulum

from .torch_parity import ANCHOR, PALLAS_TOL, assert_same_solve, numpy, params_pair, solve_both, tensor

EXACT = 1e-10
HS71_X0 = np.array([1.0, 5.0, 5.0, 1.0, 0.0])


def _problems(name, *args):
    import tests.problems as jprob

    from . import torch_parity as tprob

    return getattr(jprob, name)(*args), getattr(tprob, name)(*args)


_NEWTON_CASES = [(nt, "Symmetric") for nt in ("Simplified", "Full", "ActiveSet", "Globalized", "FixedActiveSet")] + [
    ("Simplified", st) for st in ("Asymmetric", "Standard", "Extended")
]


@pytest.mark.parametrize("newton_type,step_solver_type", _NEWTON_CASES)
def test_newton_step_solver_sweep_matches_jax(newton_type, step_solver_type):
    """``tests/test_solver.py::test_newton_step_solver_sweep`` on Tame: 7/7
    in both packages."""
    jprob, tprob = _problems("Tame")
    jr, tr = solve_both(
        jprob, tprob, np.zeros(2), np.zeros(1), newton_type=newton_type, step_solver_type=step_solver_type
    )
    assert (jr.status.name, jr.iterations, jr.num_accepted_steps) == ("Optimal", 7, 7)
    assert_same_solve(tr, jr)


@pytest.fixture(scope="module")
def hs71_state():
    """Both packages at one HS71 iterate made from a seed, with a mixed
    active set at lambda = 2."""
    jprob, tprob = _problems("HS71")
    jp, tp = params_pair()
    jfns, tfns = j_make_fns(jprob, jp), make_fns(tprob, tp)
    rng = np.random.default_rng(4)
    x = np.array([1.0, 4.0, 5.0, 1.2, 0.3]) + 0.1 * rng.standard_normal(5)
    y = rng.standard_normal(2)
    j_it = j_iter.evaluate_iterate(jfns, jnp.asarray(x), jnp.asarray(y))
    t_it = t_iter.evaluate_iterate(tfns, tensor(x), tensor(y))
    return dict(jprob=jprob, tprob=tprob, jfns=jfns, tfns=tfns, j_it=j_it, t_it=t_it, x=x, y=y)


def _funcs(state, scaled, lamb=2.0):
    lb, ub = state["tprob"].var_lb, state["tprob"].var_ub
    jfunc = j_impl.make_step_func(state["j_it"], lamb, jnp.asarray(lb), jnp.asarray(ub), scaled=scaled)
    tfunc = t_impl.make_step_func(state["t_it"], lamb, tensor(lb), tensor(ub), scaled=scaled)
    return jfunc, tfunc


@pytest.mark.parametrize("scaled", [False, True], ids=["unscaled", "scaled"])
def test_deriv_matches_jax(hs71_state, scaled):
    """The dense Newton matrix, elementwise, with the active rows reduced
    to the identity's (scaled: lambda's)."""
    jfunc, tfunc = _funcs(hs71_state, scaled)
    rho = 0.5
    active = np.array([True, False, False, True, False])
    jh = j_iter.aug_lag_deriv_xx(hs71_state["jfns"], hs71_state["j_it"], rho)
    th = t_iter.aug_lag_deriv_xx(hs71_state["tfns"], hs71_state["t_it"], rho)
    K = t_impl.deriv(tfunc, hs71_state["t_it"].cons_jac, th, torch.tensor(active))
    ref = j_impl.deriv(jfunc, hs71_state["j_it"].cons_jac, jh, jnp.asarray(active))
    np.testing.assert_allclose(numpy(K), np.asarray(ref), rtol=EXACT, atol=EXACT)
    for j in (0, 3):
        expect = np.zeros(7)
        expect[j] = 2.0 if scaled else 1.0
        np.testing.assert_array_equal(numpy(K[j]), expect)


@pytest.mark.parametrize("scaled", [False, True], ids=["unscaled", "scaled"])
@pytest.mark.parametrize("tau", [None, 0.05, 1.0])
def test_tau_projection_matches_jax(hs71_state, scaled, tau):
    """``projection_initial`` and ``compute_active_set`` with and without
    tau, at a point away from the step origin."""
    jfunc, tfunc = _funcs(hs71_state, scaled)
    rng = np.random.default_rng(5)
    x = hs71_state["x"] + 0.5 * rng.standard_normal(5)
    y = hs71_state["y"] + 0.1 * rng.standard_normal(2)
    j_cur = j_iter.evaluate_iterate(hs71_state["jfns"], jnp.asarray(x), jnp.asarray(y))
    t_cur = t_iter.evaluate_iterate(hs71_state["tfns"], tensor(x), tensor(y))
    rho = 0.3
    p = t_impl.projection_initial(tfunc, t_cur, rho, tau)
    np.testing.assert_allclose(numpy(p), np.asarray(j_impl.projection_initial(jfunc, j_cur, rho, tau)), rtol=EXACT, atol=EXACT)
    np.testing.assert_array_equal(
        numpy(t_impl.compute_active_set(tfunc, t_cur, rho, tau)),
        np.asarray(j_impl.compute_active_set(jfunc, j_cur, rho, tau)),
    )


def test_tau_projection_of_lanes_equals_single(hs71_state):
    """A (B,) tau and lambda on a lane stack give each lane its single
    projection."""
    tfns = hs71_state["tfns"]
    lb, ub = tensor(hs71_state["tprob"].var_lb), tensor(hs71_state["tprob"].var_ub)
    rng = np.random.default_rng(6)
    xs = hs71_state["x"] + 0.3 * rng.standard_normal((3, 5))
    ys = np.tile(hs71_state["y"], (3, 1))
    from pygradflow_torch.eval import lane_fns

    lanes = t_iter.evaluate_iterate(lane_fns(tfns), tensor(xs), tensor(ys))
    lamb, tau = tensor([2.0, 0.5, 8.0]), tensor([0.1, 1.0, 0.02])
    p = t_impl.projection_initial(t_impl.make_step_func(lanes, lamb, lb, ub), lanes, 0.3, tau)
    for i in range(3):
        one = t_iter.evaluate_iterate(tfns, tensor(xs[i]), tensor(ys[i]))
        func = t_impl.make_step_func(one, float(lamb[i]), lb, ub)
        torch.testing.assert_close(p[i], t_impl.projection_initial(func, one, 0.3, float(tau[i])), rtol=1e-15, atol=1e-15)


def test_active_set_from_iterate_matches_jax():
    """``tests/test_newton.py::test_active_set_from_iterate``: pinned by the
    gradient's sign at the bounds."""
    from pygradflow_tpu.newton import active_set_from_iterate as j_active_set_from_iterate

    for c, expect in (([-1.0, 0.5, 2.0], [True, False, True]), ([1.0, 0.5, -1.0], [False, False, False])):
        jprob, tprob = _problems("BoundedQuad", np.array(c))
        x = np.array([0.0, 0.5, 1.0])
        j_it = j_iter.evaluate_iterate(j_make_fns(jprob, pygradflow_tpu.Params()), jnp.asarray(x), jnp.zeros(0))
        t_fns = make_fns(tprob, pygradflow_torch.Params())
        t_it = t_iter.evaluate_iterate(t_fns, tensor(x), tensor(np.zeros(0)))
        ours = active_set_from_iterate(t_fns, t_it, tensor(tprob.var_lb), tensor(tprob.var_ub))
        ref = j_active_set_from_iterate(None, j_it, jnp.asarray(jprob.var_lb), jnp.asarray(jprob.var_ub))
        np.testing.assert_array_equal(numpy(ours), np.asarray(ref))
        np.testing.assert_array_equal(numpy(ours), expect)


@pytest.mark.parametrize("given", [True, False], ids=["given", "derived"])
def test_fixed_active_set_matches_jax(given):
    """``tests/test_newton.py``: HS71 with the optimum's active set pinned
    (x1 at its lower bound and the slack at 0), or derived from each step
    origin."""
    jprob, tprob = _problems("HS71")
    fixed = np.array([True, False, False, False, True]) if given else None
    jr, tr = solve_both(jprob, tprob, HS71_X0, np.zeros(2), newton_type="FixedActiveSet", fixed_active_set=fixed)
    assert jr.status.name == "Optimal"
    assert_same_solve(tr, jr)


@pytest.mark.parametrize(
    "bad,match",
    [(np.array([True, False]), "shape"), (np.array([1, 0, 0, 0, 1]), "bool")],
    ids=["shape", "dtype"],
)
def test_fixed_active_set_validates(bad, match):
    """A pin mask of the wrong shape or dtype raises in both packages."""
    jprob, tprob = _problems("HS71")
    jp, tp = params_pair(newton_type="FixedActiveSet", fixed_active_set=bad)
    with pytest.raises(ValueError, match=match):
        pygradflow_tpu.Solver(jprob, jp).solve(HS71_X0, np.zeros(2))
    with pytest.raises(ValueError, match=match):
        pygradflow_torch.Solver(tprob, tp, device="cpu").solve(tensor(HS71_X0), tensor(np.zeros(2)))


@pytest.mark.parametrize("newton_type", ["Simplified", "Full", "ActiveSet", "Globalized"])
def test_one_step_near_identity(newton_type):
    """``tests/test_newton.py::test_one_step_near_identity``: with a huge
    lambda one Newton step drives the residual to about 0, and to the JAX
    package's step."""
    from pygradflow_tpu.newton import NewtonCfg as JNewtonCfg
    from pygradflow_tpu.newton import make_newton as j_make_newton
    from pygradflow_tpu.step.solvers import step_solver_def as j_step_solver_def

    jprob, tprob = _problems("HS71")
    jp, tp = params_pair(newton_type=newton_type)
    x0, y0 = np.array([2.0, 3.0, 3.5, 2.0, 1.0]), np.array([0.3, -0.2])
    lamb, rho = 1e8, 1.0
    fns = make_fns(tprob, tp)
    lb, ub = tensor(tprob.var_lb), tensor(tprob.var_ub)
    orig = t_iter.evaluate_iterate(fns, tensor(x0), tensor(y0))
    init, step = make_newton(NewtonCfg(fns=fns, params=tp, lb=lb, ub=ub, ssdef=step_solver_def(tp)))
    carry, counters = init(orig, lamb, rho, None, Counters.zero())
    res, _, counters = step(carry, orig, counters)
    nxt = t_iter.evaluate_iterate(fns, res.xn, res.yn)
    assert float(t_impl.value_norm(t_impl.make_step_func(orig, lamb, lb, ub, scaled=False), nxt, rho)) < 1e-8

    jfns = j_make_fns(jprob, jp)
    jlb, jub = jnp.asarray(jprob.var_lb), jnp.asarray(jprob.var_ub)
    j_orig = j_iter.evaluate_iterate(jfns, jnp.asarray(x0), jnp.asarray(y0))
    jinit, jstep = j_make_newton(JNewtonCfg(fns=jfns, params=jp, lb=jlb, ub=jub, ssdef=j_step_solver_def(jp)))
    from pygradflow_tpu.eval import Counters as JCounters

    jcarry, jcounters = jinit(j_orig, lamb, rho, None, JCounters.zero())
    jres, _, jcounters = jstep(jcarry, j_orig, jcounters)
    np.testing.assert_allclose(numpy(res.xn), np.asarray(jres.xn), rtol=0, atol=1e-12)
    np.testing.assert_allclose(numpy(res.yn), np.asarray(jres.yn), rtol=0, atol=1e-12)
    assert list(counters) == [int(c) for c in jcounters]


def _boxed_qp(kind):
    """``tests/test_qp.py::_boxed_qp`` for the package ``kind``."""
    from tests.test_qp import _boxed_qp as j_boxed_qp

    jprob, lb = j_boxed_qp()
    if kind == "jax":
        return jprob, lb
    return QuadraticProblem(np.asarray(jprob.Q), np.asarray(jprob.c), var_lb=jprob.var_lb, var_ub=jprob.var_ub), lb


@pytest.mark.parametrize(
    "newton_type,linear_solver_type,counts",
    [("ActiveSet", "LU", (4, 4)), ("Full", "LU", (4, 4)), ("ActiveSet", "PallasLDLT", (4, 4))],
)
def test_boxed_qp_newton_types_match_jax(newton_type, linear_solver_type, counts):
    """``tests/test_qp.py::test_newton_types_qp``: the boxed Laplacian QP at
    n = 49 with ``lamb_init=1e-12``; on PallasLDLT through B1's plain
    version."""
    jprob, lb = _boxed_qp("jax")
    tprob, _ = _boxed_qp("torch")
    jr, tr = solve_both(
        jprob, tprob, np.maximum(lb, 0.0),
        lamb_init=1e-12, iteration_limit=1000, newton_type=newton_type, linear_solver_type=linear_solver_type,
    )
    assert jr.status.name == "Optimal" and (jr.iterations, jr.num_accepted_steps) == counts
    assert_same_solve(tr, jr, PALLAS_TOL if linear_solver_type == "PallasLDLT" else 1e-8)
    assert tr.final_stat_res < 1e-6


def test_boxed_qp_simplified_newton_matches_jax():
    """The same QP under Simplified Newton: Optimal in both packages, x
    within 1e-8, ``final_stat_res`` below 1e-6, as the JAX test asserts.
    The counts are not compared: from outer iteration 69 on the steps solve
    systems so ill-conditioned at lambda near ``lamb_init`` that the
    roundings of two LU implementations move a rejected candidate by 0.2,
    and an accepted one at iteration 77 by 1e-5, after which the paths
    differ (the JAX package alone gives 147/41 through LU and 124/42
    through LDLT; the port 140/42 through LU)."""
    jprob, lb = _boxed_qp("jax")
    tprob, _ = _boxed_qp("torch")
    jr, tr = solve_both(
        jprob, tprob, np.maximum(lb, 0.0), lamb_init=1e-12, iteration_limit=1000, newton_type="Simplified"
    )
    assert jr.status.name == tr.status.name == "Optimal"
    np.testing.assert_allclose(numpy(tr.x), jr.x, rtol=0, atol=1e-8)
    assert tr.final_stat_res < 1e-6


@pytest.mark.parametrize(
    "kwargs,counts",
    [
        (dict(newton_type="Full"), ("Optimal", 16, 14)),
        (dict(newton_type="ActiveSet"), ("Optimal", 16, 14)),
        (dict(newton_type="Globalized", iteration_limit=50), ("IterationLimit", 50, 23)),
    ],
    ids=["Full", "ActiveSet", "Globalized"],
)
def test_pendulum_newton_types_on_pallas_match_jax(kwargs, counts):
    """The pendulum at N = 16 on PallasLDLT (KKT 84, B1's plain version),
    as chip_smoke phase 8 (a) runs it at N = 128.  Globalized keeps the
    reference's defect (direction from the origin's residual, matrix from
    the iterate) and stops at the iteration limit."""
    x0 = JPendulum(N=16).x0_trajectory()
    jr, tr = solve_both(JPendulum(N=16), TPendulum(N=16), x0, **dict(ANCHOR, **kwargs))
    assert (jr.status.name, jr.iterations, jr.num_accepted_steps) == counts
    if counts[0] == "Optimal":
        assert_same_solve(tr, jr, PALLAS_TOL)
    else:  # an unfinished path: the counts, and x to the tier's tolerance
        assert (tr.status.name, tr.iterations, tr.num_accepted_steps) == counts
        np.testing.assert_allclose(numpy(tr.x), jr.x, rtol=0, atol=PALLAS_TOL)


def _exact_solver():
    from pygradflow_torch.linalg import LinearSolver

    def solve(mat, rhs, initial_sol=None):
        return torch.linalg.solve(mat, rhs)

    return LinearSolver(lambda mat: mat, solve, solve, None, "exact")


def _exact_jax_solver():
    from pygradflow_tpu.linalg import LinearSolver as JLinearSolver

    def solve(mat, rhs, initial_sol=None):
        return jnp.linalg.solve(mat, rhs)

    return JLinearSolver(lambda mat: mat, solve, solve, None, "exact")


@pytest.mark.parametrize("formulation", ["standard", "asymmetric"])
def test_step_formulations_match_jax(hs71_state, formulation):
    """Standard and Asymmetric assembly and solve at one state, with an f64
    dense solve on both sides: the assembled matrix and the step."""
    from pygradflow_torch.step import solvers as t_solvers
    from pygradflow_tpu.step import solvers as j_solvers

    scaled = formulation == "asymmetric"
    jfunc, tfunc = _funcs(hs71_state, scaled)
    rho = 0.4
    j_ssdef = getattr(j_solvers, f"_{formulation}_def")(_exact_jax_solver(), False)
    t_ssdef = getattr(t_solvers, f"_{formulation}_def")(_exact_solver())
    h_rho = rho if formulation == "standard" else 0.0
    jh = j_iter.aug_lag_deriv_xx(hs71_state["jfns"], hs71_state["j_it"], h_rho)
    th = t_iter.aug_lag_deriv_xx(hs71_state["tfns"], hs71_state["t_it"], h_rho)
    active = np.array([True, False, False, True, False])
    j_active, t_active = jnp.asarray(active), torch.tensor(active)
    jf = j_ssdef.factor(jfunc, jh, hs71_state["j_it"].cons_jac, j_active, rho)
    tf = t_ssdef.factor(tfunc, th, hs71_state["t_it"].cons_jac, t_active, rho)
    np.testing.assert_allclose(numpy(tf.fact), np.asarray(jf.fact), rtol=EXACT, atol=EXACT)  # the matrix
    jdx, jdy = j_ssdef.solve(jf, jfunc, hs71_state["j_it"], rho)
    tdx, tdy = t_ssdef.solve(tf, tfunc, hs71_state["t_it"], rho)
    np.testing.assert_allclose(numpy(tdx), np.asarray(jdx), rtol=EXACT, atol=EXACT)
    np.testing.assert_allclose(numpy(tdy), np.asarray(jdy), rtol=EXACT, atol=EXACT)


@pytest.mark.parametrize("newton_type", ["Globalized", "FixedActiveSet", "Full"])
def test_batched_newton_types_match_jax_and_single(newton_type):
    """Three perturbed HS71 lanes in ``BatchedSolver``: Globalized's line
    search runs until the last lane is done, and a finished lane keeps its
    step and counts; each lane against the JAX lane and the single
    ``Solver``."""
    from pygradflow_torch.parallel import BatchedSolver
    from pygradflow_tpu.parallel import BatchedSolver as JBatchedSolver

    from .test_torch_batch import _check_lanes, _check_single

    jprob, tprob = _problems("HS71")
    x0s = np.tile(HS71_X0, (3, 1))
    x0s[1, 1], x0s[2, 2] = 4.0, 4.5
    y0s = np.zeros((3, 2))
    # Globalized stalls on HS71 (PARITY.md): 20 iterations of it
    limit = 20 if newton_type == "Globalized" else None
    jp, tp = params_pair(newton_type=newton_type, iteration_limit=limit)
    jr = JBatchedSolver(jprob, jp).solve(x0s, y0s)
    tr = BatchedSolver(tprob, tp, device="cpu").solve(x0s, y0s)
    _check_lanes(tr, jr)
    for lane in range(3):
        single = pygradflow_torch.Solver(tprob, tp, device="cpu").solve(tensor(x0s[lane]), tensor(y0s[lane]))
        _check_single(tr, lane, single)
