"""The port's ``FuncProblem``, ``QuadraticProblem`` and power-of-2 scaling
against the JAX package: the scaling weights integer for integer, the
scaled problem's evaluations, ``ldexp`` bit for bit against numpy, and the
scaled solves of ``tests/test_scale.py`` with equal status, counts and
evaluation counts, x, y and d within 1e-8."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygradflow_torch
import pygradflow_tpu
from pygradflow_torch import convert
from pygradflow_torch.problem import FuncProblem, QuadraticProblem
from pygradflow_torch.scale import ScaledProblem, Scaling, scale_symmetric
from pygradflow_tpu.problem import FuncProblem as JFuncProblem
from pygradflow_tpu.problem import QuadraticProblem as JQuadraticProblem
from pygradflow_tpu.scale import ScaledProblem as JScaledProblem
from pygradflow_tpu.scale import Scaling as JScaling
from pygradflow_tpu.scale import scale_symmetric as j_scale_symmetric

from .torch_parity import assert_same_solve, ldexp_pairs, numpy, params_pair, solve_both, tensor

HS71C_X0 = np.array([1.0, 5.0, 5.0, 1.0])


def _problems(name):
    import tests.problems as jprob

    from . import torch_parity as tprob

    return getattr(jprob, name)(), getattr(tprob, name)()


def test_ldexp_equals_numpy_bit_for_bit():
    from pygradflow_torch.scale import _DeviceWeights, ldexp

    x, e = ldexp_pairs()
    with np.errstate(over="ignore"):
        ref = np.ldexp(x, e)
    ours = ldexp(torch.tensor(x), _DeviceWeights(e)).numpy()
    np.testing.assert_array_equal(ours.view(np.int64), ref.view(np.int64))


def test_scaling_round_trips_are_exact():
    scaling = Scaling(np.array([3, -2, 0, 7]), np.array([-1, 4]), obj_weight=2)
    x = torch.tensor([1.234, -5.5, 0.125, 3.25], dtype=torch.float64)
    y = torch.tensor([0.7, -0.3], dtype=torch.float64)
    assert torch.equal(scaling.unscale_primal(scaling.scale_primal(x)), x)
    assert torch.equal(scaling.unscale_dual(scaling.scale_dual(y)), y)
    assert torch.equal(scaling.unscale_bounds_dual(scaling.scale_bounds_dual(x)), x)
    zero = Scaling.zero(4, 2)
    assert torch.equal(zero.scale_primal(x), x) and torch.equal(zero.scale_dual(y), y)


def test_scaling_maps_match_jax():
    """Every scale and unscale map against the JAX package's, bit for bit."""
    jsc = JScaling(np.array([3, -2, 0, 7]), np.array([-1, 4]), obj_weight=2)
    tsc = convert.scaling_from_jax(jsc)
    rng = np.random.default_rng(3)
    x, y = rng.standard_normal(4), rng.standard_normal(2)
    for name, v in [
        ("scale_primal", x), ("unscale_primal", x), ("scale_dual", y),
        ("unscale_dual", y), ("scale_bounds_dual", x), ("unscale_bounds_dual", x),
    ]:
        np.testing.assert_array_equal(numpy(getattr(tsc, name)(tensor(v))), np.asarray(getattr(jsc, name)(jnp.asarray(v))))


def test_scale_symmetric_matches_jax():
    rng = np.random.default_rng(0)
    A = rng.standard_normal((6, 6))
    A = A + A.T + np.diag([1e4, 1e-3, 1.0, 50.0, 2e-6, 3.0])
    D = scale_symmetric(np.abs(A))
    np.testing.assert_array_equal(D, j_scale_symmetric(np.abs(A)))
    norms = np.sqrt(np.ldexp(np.abs(A), D[:, None] + D[None, :]).sum(axis=0))
    assert (norms <= 2.0 + 1e-12).all()


@pytest.mark.parametrize("scaling_type", ["Nominal", "GradJac", "KKT"])
def test_scaling_weights_match_jax(scaling_type):
    """The weights that ``create_scaling`` computes at the start point,
    integer for integer."""
    from pygradflow_torch.scale import create_scaling
    from pygradflow_tpu.scale import create_scaling as j_create_scaling

    jprob, tprob = _problems("HS71Constrained")
    kwargs = dict(scaling_type=scaling_type, scaling_primal=HS71C_X0, scaling_dual=np.array([1.0, 1.0]))
    jp, tp = params_pair(**kwargs)
    js = j_create_scaling(jprob, jp, jp.scaling_primal, jp.scaling_dual)
    ts = create_scaling(tprob, tp, tp.scaling_primal, tp.scaling_dual)
    np.testing.assert_array_equal(ts.var_weights, js.var_weights)
    np.testing.assert_array_equal(ts.cons_weights, js.cons_weights)
    assert ts.obj_weight == js.obj_weight
    assert ts.var_weights.dtype.kind == ts.cons_weights.dtype.kind == "i"


def test_scaled_problem_evaluations_match_jax():
    """The scaled problem's evaluations against the JAX package's, and its
    explicit gradient and Jacobian against autodiff of its own functions."""
    jprob, tprob = _problems("HS71Constrained")
    w = (np.array([1, -1, 2, 0]), np.array([1, -2]))
    js = JScaledProblem(jprob, JScaling(*w, obj_weight=1))
    ts = ScaledProblem(tprob, Scaling(*w, obj_weight=1))
    for attr in ("var_lb", "var_ub", "cons_lb", "cons_ub"):
        np.testing.assert_array_equal(getattr(ts, attr), getattr(js, attr))
    x = np.ldexp(np.array([1.5, 4.0, 3.3, 1.9]), w[0])
    y = np.array([0.3, -0.7])
    for name in ("obj", "obj_grad", "cons", "cons_jac"):
        np.testing.assert_allclose(numpy(getattr(ts, name)(tensor(x))), getattr(js, name)(jnp.asarray(x)), rtol=1e-14)
    np.testing.assert_allclose(
        numpy(ts.lag_hess(tensor(x), tensor(y))), js.lag_hess(jnp.asarray(x), jnp.asarray(y)), rtol=1e-13
    )
    from torch.func import grad, jacfwd

    torch.testing.assert_close(grad(ts.obj)(tensor(x)), ts.obj_grad(tensor(x)), rtol=1e-12, atol=0)
    torch.testing.assert_close(jacfwd(ts.cons)(tensor(x)), ts.cons_jac(tensor(x)), rtol=1e-12, atol=0)
    # the products of the matrix-free tier, by autodiff through the scaling
    v, w = tensor(np.array([0.3, -1.0, 2.0, 0.5])), tensor(y)
    torch.testing.assert_close(ts.cons_vjp(tensor(x), w), ts.cons_jac(tensor(x)).T @ w, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(
        ts.lag_hvp(tensor(x), w, v), ts.lag_hess(tensor(x), w) @ v, rtol=1e-12, atol=1e-12
    )


@pytest.mark.parametrize("scaling_type", ["Nominal", "GradJac", "KKT"])
def test_scaled_solve_matches_jax(scaling_type):
    """``tests/test_scale.py::test_scaled_solve``: the constrained HS71 (slacks
    and a shifted equality) under each computed scaling."""
    jprob, tprob = _problems("HS71Constrained")
    jr, tr = solve_both(
        jprob, tprob, HS71C_X0, np.zeros(2),
        scaling_type=scaling_type, scaling_primal=HS71C_X0, scaling_dual=np.array([1.0, 1.0]),
    )
    assert jr.status == pygradflow_tpu.SolverStatus.Optimal
    assert_same_solve(tr, jr)


def test_custom_scaling_matches_jax():
    """A given ``Scaling`` on Rosenbrock; the JAX one reaches the port
    through ``params_from_jax``."""
    jprob, tprob = _problems("Rosenbrock")
    jp = pygradflow_tpu.Params(
        scaling_type=pygradflow_tpu.ScalingType.Custom,
        scaling=JScaling(np.array([2, -1]), np.zeros(0, dtype=int)),
    )
    tp = convert.params_from_jax(jp)
    assert isinstance(tp.scaling, Scaling)
    np.testing.assert_array_equal(tp.scaling.var_weights, [2, -1])
    jr, tr = solve_both(jprob, tprob, np.zeros(2), jparams=jp, tparams=tp)
    assert jr.status == pygradflow_tpu.SolverStatus.Optimal
    assert_same_solve(tr, jr)


def test_custom_scaling_needs_its_type():
    _, tprob = _problems("Rosenbrock")
    tp = pygradflow_torch.Params(scaling=Scaling(np.array([2, -1]), np.zeros(0, dtype=int)))
    with pytest.raises(ValueError, match="Custom"):
        pygradflow_torch.Solver(tprob, tp, device="cpu")
    with pytest.raises(ValueError, match="explicit scaling"):
        pygradflow_torch.Solver(tprob, pygradflow_torch.Params(scaling_type="Custom"), device="cpu")


def test_step_solver_injection_matches_jax():
    """``params.step_solver``: each package gets its own factory of the
    Symmetric definition over LU, counting its factorizations."""
    from pygradflow_torch.linalg import linear_solver
    from pygradflow_torch.step.solvers import _symmetric_def
    from pygradflow_tpu.linalg import linear_solver as j_linear_solver
    from pygradflow_tpu.step.solvers import _symmetric_def as j_symmetric_def

    calls = {"jax": 0, "torch": 0}

    def counting(base, key):
        def factor(*args):
            calls[key] += 1
            return base.factor(*args)

        return base._replace(factor=factor)

    jp = pygradflow_tpu.Params(
        step_solver=lambda p: counting(
            j_symmetric_def(j_linear_solver(pygradflow_tpu.LinearSolverType.LU, symmetric=True), False, False), "jax"
        )
    )
    tp = pygradflow_torch.Params(
        step_solver=lambda p: counting(
            _symmetric_def(linear_solver(pygradflow_torch.LinearSolverType.LU, symmetric=True), False), "torch"
        )
    )
    jprob, tprob = _problems("Rosenbrock")
    jr, tr = solve_both(jprob, tprob, np.zeros(2), jparams=jp, tparams=tp)
    assert_same_solve(tr, jr)
    assert calls["torch"] == tr.iterations  # one factor per outer iteration
    assert calls["jax"] > 0  # at trace time


def test_params_from_jax_leaves_callables_out():
    jp = pygradflow_tpu.Params(step_solver=lambda p: None, active_set_method=lambda it, lamb, rho: 0.5)
    tp = convert.params_from_jax(jp)
    assert tp.step_solver is None and tp.active_set_method is None


def test_func_problem_matches_jax():
    """``tests/test_solver.py::test_func_problem_api``."""
    jprob = JFuncProblem(
        np.full(2, -np.inf), np.full(2, np.inf),
        obj=lambda v: (1.0 - v[0]) ** 2 + 100.0 * (v[1] - v[0] ** 2) ** 2,
    )
    tprob = FuncProblem(
        np.full(2, -np.inf), np.full(2, np.inf),
        obj=lambda v: (1.0 - v[0]) ** 2 + 100.0 * (v[1] - v[0] ** 2) ** 2,
    )
    jr, tr = solve_both(jprob, tprob, np.zeros(2))
    assert tr.status.name == "Optimal"
    assert_same_solve(tr, jr)
    np.testing.assert_allclose(numpy(tr.x), [1.0, 1.0], atol=1e-5)


def test_func_problem_with_constraints_matches_jax():
    """The constrained HS71 written as two plain functions."""

    def jcons(x):
        return jnp.array([jnp.prod(x), jnp.dot(x, x)])

    def tcons(x):
        return torch.stack([torch.prod(x), torch.dot(x, x)])

    def obj(x):
        return x[0] * x[3] * (x[0] + x[1] + x[2]) + x[2]

    bounds = dict(cons_lb=np.array([25.0, 40.0]), cons_ub=np.array([np.inf, 40.0]))
    jprob = JFuncProblem(np.ones(4), np.full(4, 5.0), obj=obj, cons=jcons, **bounds)
    tprob = FuncProblem(np.ones(4), np.full(4, 5.0), obj=obj, cons=tcons, **bounds)
    jr, tr = solve_both(jprob, tprob, HS71C_X0, np.zeros(2))
    assert_same_solve(tr, jr)


def _random_qp(seed, n=6, m=3):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((n, n))
    Q = h @ h.T + np.eye(n)
    c = rng.standard_normal(n)
    A = rng.standard_normal((m, n))
    cons_lb = np.array([-1.0, 0.5, -np.inf])
    cons_ub = np.array([1.0, 0.5, 2.0])
    return dict(Q=Q, c=c, A=A, cons_lb=cons_lb, cons_ub=cons_ub, var_lb=-np.ones(n), var_ub=np.full(n, np.inf))


def test_quadratic_problem_evaluations_match_jax():
    """Objective, gradient, constraints, Jacobian and Hessian of a random QP
    with ranged, equality and one-sided rows, against the JAX package's."""
    data = _random_qp(5)
    jq = JQuadraticProblem(**data)
    tq = QuadraticProblem(**{k: (torch.tensor(v) if k in ("Q", "A") else v) for k, v in data.items()})
    assert isinstance(tq.Q, torch.Tensor) and tq.Q.dtype == torch.float64
    for attr in ("var_lb", "var_ub", "cons_lb", "cons_ub"):
        np.testing.assert_array_equal(getattr(tq, attr), getattr(jq, attr))
    rng = np.random.default_rng(6)
    x, y = rng.standard_normal(6), rng.standard_normal(3)
    for name in ("obj", "obj_grad", "cons", "cons_jac"):
        np.testing.assert_allclose(numpy(getattr(tq, name)(tensor(x))), getattr(jq, name)(jnp.asarray(x)), rtol=1e-13)
    np.testing.assert_allclose(numpy(tq.lag_hess(tensor(x), tensor(y))), jq.lag_hess(jnp.asarray(x), jnp.asarray(y)))


def test_quadratic_problem_solve_matches_jax():
    data = _random_qp(5)
    jr, tr = solve_both(JQuadraticProblem(**data), QuadraticProblem(**data), np.zeros(6))
    assert jr.status == pygradflow_tpu.SolverStatus.Optimal
    assert_same_solve(tr, jr)


def test_quadratic_problem_in_a_batch_matches_single():
    """``BatchedSolver`` lanes of a QP (its Hessian and Jacobian the same on
    every lane under ``torch.func.vmap``) against the single ``Solver``."""
    from pygradflow_torch.parallel import BatchedSolver

    from .test_torch_batch import _check_single

    data = _random_qp(5)
    x0s = np.random.default_rng(8).uniform(0.0, 1.0, size=(3, 6))
    tp = pygradflow_torch.Params()
    tr = BatchedSolver(QuadraticProblem(**data), tp, device="cpu").solve(x0s)
    for lane in range(3):
        single = pygradflow_torch.Solver(QuadraticProblem(**data), tp, device="cpu").solve(tensor(x0s[lane]))
        _check_single(tr, lane, single)


def test_scaled_batch_matches_jax_and_single():
    """GradJac scaling in ``BatchedSolver``: start points scaled in
    ``_initial``, solutions unscaled in ``finalize``, each lane against the
    JAX lane and the port's single ``Solver``."""
    from pygradflow_torch.parallel import BatchedSolver
    from pygradflow_tpu.parallel import BatchedSolver as JBatchedSolver

    from .test_torch_batch import _check_lanes, _check_single

    jprob, tprob = _problems("HS71Constrained")
    x0s = np.tile(HS71C_X0, (3, 1))
    x0s[1, 1], x0s[2, 2] = 4.5, 4.0
    y0s = np.zeros((3, 2))
    jp, tp = params_pair(scaling_type="GradJac", scaling_primal=HS71C_X0)
    jr = JBatchedSolver(jprob, jp).solve(x0s, y0s)
    tr = BatchedSolver(tprob, tp, device="cpu").solve(x0s, y0s)
    _check_lanes(tr, jr)
    for lane in range(3):
        single = pygradflow_torch.Solver(tprob, tp, device="cpu").solve(tensor(x0s[lane]), tensor(y0s[lane]))
        _check_single(tr, lane, single)


def _hs_spec(name):
    from pygradflow_tpu.runners.hs import HS_BY_NAME

    return HS_BY_NAME[name]


@pytest.mark.parametrize("name", ["HS62", "HS104", "HS106"])
def test_hs_twins_match_jax(name):
    """The torch twins of hs62, hs104 and hs106 against their JAX specs at
    the start point and at seeded points inside the bounds."""
    from . import torch_parity as tprob

    spec = _hs_spec(name.lower())
    jp, tp = spec.problem(), getattr(tprob, name)()
    np.testing.assert_array_equal(tp.x0, spec.x0)
    for attr in ("var_lb", "var_ub", "cons_lb", "cons_ub"):
        np.testing.assert_array_equal(getattr(tp, attr), getattr(jp, attr))
    rng = np.random.default_rng(29)
    points = [spec.x0] + [rng.uniform(spec.var_lb, np.minimum(spec.var_ub, spec.var_lb + 10.0)) for _ in range(2)]
    for x in points:
        jx, tx = jnp.asarray(x), tensor(x)
        for fn in ("obj", "obj_grad", "cons", "cons_jac"):
            np.testing.assert_allclose(numpy(getattr(tp, fn)(tx)), getattr(jp, fn)(jx), rtol=1e-12, atol=1e-12)


def test_hs62_gradjac_matches_jax():
    """``tests/test_scale.py::test_scaling_accelerates_hs62``: GradJac scaling
    takes the badly scaled blend to its optimum in at most 30 iterations."""
    from .torch_parity import HS62

    spec = _hs_spec("hs62")
    jr, tr = solve_both(spec.problem(), HS62(), spec.x0, scaling_type="GradJac", scaling_primal=spec.x0)
    assert tr.status.name == "Optimal" and tr.iterations <= 30
    assert_same_solve(tr, jr)
    assert abs(float(HS62().obj(tr.x)) - (-26272.51448)) < 1.0


@pytest.mark.parametrize(
    "name,f_expect,f_tol",
    [
        ("HS104", 3.9511634, 1e-3),
        ("HS106", 7049.330923, 0.5),
    ],
)
def test_kkt_scaling_rescues_match_jax(name, f_expect, f_tol):
    """``tests/test_scale.py::test_scaling_rescues``: the equilibrated-KKT
    scaling solves hs104 and hs106."""
    from . import torch_parity as tprob

    spec = _hs_spec(name.lower())
    jr, tr = solve_both(
        spec.problem(), getattr(tprob, name)(), spec.x0,
        iteration_limit=2000, scaling_type="KKT", scaling_primal=spec.x0,
        scaling_dual=np.zeros(len(spec.cons_lb)),
    )
    assert tr.status.name == "Optimal"
    assert_same_solve(tr, jr)
    assert abs(float(getattr(tprob, name)().obj(tr.x)) - f_expect) < f_tol
