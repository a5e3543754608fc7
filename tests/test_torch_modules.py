"""The port's modules against the JAX package at one state of the pendulum
(N = 8) made from a seed: evaluations, KKT residuals, the implicit
function, the Symmetric step solver, and the configuration surface."""

import dataclasses
import enum
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygradflow_torch
import pygradflow_tpu
from pygradflow_torch import convert
from pygradflow_torch import implicit_func as t_impl
from pygradflow_torch import iterate as t_iter
from pygradflow_torch.linalg import LinearSolver
from pygradflow_torch.runners.control import PendulumControl as TPendulum
from pygradflow_torch.step.solvers import _symmetric_def as t_symmetric_def
from pygradflow_torch.step.solvers import step_solver_def as t_step_solver_def
from pygradflow_torch.transform import Transformation as TTransformation
from pygradflow_tpu import implicit_func as j_impl
from pygradflow_tpu import iterate as j_iter
from pygradflow_tpu.linalg import linear_solver as j_linear_solver
from pygradflow_tpu.runners.control import PendulumControl as JPendulum
from pygradflow_tpu.step.solvers import _symmetric_def as j_symmetric_def
from pygradflow_tpu.step.solvers import step_solver_def as j_step_solver_def
from pygradflow_tpu.transform import Transformation as JTransformation

from .torch_parity import ANCHOR, numpy, params_pair, tensor

EXACT = 1e-10  # f64 on both sides, sums in another order
LDLT = 1e-8  # through the f32 factor plus three f64 refinement passes
N = 8
LAMB, RHO = 2.5, 0.3


def _close(ours, ref, tol=EXACT):
    ours = numpy(ours) if torch.is_tensor(ours) else np.asarray(ours)
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def state():
    """Both packages at the same (x, y), with some controls beyond their
    bounds so that the active set is mixed."""
    rng = np.random.default_rng(5)
    jprob, tprob = JPendulum(N=N), TPendulum(N=N)
    x = jprob.x0_trajectory() + 0.1 * rng.standard_normal(jprob.num_vars)
    x[-N:] = 2.5 * np.sign(rng.standard_normal(N)) + 0.3 * rng.standard_normal(N)
    y = rng.standard_normal(jprob.num_cons)
    jp, tp = params_pair(**ANCHOR)
    jt, tt = JTransformation(jprob, jp), TTransformation(tprob, tp)
    j_it = j_iter.evaluate_iterate(jt.fns, jnp.asarray(x), jnp.asarray(y))
    t_it = t_iter.evaluate_iterate(tt.fns, tensor(x), tensor(y))
    bounds = (jprob.var_lb, jprob.var_ub)
    return dict(jt=jt, tt=tt, j_it=j_it, t_it=t_it, x=x, y=y, bounds=bounds, jp=jp, tp=tp)


def _bounds(state, kind):
    lb, ub = state["bounds"]
    if kind == "jax":
        return jnp.asarray(lb), jnp.asarray(ub)
    return tensor(lb), tensor(ub)


def test_evaluations_match(state):
    j_it, t_it = state["j_it"], state["t_it"]
    for field in j_it._fields:
        _close(getattr(t_it, field), getattr(j_it, field))
    _close(
        state["tt"].fns.lag_hess(t_it.x, t_it.y),
        state["jt"].fns.lag_hess(j_it.x, j_it.y),
    )


def test_iterate_residuals_match(state):
    j_it, t_it = state["j_it"], state["t_it"]
    jlb, jub = _bounds(state, "jax")
    tlb, tub = _bounds(state, "torch")
    tol = 1e-8
    _close(t_iter.bounds_dual(t_it, tlb, tub, tol), j_iter.bounds_dual(j_it, jlb, jub, tol))
    _close(t_iter.stat_res(t_it, tlb, tub, tol), j_iter.stat_res(j_it, jlb, jub, tol))
    _close(t_iter.total_res(t_it, tlb, tub, tol), j_iter.total_res(j_it, jlb, jub, tol))
    _close(t_iter.cons_violation(t_it), j_iter.cons_violation(j_it))
    _close(t_iter.aug_lag(t_it, RHO), j_iter.aug_lag(j_it, RHO))
    _close(t_iter.aug_lag_deriv_x(t_it, RHO), j_iter.aug_lag_deriv_x(j_it, RHO))
    for feas_tol, infeas_tol in [(1e-6, 1e-8), (1e-6, 1e6)]:
        assert bool(t_iter.locally_infeasible(t_it, tlb, tub, tol, feas_tol, infeas_tol)) == bool(
            j_iter.locally_infeasible(j_it, jlb, jub, tol, feas_tol, infeas_tol)
        )


def _perturbed(state, kind):
    """A second iterate near the first, evaluated by the package ``kind``."""
    rng = np.random.default_rng(9)
    x = state["x"] + 0.01 * rng.standard_normal(state["x"].shape)
    y = state["y"] + 0.01 * rng.standard_normal(state["y"].shape)
    if kind == "jax":
        return j_iter.evaluate_iterate(state["jt"].fns, jnp.asarray(x), jnp.asarray(y))
    return t_iter.evaluate_iterate(state["tt"].fns, tensor(x), tensor(y))


@pytest.mark.parametrize("scaled", [True, False])
def test_implicit_function_matches(state, scaled):
    jfunc = j_impl.make_step_func(state["j_it"], LAMB, *_bounds(state, "jax"), scaled=scaled)
    tfunc = t_impl.make_step_func(state["t_it"], LAMB, *_bounds(state, "torch"), scaled=scaled)
    j_cur, t_cur = _perturbed(state, "jax"), _perturbed(state, "torch")

    j_active = j_impl.compute_active_set(jfunc, j_cur, RHO)
    t_active = t_impl.compute_active_set(tfunc, t_cur, RHO)
    np.testing.assert_array_equal(numpy(t_active), np.asarray(j_active))

    for j_val, t_val in zip(j_impl.value_at(jfunc, j_cur, RHO), t_impl.value_at(tfunc, t_cur, RHO)):
        _close(t_val, j_val)
    _close(t_impl.value_norm(tfunc, t_cur, RHO), j_impl.value_norm(jfunc, j_cur, RHO))


def _exact_torch_solver():
    """f64 dense solve, a stand-in that isolates the assembly and the
    condensed right-hand side from the mixed-precision tier."""

    def solve(mat, rhs, initial_sol=None):
        return torch.linalg.solve(mat, rhs)

    return LinearSolver(lambda mat: mat, solve, solve, None, "exact")


def _step(state, j_ssdef, t_ssdef):
    j_it, t_it = state["j_it"], state["t_it"]
    jfunc = j_impl.make_step_func(j_it, LAMB, *_bounds(state, "jax"), scaled=True)
    tfunc = t_impl.make_step_func(t_it, LAMB, *_bounds(state, "torch"), scaled=True)
    j_active = j_impl.compute_active_set(jfunc, j_it, RHO)
    t_active = t_impl.compute_active_set(tfunc, t_it, RHO)
    assert 0 < int(j_active.sum()) < N  # a mixed active set
    j_h = j_iter.aug_lag_deriv_xx(state["jt"].fns, j_it, 0.0)
    t_h = t_iter.aug_lag_deriv_xx(state["tt"].fns, t_it, 0.0)
    jf = j_ssdef.factor(jfunc, j_h, j_it.cons_jac, j_active, RHO)
    tf = t_ssdef.factor(tfunc, t_h, t_it.cons_jac, t_active, RHO)
    j_cur, t_cur = _perturbed(state, "jax"), _perturbed(state, "torch")
    return jf, tf, j_ssdef.solve(jf, jfunc, j_cur, RHO), t_ssdef.solve(tf, tfunc, t_cur, RHO)


def test_symmetric_exact_step_matches(state):
    j_ssdef = j_symmetric_def(j_linear_solver(pygradflow_tpu.LinearSolverType.LU), False, False)
    t_ssdef = t_symmetric_def(_exact_torch_solver(), False)
    _, _, (jdx, jdy), (tdx, tdy) = _step(state, j_ssdef, t_ssdef)
    _close(tdx, jdx)
    _close(tdy, jdy)


def test_symmetric_step_through_ldlt_tier_matches(state):
    j_ssdef = j_step_solver_def(state["jp"])
    t_ssdef = t_step_solver_def(state["tp"])
    jf, tf, (jdx, jdy), (tdx, tdy) = _step(state, j_ssdef, t_ssdef)
    _close(tf.fact[1], jf.fact[1])  # the assembled f64 KKT matrix
    _close(tdx, jdx, LDLT)
    _close(tdy, jdy, LDLT)


def _default(field):
    return field.default_factory() if field.default is dataclasses.MISSING else field.default


def test_params_fields_and_defaults_match():
    j_fields = dataclasses.fields(pygradflow_tpu.Params)
    t_fields = dataclasses.fields(pygradflow_torch.Params)
    assert [f.name for f in t_fields] == [f.name for f in j_fields]
    for jf, tf in zip(j_fields, t_fields):
        jd, td = _default(jf), _default(tf)
        if isinstance(jd, enum.Enum):
            assert (type(td).__name__, td.name) == (type(jd).__name__, jd.name), jf.name
        else:
            assert td == jd, jf.name
    assert pygradflow_torch.Params().linear_solver_type == pygradflow_torch.LinearSolverType.LU
    assert pygradflow_torch.Params().jit_chunk == 64


def test_params_from_jax_carries_every_field():
    jp = pygradflow_tpu.Params(
        linear_solver_type="PallasLDLT",
        opt_tol=1e-7,
        newton_type=pygradflow_tpu.NewtonType.Full,
        scaling_primal=jnp.arange(3.0),
        iteration_limit=12,
    )
    tp = convert.params_from_jax(jp)
    assert tp.linear_solver_type == pygradflow_torch.LinearSolverType.PallasLDLT
    assert tp.newton_type == pygradflow_torch.NewtonType.Full
    assert (tp.opt_tol, tp.iteration_limit) == (1e-7, 12)
    np.testing.assert_array_equal(tp.scaling_primal, [0.0, 1.0, 2.0])
    assert isinstance(tp.scaling_primal, np.ndarray)
    assert tp.dtype == torch.float64


def test_import_leaves_jax_out():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = "import pygradflow_torch, sys; assert 'jax' not in sys.modules, sorted(sys.modules)"
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True, timeout=120)


@pytest.mark.parametrize(
    "kwargs,item",
    [
        (dict(ANCHOR, display=True), "A12"),
        (dict(ANCHOR, deriv_check="CheckFirst"), "A12"),
        (dict(ANCHOR, deriv_check="CheckAll"), "A12"),
        (dict(ANCHOR, precision="Single", opt_tol=1e-4, lamb_min=1e-6), "A7"),
        (
            dict(ANCHOR, precision="Single", step_control_type="BoxReduced", opt_tol=1e-4, lamb_min=1e-6,
                 iteration_limit=5),
            "A7",
        ),
    ],
)
def test_unported_configurations_raise(kwargs, item):
    """The configurations that raised naming ROADMAP A7 and A12 until they
    were ported now solve the smallest pendulum with the status and counts
    of the JAX package, in the precision asked for: to Optimal, but under
    BoxReduced in f32, which stops in neither package (IterationLimit)."""
    jp, tp = params_pair(**kwargs)
    x0 = TPendulum(N=2).x0_trajectory()
    jr = pygradflow_tpu.Solver(JPendulum(N=2), jp).solve(x0)
    tr = pygradflow_torch.Solver(TPendulum(N=2), tp, device="cpu").solve(tensor(x0))
    boxed = kwargs.get("step_control_type") == "BoxReduced"
    assert tr.status.name == jr.status.name == ("IterationLimit" if boxed else "Optimal")
    assert (tr.iterations, tr.num_accepted_steps) == (jr.iterations, jr.num_accepted_steps)
    assert tr.x.dtype == tp.dtype


def test_checkpointing_raises(tmp_path):
    """Checkpointing, which raised until it was ported, resumes the
    smallest pendulum bit for bit."""
    _, tp = params_pair(**ANCHOR)
    x0 = tensor(TPendulum(N=2).x0_trajectory())
    path = str(tmp_path / "state.npz")
    full = pygradflow_torch.Solver(TPendulum(N=2), tp, device="cpu").solve(x0)
    cut = dataclasses.replace(tp, jit_chunk=2, iteration_limit=4)
    pygradflow_torch.Solver(TPendulum(N=2), cut, device="cpu").solve(x0, checkpoint_path=path)
    resumed = pygradflow_torch.Solver(TPendulum(N=2), dataclasses.replace(tp, jit_chunk=2), device="cpu").solve(
        x0, checkpoint_path=path, resume=True
    )
    assert (resumed.iterations, resumed.num_accepted_steps) == (full.iterations, full.num_accepted_steps)
    assert torch.equal(resumed.x, full.x)


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(ANCHOR, report_rcond=True),
        dict(ANCHOR, step_control_type="BoxReduced"),
        dict(ANCHOR, step_control_type="Optimizing"),
        dict(linear_solver_type="MINRES", step_solver_type="Symmetric"),
        dict(linear_solver_type="GMRES"),
        dict(ANCHOR, collect_path=True),
    ],
    ids=["report_rcond", "BoxReduced", "Optimizing", "MINRES", "GMRES", "collect_path"],
)
def test_formerly_unported_configurations_solve(kwargs):
    """The options of ROADMAP A4, A6, A8 and A10 construct and solve the
    smallest pendulum to Optimal; Optimizing, which never stops on the
    pendulum in either package, solves Tame."""
    from .torch_parity import Tame

    _, tp = params_pair(**kwargs)
    if kwargs.get("step_control_type") == "Optimizing":
        p, x0 = Tame(), np.zeros(2)
    else:
        p = TPendulum(N=2)
        x0 = p.x0_trajectory()
    r = pygradflow_torch.Solver(p, tp, device="cpu").solve(tensor(x0))
    assert r.status.name == "Optimal"


def test_problem_products_match(state):
    """The ``torch.func`` products against the JAX autodiff ones."""
    rng = np.random.default_rng(13)
    jprob, tprob = JPendulum(N=N), TPendulum(N=N)
    x, y = state["x"], state["y"]
    v = rng.standard_normal(x.shape)
    w = rng.standard_normal(y.shape)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    tx, ty = tensor(x), tensor(y)
    _close(tprob.lag_hvp(tx, ty, tensor(v)), jprob.lag_hvp(jx, jy, jnp.asarray(v)))
    _close(tprob.cons_vjp(tx, tensor(w)), jprob.cons_vjp(jx, jnp.asarray(w)))
    _close(tprob.cons_jvp(tx, tensor(v)), jprob.cons_jvp(jx, jnp.asarray(v)))


def test_slack_transform_matches():
    """Ranged and shifted equality constraints through ``ConstrainedProblem``."""
    from pygradflow_torch.cons_problem import ConstrainedProblem as TConstrained
    from pygradflow_tpu.cons_problem import ConstrainedProblem as JConstrained
    from tests.problems import HS71Constrained as JHS71Constrained

    from .torch_parity import HS71Constrained

    jc, tc = JConstrained(JHS71Constrained()), TConstrained(HS71Constrained())
    np.testing.assert_array_equal(tc.var_lb, jc.var_lb)
    np.testing.assert_array_equal(tc.var_ub, jc.var_ub)
    rng = np.random.default_rng(17)
    x0 = 1.0 + 4.0 * rng.random(4)
    y = rng.standard_normal(2)
    jx, jyy = jc.transform_sol(jnp.asarray(x0), jnp.asarray(y))
    tx, tyy = tc.transform_sol(tensor(x0), tensor(y))
    _close(tx, jx)
    x = np.asarray(jx) + 0.1 * rng.standard_normal(5)
    for name in ("obj", "obj_grad", "cons", "cons_jac"):
        _close(getattr(tc, name)(tensor(x)), getattr(jc, name)(jnp.asarray(x)))
    _close(tc.lag_hess(tensor(x), tensor(y)), jc.lag_hess(jnp.asarray(x), jnp.asarray(y)))
    d = rng.standard_normal(5)
    for ours, ref in zip(
        tc.restore_sol(tensor(x), tensor(y), tensor(d)),
        jc.restore_sol(jnp.asarray(x), jnp.asarray(y), jnp.asarray(d)),
    ):
        _close(ours, ref)


def test_log_controller_matches():
    from pygradflow_torch.controller import ControllerSettings as TSettings
    from pygradflow_torch.controller import LogController as TLog
    from pygradflow_tpu.controller import ControllerSettings as JSettings
    from pygradflow_tpu.controller import LogController as JLog

    jp, tp = params_pair()
    jc = JLog(JSettings.from_params(jp), 0.5)
    tc = TLog(TSettings.from_params(tp), 0.5)
    for theta in (0.9, 0.1, 0.5, 2.0):
        assert tc.update(theta) == jc.update(theta)
    assert tc.error_sum == jc.error_sum


def test_params_yaml_round_trip(tmp_path):
    tp = convert.params_from_jax(
        pygradflow_tpu.Params(linear_solver_type="PallasLDLT", scaling_primal=np.arange(3.0))
    )
    path = tmp_path / "params.yaml"
    tp.write(path)
    back = pygradflow_torch.Params.read(path)
    assert back.linear_solver_type == pygradflow_torch.LinearSolverType.PallasLDLT
    assert list(back.scaling_primal) == [0.0, 1.0, 2.0]
    assert back.time_limit == tp.time_limit


def test_diagnose_eval_failure_matches(state):
    """Both packages name the same component at a point where the
    constraints are not finite, and none at a finite point."""
    from pygradflow_torch.eval import diagnose_eval_failure as t_diagnose
    from pygradflow_tpu.eval import diagnose_eval_failure as j_diagnose

    class JBad(JPendulum):
        def cons(self, z):
            return super().cons(z) / (z[0] - 7.0)

    class TBad(TPendulum):
        def cons(self, z):
            return super().cons(z) / (z[0] - 7.0)

    jt = JTransformation(JBad(N=N), state["jp"])
    tt = TTransformation(TBad(N=N), state["tp"])
    x, y = state["x"].copy(), state["y"]
    assert j_diagnose(jt.fns, x, y) is None
    assert t_diagnose(tt.fns, tensor(x), tensor(y)) is None
    x[0] = 7.0
    j_comp = j_diagnose(jt.fns, x, y)
    t_comp = t_diagnose(tt.fns, tensor(x), tensor(y))
    assert j_comp is not None and t_comp.name() == j_comp.name()


@pytest.mark.parametrize(
    "name,args",
    [
        ("Rosenbrock", ()),
        ("BoundedQuad", ([0.2, 1.5, -0.3],)),
        ("HS71", ()),
        ("HS71Constrained", ()),
        ("Tame", ()),
        ("TargetProblem", ()),
        ("LaplacianQP", (9,)),
        ("ConstrainedRosenbrock", ()),
    ],
)
def test_twin_problems_match_jax(name, args):
    """Each torch twin of ``tests/problems.py`` against its JAX original at
    seeded points inside the bounds: bounds, objective, gradient,
    constraints, Jacobian and Lagrangian Hessian."""
    import tests.problems as jprob

    from . import torch_parity as tprob

    jp, tp = getattr(jprob, name)(*args), getattr(tprob, name)(*args)
    np.testing.assert_array_equal(tp.var_lb, jp.var_lb)
    np.testing.assert_array_equal(tp.var_ub, jp.var_ub)
    np.testing.assert_array_equal(tp.cons_lb, jp.cons_lb)
    np.testing.assert_array_equal(tp.cons_ub, jp.cons_ub)
    rng = np.random.default_rng(23)
    lo = np.where(np.isfinite(jp.var_lb), jp.var_lb, -2.0)
    hi = np.where(np.isfinite(jp.var_ub), jp.var_ub, 2.0)
    for _ in range(3):
        x = rng.uniform(lo, hi)
        y = rng.standard_normal(jp.num_cons)
        jx, tx = jnp.asarray(x), tensor(x)
        _close(tp.obj(tx), jp.obj(jx))
        _close(tp.obj_grad(tx), jp.obj_grad(jx))
        _close(tp.lag_hess(tx, tensor(y)), jp.lag_hess(jx, jnp.asarray(y)))
        if jp.num_cons > 0:
            _close(tp.cons(tx), jp.cons(jx))
            _close(tp.cons_jac(tx), jp.cons_jac(jx))


_PORTED_OPTIONS = (
    [dict(newton_type=nt) for nt in ("Simplified", "Full", "ActiveSet", "Globalized", "FixedActiveSet")]
    + [dict(step_solver_type=st) for st in ("Standard", "Asymmetric", "Extended", "Symmetric")]
    + [dict(step_solver_type="Schur", schur_block_size=3)]
    + [dict(step_control_type=sc) for sc in ("DistanceRatio", "ResiduumRatio", "Exact", "Fixed")]
    + [dict(active_set_type=a) for a in ("Standard", "SmallestActiveSet", "LargestActiveSet")]
    + [dict(active_set_type="Explicit", active_set_tau=0.5)]
    + [dict(penalty_update=pu) for pu in pygradflow_torch.PenaltyUpdate.__members__]
    + [dict(scaling_type=st, scaling_primal=TPendulum(N=8).x0_trajectory(), scaling_dual=np.zeros(18)) for st in ("Nominal", "GradJac", "KKT")]
    + [dict(scaling_type="NoScaling")]
)


@pytest.mark.parametrize("kwargs", _PORTED_OPTIONS, ids=lambda kw: "-".join(str(v) for v in kw.values() if isinstance(v, str)))
def test_ported_options_build_both_loops(kwargs):
    """Every option of the discrete loop that this port holds builds the
    single and the lockstep loop on the CPU (Custom scaling is
    ``test_torch_problem_scale.py``'s)."""
    from pygradflow_torch.parallel import BatchedSolver

    tp = pygradflow_torch.Params(**kwargs)
    pygradflow_torch.Solver(TPendulum(N=8), tp, device="cpu")
    BatchedSolver(TPendulum(N=8), tp, device="cpu")
