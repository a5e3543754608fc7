"""The port's public surface against the JAX package's, and the port's
independence from JAX.

``test_module_surface`` walks every module of ``pygradflow_tpu``: each
public class and function it defines, each upper-case constant it holds,
and, for a package, each public name it exports, must have its counterpart
of the same name in the matching ``pygradflow_torch`` module, and each
public member of a class its counterpart on the port's class.  ``ALLOWED``
lists the only exceptions, each with its reason.

The rest holds the names that the walk found missing against the JAX
values on the same inputs: ``Solver.perform_iteration`` (to 1e-12),
the top-level exports, ``Problem.var_bounded``, the active-set masks,
``iterate.dist`` and ``aug_lag_deriv_y``, ``util.keep_rows`` and the
constants.  ``test_no_jax_import`` scans the port, ``chip_smoke.py``, the
port's examples and the harness's case list with ``ast``.
"""

import ast
import importlib
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import pygradflow_torch
import pygradflow_tpu

from .torch_parity import ANCHOR, numpy, params_pair, tensor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ALLOWED = {
    # JAX pytree registration: a torch tensor container needs none
    "pygradflow_tpu.implicit_func:StepFunc.tree_flatten": "JAX pytree method",
    "pygradflow_tpu.implicit_func:StepFunc.tree_unflatten": "JAX pytree method",
    "pygradflow_tpu.linalg.block_tridiag:BCRFactor.tree_flatten": "JAX pytree method",
    "pygradflow_tpu.linalg.block_tridiag:BCRFactor.tree_unflatten": "JAX pytree method",
    # the name of a jax.sharding.Mesh axis; the port's mesh is a list of
    # torch devices and has no named axis
    "pygradflow_tpu.parallel.shard:AXIS": "mesh axis name",
    "pygradflow_tpu.parallel.distributed:AXIS": "mesh axis name",
    "pygradflow_tpu.parallel.schur:AXIS": "mesh axis name",
    "pygradflow_tpu.integration.batch:ShardedIntegrationSolver.AXIS": "mesh axis name",
    # the Pallas kernels' modules: their kernels are the CUDA ones behind
    # linalg/ldlt_kernels.py (csrc/ldlt.cu)
    "pygradflow_tpu.linalg.pallas_ldlt": "Pallas module, ported as linalg/ldlt_kernels.py",
    "pygradflow_tpu.linalg.pallas_ldlt_hbm": "Pallas module, ported as linalg/ldlt_kernels.py",
}

RENAMED = {
    # deliberate: the port's LoopState keeps the rcond estimate as ``rcond``
    "pygradflow_tpu.solver:LoopState.last_rcond": "rcond",
    # the port's one driver of a single solve's chunks, from a start or a
    # resumed state, with the finalizer fused into each chunk's read
    "pygradflow_tpu.solver:SolveLoop.run": "run_chunks",
    "pygradflow_tpu.solver:SolveLoop.run_fused": "run_chunks",
}


def _jax_modules():
    names = []
    base = os.path.join(ROOT, "pygradflow_tpu")
    for dirpath, dirnames, filenames in os.walk(base):
        dirnames[:] = sorted(d for d in dirnames if not d.startswith("_"))
        for f in sorted(filenames):
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)[:-3].replace(os.sep, ".")
            names.append(rel[: -len(".__init__")] if rel.endswith(".__init__") else rel)
    return sorted(names)


JAX_MODULES = _jax_modules()


def _public_names(mod):
    """What the walk holds of a JAX module: (name, object) pairs."""
    is_pkg = hasattr(mod, "__path__")
    out = []
    for name, obj in sorted(vars(mod).items()):
        if name.startswith("_") or inspect.ismodule(obj):
            continue
        if inspect.isclass(obj) or inspect.isfunction(obj):
            if is_pkg or obj.__module__ == mod.__name__:
                out.append((name, obj))
        elif name.isupper():
            out.append((name, obj))
    return out


def test_walk_covers_every_module():
    assert len(JAX_MODULES) > 60
    assert "pygradflow_tpu" in JAX_MODULES and "pygradflow_tpu.solver" in JAX_MODULES


@pytest.mark.parametrize("module", JAX_MODULES)
def test_module_surface(module):
    jmod = importlib.import_module(module)
    if module in ALLOWED:
        return
    tname = "pygradflow_torch" + module[len("pygradflow_tpu"):]
    tmod = importlib.import_module(tname)
    missing = []
    for name, obj in _public_names(jmod):
        key = f"{module}:{name}"
        if key in ALLOWED:
            continue
        if not hasattr(tmod, name):
            missing.append(name)
            continue
        if not inspect.isclass(obj):
            continue
        tcls = getattr(tmod, name)
        for member in sorted(vars(obj)):
            mkey = f"{obj.__module__}:{name}.{member}"
            if member.startswith("_") or mkey in ALLOWED:
                continue
            if not hasattr(tcls, RENAMED.get(mkey, member)):
                missing.append(f"{name}.{member}")
    assert not missing, f"{tname} lacks {missing}"


def test_allowlist_names_exist_in_jax():
    """Every exception still names something of the JAX package."""
    for key in list(ALLOWED) + list(RENAMED):
        module, _, path = key.partition(":")
        obj = importlib.import_module(module)
        for part in filter(None, path.split(".")):
            obj = getattr(obj, part)


# -- C1: Solver.perform_iteration -------------------------------------------


def _perform_both(jprob, tprob, x0, y0, **kwargs):
    jp, tp = params_pair(**kwargs)
    jx, jy, jd = pygradflow_tpu.Solver(jprob, jp).perform_iteration(x0, y0)
    solver = pygradflow_torch.Solver(tprob, tp, device="cpu")
    tx, ty, td = solver.perform_iteration(
        None if x0 is None else tensor(x0), None if y0 is None else tensor(y0)
    )
    for t in (tx, ty, td):
        assert torch.is_tensor(t) and t.device == solver.device
    return (np.asarray(jx), np.asarray(jy), np.asarray(jd)), (numpy(tx), numpy(ty), numpy(td))


def _perform_case(name):
    from pygradflow_torch.runners.control import PendulumControl as TPendulum
    from pygradflow_tpu.runners.control import PendulumControl as JPendulum

    from . import problems
    from . import torch_parity as tp

    if name == "rosenbrock":
        inst = problems.rosenbrock_instance()
        return problems.Rosenbrock(), tp.Rosenbrock(), inst.x_0, inst.y_0, {}
    if name == "hs71":
        inst = problems.hs71_instance()
        return problems.HS71(), tp.HS71(), inst.x_0, inst.y_0, {}
    jprob = JPendulum(N=8)
    return jprob, TPendulum(N=8), jprob.x0_trajectory(), None, ANCHOR


@pytest.mark.parametrize("name", ["rosenbrock", "hs71", "pendulum"])
def test_perform_iteration_matches_jax(name):
    jprob, tprob, x0, y0, kwargs = _perform_case(name)
    ref, ours = _perform_both(jprob, tprob, x0, y0, **kwargs)
    for r, o in zip(ref, ours):
        assert r.shape == o.shape
        np.testing.assert_allclose(o, r, rtol=0, atol=1e-12)
    if name == "rosenbrock":
        # the JAX package's step from (0, 0) at the initial lambda
        np.testing.assert_array_equal(ours[0], [0.0, 0.0])
        assert ours[1].shape == (0,)
        np.testing.assert_array_equal(ours[2], [0.0, 0.0])


def test_perform_iteration_default_start():
    from . import problems
    from . import torch_parity as tp

    ref, ours = _perform_both(problems.HS71(), tp.HS71(), None, None)
    for r, o in zip(ref, ours):
        np.testing.assert_allclose(o, r, rtol=0, atol=1e-12)


# -- C2: the top-level exports ----------------------------------------------


def test_top_level_exports():
    from pygradflow_torch import FuncProblem, QuadraticProblem, Scaling
    from pygradflow_torch.problem import FuncProblem as F, QuadraticProblem as Q
    from pygradflow_torch.scale import Scaling as S

    assert (FuncProblem, QuadraticProblem, Scaling) == (F, Q, S)


def test_top_level_import_needs_no_card_and_no_jax():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['pygradflow_tpu'] = None\n"
        "from pygradflow_torch import FuncProblem, QuadraticProblem, Scaling, Solver\n"
        "import torch; assert not torch.cuda.is_available()\n"
        "print('ok')\n"
    )
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# -- C3: Problem.var_bounded --------------------------------------------------


def _bounds_pair(var_lb, var_ub, **cons):
    import jax.numpy as jnp

    class JProb(pygradflow_tpu.Problem):
        def __init__(self):
            super().__init__(var_lb, var_ub, **cons)

        def obj(self, x):
            return jnp.sum(x**2)

        def cons(self, x):
            return jnp.array([x[0] + x[1]])

    class TProb(pygradflow_torch.Problem):
        def __init__(self):
            super().__init__(var_lb, var_ub, **cons)

        def obj(self, x):
            return torch.sum(x**2)

        def cons(self, x):
            return torch.stack([x[0] + x[1]])

    return JProb(), TProb()


INF = np.inf
BOUND_CASES = {
    "none": (np.full(2, -INF), np.full(2, INF), {}),
    "one lower": (np.array([-INF, 0.0]), np.full(2, INF), {}),
    "one upper": (np.full(2, -INF), np.array([INF, 3.0]), {}),
    "equality": (np.full(2, -INF), np.full(2, INF), dict(num_cons=1)),
    "ranged": (np.full(2, -INF), np.full(2, INF), dict(cons_lb=[-1.0], cons_ub=[1.0])),
}


@pytest.mark.parametrize("case", list(BOUND_CASES))
def test_var_bounded_matches_jax(case):
    from pygradflow_torch.cons_problem import ConstrainedProblem as TCons
    from pygradflow_torch.scale import Scaling as TScaling, ScaledProblem as TScaled
    from pygradflow_tpu.cons_problem import ConstrainedProblem as JCons
    from pygradflow_tpu.scale import Scaling as JScaling, ScaledProblem as JScaled

    var_lb, var_ub, cons = BOUND_CASES[case]
    jprob, tprob = _bounds_pair(var_lb, var_ub, **cons)
    expected = bool(np.isfinite(var_lb).any() or np.isfinite(var_ub).any())
    assert tprob.var_bounded is jprob.var_bounded is expected

    # the slack problem: a ranged constraint adds a bounded slack
    assert TCons(tprob).var_bounded is JCons(jprob).var_bounded
    assert TCons(tprob).var_bounded is (expected or case == "ranged")

    weights = (np.array([1, -2]), np.full(tprob.num_cons, 3, dtype=np.int64), 1)
    tscaled = TScaled(tprob, TScaling(*weights))
    jscaled = JScaled(jprob, JScaling(*weights))
    assert tscaled.var_bounded is jscaled.var_bounded is expected


# -- C4: the smaller names ----------------------------------------------------


def test_active_set_matches_jax():
    from pygradflow_torch.iterate import compute_active_set as tset
    from pygradflow_tpu.iterate import compute_active_set as jset

    rng = np.random.default_rng(5)
    n = 40
    lb = rng.uniform(-1.0, 0.0, n)
    ub = lb + rng.uniform(0.0, 2.0, n)
    ub[:4] = lb[:4]  # fixed variables: at both bounds
    lb[4:8], ub[8:12] = -INF, INF
    x = rng.uniform(-1.5, 1.5, n)
    x[12:16], x[16:20] = lb[12:16], ub[16:20]
    x[20:22] = lb[20:22] - 1e-9  # inside the tolerance
    x[22:24] = ub[22:24] + 1e-6  # outside it: violated
    tol = 1e-8
    ja = jset(x, lb, ub, tol)
    ta = tset(tensor(x), tensor(lb), tensor(ub), tol)
    assert ta._fields == ja._fields
    for field in ja._fields + ("satisfied",):
        np.testing.assert_array_equal(numpy(getattr(ta, field)), np.asarray(getattr(ja, field)), err_msg=field)
    assert numpy(ta.violated).any() and numpy(ta.at_either).any()


def _iterates_pair():
    from pygradflow_torch.eval import make_fns as tmake
    from pygradflow_torch.iterate import evaluate_iterate as teval
    from pygradflow_tpu.eval import make_fns as jmake
    from pygradflow_tpu.iterate import evaluate_iterate as jeval

    from . import problems
    from . import torch_parity as tp

    rng = np.random.default_rng(9)
    jp, tparams = params_pair()
    jfns, tfns = jmake(problems.HS71(), jp), tmake(tp.HS71(), tparams)
    pairs = []
    for _ in range(2):
        x, y = rng.uniform(1.0, 5.0, 5), rng.standard_normal(2)
        pairs.append((jeval(jfns, x, y), teval(tfns, tensor(x), tensor(y))))
    return pairs


def test_dist_and_aug_lag_deriv_y_match_jax():
    from pygradflow_torch import iterate as ti
    from pygradflow_tpu import iterate as ji

    (j0, t0), (j1, t1) = _iterates_pair()
    np.testing.assert_allclose(numpy(ti.dist(t0, t1)), np.asarray(ji.dist(j0, j1)), rtol=1e-15, atol=0)
    np.testing.assert_allclose(numpy(ti.aug_lag_deriv_y(t0)), np.asarray(ji.aug_lag_deriv_y(j0)), rtol=1e-15, atol=0)


def test_keep_rows_matches_jax():
    from pygradflow_torch.util import keep_rows as tkeep
    from pygradflow_tpu.util import keep_rows as jkeep

    rng = np.random.default_rng(2)
    mat = rng.standard_normal((7, 5))
    mask = rng.uniform(size=7) < 0.5
    expected = np.asarray(jkeep(mat, mask))
    np.testing.assert_array_equal(numpy(tkeep(tensor(mat), torch.as_tensor(mask))), expected)
    # on a lane stack the mask of each lane applies to its own rows
    masks = np.stack([mask, ~mask])
    stacked = numpy(tkeep(tensor(np.stack([mat, mat])), torch.as_tensor(masks)))
    np.testing.assert_array_equal(stacked[0], expected)
    np.testing.assert_array_equal(stacked[1], np.asarray(jkeep(mat, ~mask)))


@pytest.mark.parametrize(
    "module,name",
    [
        ("linalg.two_level_ldlt", "DEFAULT_SUPER_BLOCK"),
        ("linalg.two_level_ldlt", "MAX_SUPER_BLOCK"),
        ("integration.events", "EV_CONVERGED"),
        ("integration.integration_solver", "RUNNING"),
        ("step.opti_control", "IP_MAX_IT"),
    ],
)
def test_constants_match_jax(module, name):
    jval = getattr(importlib.import_module(f"pygradflow_tpu.{module}"), name)
    tval = getattr(importlib.import_module(f"pygradflow_torch.{module}"), name)
    assert type(tval) is type(jval) and tval == jval


# -- no JAX in the port --------------------------------------------------------


def _python_files(rel):
    path = os.path.join(ROOT, rel)
    if os.path.isfile(path):
        return [path]
    out = []
    for dirpath, dirnames, filenames in os.walk(path):
        dirnames[:] = sorted(d for d in dirnames if not d.startswith("_"))
        out += [os.path.join(dirpath, f) for f in sorted(filenames) if f.endswith(".py")]
    return out


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__" and node.args:
            if isinstance(node.args[0], ast.Constant):
                yield node.args[0].value
        elif (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "import_module"
            and node.args
            and isinstance(node.args[0], ast.Constant)
        ):
            yield node.args[0].value


@pytest.mark.parametrize("rel", ["pygradflow_torch", "chip_smoke.py", "docs/torch", "tools/torch_parity_cases.py"])
def test_no_jax_import(rel):
    files = _python_files(rel)
    assert files, rel
    bad = []
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "pygradflow_tpu"):
                bad.append(f"{os.path.relpath(path, ROOT)}: {name}")
    assert not bad, bad
