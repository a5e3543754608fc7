"""CUTEst benchmark adapter (counterpart of
``pygradflow_tpu/runners/cutest_runner.py``).

Wraps pycutest-decoded problems as :class:`pygradflow_torch.problem.Problem`
instances.  pycutest evaluates through Fortran callbacks on the host, so
each evaluation moves the point to the host as a float64 numpy array and
the value back to the point's device, and the derivatives are the
explicit overrides ``obj_grad``/``cons_jac``/``lag_hess``.
Nonlinear-equation problems (objective 0, residual constraints, a name
ending in ``NE``) are translated to ``min 1/2 ||c(x)||^2`` with the
Gauss-Newton Hessian; infinite bounds are mapped at 1e20.

Needs pycutest and a CUTEst installation; without pycutest the runner
lists no instance and warns.
"""

import numpy as np
import torch

from ..log import logger
from ..problem import Problem
from .instance import Instance
from .runner import Runner

CUTEST_INF = 1e20


def _map_inf(values):
    values = np.asarray(values, dtype=np.float64)
    out = np.where(values >= CUTEST_INF, np.inf, values)
    out = np.where(values <= -CUTEST_INF, -np.inf, out)
    return out


def _host(t):
    return t.detach().cpu().numpy().astype(np.float64)


def _like(value, x):
    """A host value as a float64 tensor on ``x``'s device."""
    return torch.as_tensor(np.asarray(value, dtype=np.float64), device=x.device)


class CUTEstProblem(Problem):
    """General constrained CUTEst problem through host callbacks."""

    evaluates_on_host = True  # the solve loop runs eagerly (solver.EAGER_ON_CARD)

    def __init__(self, cutest):
        self._cutest = cutest

        var_lb = _map_inf(cutest.bl)
        var_ub = _map_inf(cutest.bu)

        if cutest.m > 0:
            cons_lb = _map_inf(cutest.cl)
            cons_ub = _map_inf(cutest.cu)
            super().__init__(var_lb, var_ub, cons_lb=cons_lb, cons_ub=cons_ub)
        else:
            super().__init__(var_lb, var_ub)

    def obj(self, x, *args):
        return _like(self._cutest.obj(_host(x)), x)

    def obj_grad(self, x, *args):
        _, grad = self._cutest.obj(_host(x), gradient=True)
        return _like(grad, x)

    def cons(self, x, *args):
        return _like(self._cutest.cons(_host(x)), x)

    def cons_jac(self, x, *args):
        _, jac = self._cutest.cons(_host(x), gradient=True)
        return _like(jac, x)

    def lag_hess(self, x, y, *args):
        if self.num_cons > 0:
            out = self._cutest.hess(_host(x), v=_host(y))
        else:
            out = self._cutest.hess(_host(x))
        return _like(out, x)


def is_ne_problem(name):
    """Nonlinear-equation SIF convention: the name ends in "NE"."""
    return name.endswith("NE")


class CUTEstNEProblem(Problem):
    """Nonlinear-equation problem translated to bound-constrained least
    squares: ``min 1/2 ||c(x)||^2`` with gradient ``J^T c`` and the
    Gauss-Newton Hessian ``J^T J``; the translated problem has no
    constraints."""

    evaluates_on_host = True

    def __init__(self, cutest):
        self._cutest = cutest
        self._m = int(cutest.m)

        super().__init__(_map_inf(cutest.bl), _map_inf(cutest.bu))

    def obj(self, x, *args):
        r = np.asarray(self._cutest.cons(_host(x)))
        return _like(0.5 * np.dot(r, r), x)

    def obj_grad(self, x, *args):
        r, jac = self._cutest.cons(_host(x), gradient=True)
        return _like(np.asarray(jac).T.dot(np.asarray(r)), x)

    def lag_hess(self, x, y, *args):
        _, jac = self._cutest.cons(_host(x), gradient=True)
        jac = np.asarray(jac, dtype=np.float64)
        return _like(jac.T.dot(jac), x)


class CUTEstInstance(Instance):
    """Lazy instance: the SIF decode (``pycutest.import_problem``) runs at
    ``problem()`` time, not at listing time."""

    def __init__(self, name, num_vars, num_cons):
        super().__init__(name, num_vars, num_cons)
        self._decoded = None

    def _cutest(self):
        if self._decoded is None:
            import pycutest

            self._decoded = pycutest.import_problem(self.name)
        return self._decoded

    def problem(self):
        cutest = self._cutest()
        if is_ne_problem(self.name):
            return CUTEstNEProblem(cutest)
        return CUTEstProblem(cutest)

    def x0(self):
        return np.asarray(self._cutest().x0, dtype=np.float64)

    def y0(self):
        cutest = self._cutest()
        if not is_ne_problem(self.name) and cutest.m > 0 and getattr(cutest, "v0", None) is not None:
            return np.asarray(cutest.v0, dtype=np.float64)
        return 0.0


class CUTEstRunner(Runner):
    def __init__(self):
        super().__init__(name="cutest")

    def parser(self):
        parser = super().parser()
        parser.add_argument("--problems", nargs="*", help="CUTEst problem names (default: all)")
        parser.add_argument(
            "--ignore_ne_probs",
            action="store_true",
            help="skip *NE nonlinear-equation problems",
        )
        return parser

    def get_instances(self, args):
        try:
            import pycutest
        except ImportError:
            logger.warning("pycutest is not installed; no CUTEst instances")
            return []

        names = args.problems or pycutest.find_problems()
        instances = []
        for name in names:
            if args.ignore_ne_probs and is_ne_problem(name):
                continue
            try:
                props = pycutest.problem_properties(name)
            except Exception as exc:
                logger.warning("No properties for CUTEst problem %s: %s", name, exc)
                continue
            n, m = props.get("n"), props.get("m")
            # variable-dimension SIF entries need an explicit size choice
            if n == "variable" or m == "variable":
                continue
            m = 0 if m is None else m
            # the translated NE problem is unconstrained
            instances.append(CUTEstInstance(name, n, 0 if is_ne_problem(name) else m))
        return instances


if __name__ == "__main__":
    CUTEstRunner().main()
