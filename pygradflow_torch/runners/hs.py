"""The Hock-Schittkowski test suite (counterpart of
``pygradflow_tpu/runners/hs.py``).

The classical Hock-Schittkowski problems in their standard formulations,
written with torch operations, so that ``torch.func`` gives their
derivatives.  Each entry records the book initial point and, where closed
form, the known optimum and optimal value.  The numbers (bounds, starts,
optima) are those of the JAX package's specs.

Constraint vectors and constant tables are built by ``_vec``, which makes
a tensor of ``x``'s dtype on ``x``'s device from tensors and Python floats;
nothing is written in place and nothing is read on the host.
"""

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.func import jacrev

from ..problem import Problem

INF = np.inf


class HSProblem(Problem):
    """An HS spec as a problem.  The constraint Jacobian and the Lagrangian
    Hessian are taken in reverse mode (``torch.func.jacrev``): on these
    scalar-indexed formulas forward mode multiplies every Python constant
    through a decomposed primitive, and costs 3-6 times the wall."""

    def __init__(self, spec):
        self._spec = spec
        kwargs = {}
        if spec.cons_lb is not None or spec.cons_ub is not None:
            kwargs = dict(cons_lb=spec.cons_lb, cons_ub=spec.cons_ub)
        elif spec.num_eq_cons:
            kwargs = dict(num_cons=spec.num_eq_cons)
        super().__init__(spec.var_lb, spec.var_ub, **kwargs)

    def obj(self, x):
        return self._spec.obj(x)

    def cons(self, x):
        return self._spec.cons(x)

    def cons_jac(self, x, *args):
        return jacrev(self.cons)(x)

    def lag_hess(self, x, y, *args):
        return jacrev(lambda x_: self._lag_grad(x_, y))(x)


class HSSpec(NamedTuple):
    name: str
    obj: Callable
    var_lb: np.ndarray
    var_ub: np.ndarray
    x0: np.ndarray
    cons: Optional[Callable] = None
    cons_lb: Optional[np.ndarray] = None
    cons_ub: Optional[np.ndarray] = None
    num_eq_cons: int = 0
    x_opt: Optional[np.ndarray] = None
    f_opt: Optional[float] = None

    def problem(self) -> HSProblem:
        return HSProblem(self)


def _a(*vals):
    return np.array(vals, dtype=np.float64)


def _vec(x, vals):
    """The tensor of ``vals`` in ``x``'s dtype on ``x``'s device: a vector
    of tensors and Python floats, or a (nested) list of constants."""
    if not any(torch.is_tensor(v) for v in vals):
        return torch.tensor(vals, dtype=x.dtype, device=x.device)
    return torch.stack([v if torch.is_tensor(v) else _const(x, v) for v in vals])


def _const(x, value):
    """A 0-dim constant in ``x``'s dtype on ``x``'s device."""
    return torch.full((), value, dtype=x.dtype, device=x.device)


def _arange(x, start, stop):
    return torch.arange(start, stop, dtype=x.dtype, device=x.device)


def _rosenbrock_obj(x):
    return 100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[0]) ** 2


HS_SPECS = [
    HSSpec(
        name="hs1",
        obj=_rosenbrock_obj,
        var_lb=_a(-INF, -1.5),
        var_ub=_a(INF, INF),
        x0=_a(-2.0, 1.0),
        x_opt=_a(1.0, 1.0),
        f_opt=0.0,
    ),
    HSSpec(
        name="hs2",
        obj=_rosenbrock_obj,
        var_lb=_a(-INF, 1.5),
        var_ub=_a(INF, INF),
        x0=_a(-2.0, 1.0),
        x_opt=_a(1.2243707487363527, 1.5),
        f_opt=0.05042618789356104,
    ),
    HSSpec(
        name="hs3",
        obj=lambda x: x[1] + 1e-5 * (x[1] - x[0]) ** 2,
        var_lb=_a(-INF, 0.0),
        var_ub=_a(INF, INF),
        x0=_a(10.0, 1.0),
        x_opt=_a(0.0, 0.0),
        f_opt=0.0,
    ),
    HSSpec(
        name="hs4",
        obj=lambda x: (x[0] + 1.0) ** 3 / 3.0 + x[1],
        var_lb=_a(1.0, 0.0),
        var_ub=_a(INF, INF),
        x0=_a(1.125, 0.125),
        x_opt=_a(1.0, 0.0),
        f_opt=8.0 / 3.0,
    ),
    HSSpec(
        name="hs5",
        obj=lambda x: (
            torch.sin(x[0] + x[1])
            + (x[0] - x[1]) ** 2
            - 1.5 * x[0]
            + 2.5 * x[1]
            + 1.0
        ),
        var_lb=_a(-1.5, -3.0),
        var_ub=_a(4.0, 3.0),
        x0=_a(0.0, 0.0),
        x_opt=_a(0.5 - math.pi / 3.0, 0.5 - math.pi / 3.0 - 1.0),
        f_opt=-math.sqrt(3.0) / 2.0 - math.pi / 3.0,
    ),
    HSSpec(
        name="hs6",
        obj=lambda x: (1.0 - x[0]) ** 2,
        var_lb=_a(-INF, -INF),
        var_ub=_a(INF, INF),
        x0=_a(-1.2, 1.0),
        cons=lambda x: _vec(x, [10.0 * (x[1] - x[0] ** 2)]),
        num_eq_cons=1,
        x_opt=_a(1.0, 1.0),
        f_opt=0.0,
    ),
    HSSpec(
        name="hs7",
        obj=lambda x: torch.log(1.0 + x[0] ** 2) - x[1],
        var_lb=_a(-INF, -INF),
        var_ub=_a(INF, INF),
        x0=_a(2.0, 2.0),
        cons=lambda x: _vec(x, [(1.0 + x[0] ** 2) ** 2 + x[1] ** 2 - 4.0]),
        num_eq_cons=1,
        x_opt=_a(0.0, math.sqrt(3.0)),
        f_opt=-math.sqrt(3.0),
    ),
    HSSpec(
        name="hs14",
        obj=lambda x: (x[0] - 2.0) ** 2 + (x[1] - 1.0) ** 2,
        var_lb=_a(-INF, -INF),
        var_ub=_a(INF, INF),
        x0=_a(2.0, 2.0),
        cons=lambda x: _vec(x, 
            [x[0] - 2.0 * x[1] + 1.0, -0.25 * x[0] ** 2 - x[1] ** 2 + 1.0]
        ),
        cons_lb=_a(0.0, 0.0),
        cons_ub=_a(0.0, INF),
        x_opt=_a(0.5 * (math.sqrt(7.0) - 1.0), 0.25 * (math.sqrt(7.0) + 1.0)),
        f_opt=9.0 - 2.875 * math.sqrt(7.0),
    ),
    HSSpec(
        name="hs21",
        obj=lambda x: 0.01 * x[0] ** 2 + x[1] ** 2 - 100.0,
        var_lb=_a(2.0, -50.0),
        var_ub=_a(50.0, 50.0),
        x0=_a(-1.0, -1.0),
        cons=lambda x: _vec(x, [10.0 * x[0] - x[1]]),
        cons_lb=_a(10.0),
        cons_ub=_a(INF),
        x_opt=_a(2.0, 0.0),
        f_opt=-99.96,
    ),
    HSSpec(
        name="hs28",
        obj=lambda x: (x[0] + x[1]) ** 2 + (x[1] + x[2]) ** 2,
        var_lb=_a(-INF, -INF, -INF),
        var_ub=_a(INF, INF, INF),
        x0=_a(-4.0, 1.0, 1.0),
        cons=lambda x: _vec(x, [x[0] + 2.0 * x[1] + 3.0 * x[2] - 1.0]),
        num_eq_cons=1,
        x_opt=_a(0.5, -0.5, 0.5),
        f_opt=0.0,
    ),
    HSSpec(
        name="hs35",
        obj=lambda x: (
            9.0
            - 8.0 * x[0]
            - 6.0 * x[1]
            - 4.0 * x[2]
            + 2.0 * x[0] ** 2
            + 2.0 * x[1] ** 2
            + x[2] ** 2
            + 2.0 * x[0] * x[1]
            + 2.0 * x[0] * x[2]
        ),
        var_lb=_a(0.0, 0.0, 0.0),
        var_ub=_a(INF, INF, INF),
        x0=_a(0.5, 0.5, 0.5),
        cons=lambda x: _vec(x, [x[0] + x[1] + 2.0 * x[2]]),
        cons_lb=_a(-INF),
        cons_ub=_a(3.0),
        x_opt=_a(4.0 / 3.0, 7.0 / 9.0, 4.0 / 9.0),
        f_opt=1.0 / 9.0,
    ),
    HSSpec(
        name="hs38",
        obj=lambda x: (
            100.0 * (x[1] - x[0] ** 2) ** 2
            + (1.0 - x[0]) ** 2
            + 90.0 * (x[3] - x[2] ** 2) ** 2
            + (1.0 - x[2]) ** 2
            + 10.1 * ((x[1] - 1.0) ** 2 + (x[3] - 1.0) ** 2)
            + 19.8 * (x[1] - 1.0) * (x[3] - 1.0)
        ),
        var_lb=np.full(4, -10.0),
        var_ub=np.full(4, 10.0),
        x0=_a(-3.0, -1.0, -3.0, -1.0),
        x_opt=np.ones(4),
        f_opt=0.0,
    ),
    HSSpec(
        name="hs45",
        obj=lambda x: 2.0 - x[0] * x[1] * x[2] * x[3] * x[4] / 120.0,
        var_lb=np.zeros(5),
        var_ub=_a(1.0, 2.0, 3.0, 4.0, 5.0),
        x0=np.full(5, 2.0) .clip(np.zeros(5), _a(1.0, 2.0, 3.0, 4.0, 5.0)),
        x_opt=_a(1.0, 2.0, 3.0, 4.0, 5.0),
        f_opt=1.0,
    ),
    HSSpec(
        name="hs48",
        obj=lambda x: (x[0] - 1.0) ** 2 + (x[1] - x[2]) ** 2 + (x[3] - x[4]) ** 2,
        var_lb=np.full(5, -INF),
        var_ub=np.full(5, INF),
        x0=_a(3.0, 5.0, -3.0, 2.0, -2.0),
        cons=lambda x: _vec(x, 
            [
                x[0] + x[1] + x[2] + x[3] + x[4] - 5.0,
                x[2] - 2.0 * (x[3] + x[4]) + 3.0,
            ]
        ),
        num_eq_cons=2,
        x_opt=np.ones(5),
        f_opt=0.0,
    ),
    HSSpec(
        name="hs51",
        obj=lambda x: (
            (x[0] - x[1]) ** 2
            + (x[1] + x[2] - 2.0) ** 2
            + (x[3] - 1.0) ** 2
            + (x[4] - 1.0) ** 2
        ),
        var_lb=np.full(5, -INF),
        var_ub=np.full(5, INF),
        x0=_a(2.5, 0.5, 2.0, -1.0, 0.5),
        cons=lambda x: _vec(x, 
            [
                x[0] + 3.0 * x[1] - 4.0,
                x[2] + x[3] - 2.0 * x[4],
                x[1] - x[4],
            ]
        ),
        num_eq_cons=3,
        x_opt=np.ones(5),
        f_opt=0.0,
    ),
    HSSpec(
        name="hs71",
        obj=lambda x: x[0] * x[3] * (x[0] + x[1] + x[2]) + x[2],
        var_lb=np.ones(4),
        var_ub=np.full(4, 5.0),
        x0=_a(1.0, 5.0, 5.0, 1.0),
        cons=lambda x: _vec(x, [torch.prod(x), torch.dot(x, x)]),
        cons_lb=_a(25.0, 40.0),
        cons_ub=_a(INF, 40.0),
        x_opt=_a(1.0, 4.74299964, 3.82114998, 1.37940829),
        f_opt=17.0140173,
    ),
    HSSpec(
        name="hs9",
        obj=lambda x: torch.sin(math.pi * x[0] / 12.0) * torch.cos(math.pi * x[1] / 16.0),
        var_lb=_a(-INF, -INF),
        var_ub=_a(INF, INF),
        x0=_a(0.0, 0.0),
        cons=lambda x: _vec(x, [4.0 * x[0] - 3.0 * x[1]]),
        num_eq_cons=1,
        x_opt=_a(-3.0, -4.0),
        f_opt=-0.5,
    ),
    HSSpec(
        name="hs10",
        obj=lambda x: x[0] - x[1],
        var_lb=_a(-INF, -INF),
        var_ub=_a(INF, INF),
        x0=_a(-10.0, 10.0),
        cons=lambda x: _vec(x, 
            [-3.0 * x[0] ** 2 + 2.0 * x[0] * x[1] - x[1] ** 2 + 1.0]
        ),
        cons_lb=_a(0.0),
        cons_ub=_a(INF),
        x_opt=_a(0.0, 1.0),
        f_opt=-1.0,
    ),
    HSSpec(
        name="hs26",
        obj=lambda x: (x[0] - x[1]) ** 2 + (x[1] - x[2]) ** 4,
        var_lb=_a(-INF, -INF, -INF),
        var_ub=_a(INF, INF, INF),
        x0=_a(-2.6, 2.0, 2.0),
        cons=lambda x: _vec(x, 
            [(1.0 + x[1] ** 2) * x[0] + x[2] ** 4 - 3.0]
        ),
        num_eq_cons=1,
        x_opt=_a(1.0, 1.0, 1.0),
        f_opt=0.0,
    ),
    HSSpec(
        name="hs27",
        obj=lambda x: 0.01 * (x[0] - 1.0) ** 2 + (x[1] - x[0] ** 2) ** 2,
        var_lb=_a(-INF, -INF, -INF),
        var_ub=_a(INF, INF, INF),
        x0=_a(2.0, 2.0, 2.0),
        cons=lambda x: _vec(x, [x[0] + x[2] ** 2 + 1.0]),
        num_eq_cons=1,
        x_opt=_a(-1.0, 1.0, 0.0),
        f_opt=0.04,
    ),
    HSSpec(
        name="hs30",
        obj=lambda x: x[0] ** 2 + x[1] ** 2 + x[2] ** 2,
        var_lb=_a(1.0, -10.0, -10.0),
        var_ub=_a(10.0, 10.0, 10.0),
        x0=_a(1.0, 1.0, 1.0),
        cons=lambda x: _vec(x, [x[0] ** 2 + x[1] ** 2 - 1.0]),
        cons_lb=_a(0.0),
        cons_ub=_a(INF),
        x_opt=_a(1.0, 0.0, 0.0),
        f_opt=1.0,
    ),
    HSSpec(
        name="hs36",
        obj=lambda x: -x[0] * x[1] * x[2],
        var_lb=_a(0.0, 0.0, 0.0),
        var_ub=_a(20.0, 11.0, 42.0),
        x0=_a(10.0, 10.0, 10.0),
        cons=lambda x: _vec(x, [x[0] + 2.0 * x[1] + 2.0 * x[2]]),
        cons_lb=_a(-INF),
        cons_ub=_a(72.0),
        x_opt=_a(20.0, 11.0, 15.0),
        f_opt=-3300.0,
    ),
    HSSpec(
        name="hs42",
        obj=lambda x: (
            (x[0] - 1.0) ** 2
            + (x[1] - 2.0) ** 2
            + (x[2] - 3.0) ** 2
            + (x[3] - 4.0) ** 2
        ),
        var_lb=np.full(4, -INF),
        var_ub=np.full(4, INF),
        x0=np.ones(4),
        cons=lambda x: _vec(x, 
            [x[0] - 2.0, x[2] ** 2 + x[3] ** 2 - 2.0]
        ),
        num_eq_cons=2,
        x_opt=_a(2.0, 2.0, 0.6 * math.sqrt(2.0), 0.8 * math.sqrt(2.0)),
        f_opt=28.0 - 10.0 * math.sqrt(2.0),
    ),
    HSSpec(
        name="hs12",
        obj=lambda x: 0.5 * x[0] ** 2 + x[1] ** 2 - x[0] * x[1] - 7.0 * x[0] - 7.0 * x[1],
        var_lb=_a(-INF, -INF),
        var_ub=_a(INF, INF),
        x0=_a(0.0, 0.0),
        cons=lambda x: _vec(x, [25.0 - 4.0 * x[0] ** 2 - x[1] ** 2]),
        cons_lb=_a(0.0),
        cons_ub=_a(INF),
        x_opt=_a(2.0, 3.0),
        f_opt=-30.0,
    ),
    HSSpec(
        name="hs22",
        obj=lambda x: (x[0] - 2.0) ** 2 + (x[1] - 1.0) ** 2,
        var_lb=_a(-INF, -INF),
        var_ub=_a(INF, INF),
        x0=_a(2.0, 2.0),
        cons=lambda x: _vec(x, [-x[0] - x[1] + 2.0, -x[0] ** 2 + x[1]]),
        cons_lb=_a(0.0, 0.0),
        cons_ub=_a(INF, INF),
        x_opt=_a(1.0, 1.0),
        f_opt=1.0,
    ),
    HSSpec(
        name="hs24",
        obj=lambda x: ((x[0] - 3.0) ** 2 - 9.0) * x[1] ** 3 / (27.0 * math.sqrt(3.0)),
        var_lb=_a(0.0, 0.0),
        var_ub=_a(INF, INF),
        x0=_a(1.0, 0.5),
        cons=lambda x: _vec(x, 
            [
                x[0] / math.sqrt(3.0) - x[1],
                x[0] + math.sqrt(3.0) * x[1],
                -x[0] - math.sqrt(3.0) * x[1] + 6.0,
            ]
        ),
        cons_lb=_a(0.0, 0.0, 0.0),
        cons_ub=_a(INF, INF, INF),
        x_opt=_a(3.0, math.sqrt(3.0)),
        f_opt=-1.0,
    ),
    HSSpec(
        name="hs29",
        obj=lambda x: -x[0] * x[1] * x[2],
        var_lb=_a(-INF, -INF, -INF),
        var_ub=_a(INF, INF, INF),
        x0=_a(1.0, 1.0, 1.0),
        cons=lambda x: _vec(x, 
            [-(x[0] ** 2) - 2.0 * x[1] ** 2 - 4.0 * x[2] ** 2 + 48.0]
        ),
        cons_lb=_a(0.0),
        cons_ub=_a(INF),
        x_opt=_a(4.0, 2.0 * math.sqrt(2.0), 2.0),
        f_opt=-16.0 * math.sqrt(2.0),
    ),
    HSSpec(
        name="hs43",
        obj=lambda x: (
            x[0] ** 2
            + x[1] ** 2
            + 2.0 * x[2] ** 2
            + x[3] ** 2
            - 5.0 * x[0]
            - 5.0 * x[1]
            - 21.0 * x[2]
            + 7.0 * x[3]
        ),
        var_lb=np.full(4, -INF),
        var_ub=np.full(4, INF),
        x0=np.zeros(4),
        cons=lambda x: _vec(x, 
            [
                8.0 - x[0] ** 2 - x[1] ** 2 - x[2] ** 2 - x[3] ** 2
                - x[0] + x[1] - x[2] + x[3],
                10.0 - x[0] ** 2 - 2.0 * x[1] ** 2 - x[2] ** 2 - 2.0 * x[3] ** 2
                + x[0] + x[3],
                5.0 - 2.0 * x[0] ** 2 - x[1] ** 2 - x[2] ** 2 - 2.0 * x[0]
                + x[1] + x[3],
            ]
        ),
        cons_lb=np.zeros(3),
        cons_ub=np.full(3, INF),
        x_opt=_a(0.0, 1.0, 2.0, -1.0),
        f_opt=-44.0,
    ),
    HSSpec(
        name="hs49",
        obj=lambda x: (
            (x[0] - x[1]) ** 2
            + (x[2] - 1.0) ** 2
            + (x[3] - 1.0) ** 4
            + (x[4] - 1.0) ** 6
        ),
        var_lb=np.full(5, -INF),
        var_ub=np.full(5, INF),
        x0=_a(10.0, 7.0, 2.0, -3.0, 0.8),
        cons=lambda x: _vec(x, 
            [x[0] + x[1] + x[2] + 4.0 * x[3] - 7.0, x[2] + 5.0 * x[4] - 6.0]
        ),
        num_eq_cons=2,
        x_opt=np.ones(5),
        f_opt=0.0,
    ),
    HSSpec(
        name="hs50",
        obj=lambda x: (
            (x[0] - x[1]) ** 2
            + (x[1] - x[2]) ** 2
            + (x[2] - x[3]) ** 4
            + (x[3] - x[4]) ** 2
        ),
        var_lb=np.full(5, -INF),
        var_ub=np.full(5, INF),
        x0=_a(35.0, -31.0, 11.0, 5.0, -5.0),
        cons=lambda x: _vec(x, 
            [
                x[0] + 2.0 * x[1] + 3.0 * x[2] - 6.0,
                x[1] + 2.0 * x[2] + 3.0 * x[3] - 6.0,
                x[2] + 2.0 * x[3] + 3.0 * x[4] - 6.0,
            ]
        ),
        num_eq_cons=3,
        x_opt=np.ones(5),
        f_opt=0.0,
    ),
    HSSpec(
        name="hs8",
        obj=lambda x: _const(x, -1.0),
        var_lb=_a(-INF, -INF),
        var_ub=_a(INF, INF),
        x0=_a(2.0, 1.0),
        cons=lambda x: _vec(x, 
            [x[0] ** 2 + x[1] ** 2 - 25.0, x[0] * x[1] - 9.0]
        ),
        num_eq_cons=2,
        # four symmetric feasible points; objective is constant
        f_opt=-1.0,
    ),
    HSSpec(
        name="hs11",
        obj=lambda x: (x[0] - 5.0) ** 2 + x[1] ** 2 - 25.0,
        var_lb=_a(-INF, -INF),
        var_ub=_a(INF, INF),
        x0=_a(4.9, 0.1),
        cons=lambda x: _vec(x, [x[1] - x[0] ** 2]),
        cons_lb=_a(0.0),
        cons_ub=_a(INF),
        f_opt=-8.498464223,
    ),
    HSSpec(
        name="hs16",
        obj=_rosenbrock_obj,
        var_lb=_a(-2.0, -INF),
        var_ub=_a(0.5, 1.0),
        x0=_a(-2.0, 1.0),
        cons=lambda x: _vec(x, 
            [x[0] + x[1] ** 2, x[0] ** 2 + x[1]]
        ),
        cons_lb=_a(0.0, 0.0),
        cons_ub=_a(INF, INF),
        x_opt=_a(0.5, 0.25),
        f_opt=0.25,
    ),
    HSSpec(
        name="hs18",
        obj=lambda x: x[0] ** 2 / 100.0 + x[1] ** 2,
        var_lb=_a(2.0, 0.0),
        var_ub=_a(50.0, 50.0),
        x0=_a(2.0, 2.0),
        cons=lambda x: _vec(x, 
            [x[0] * x[1] - 25.0, x[0] ** 2 + x[1] ** 2 - 25.0]
        ),
        cons_lb=_a(0.0, 0.0),
        cons_ub=_a(INF, INF),
        x_opt=_a(math.sqrt(250.0), math.sqrt(2.5)),
        f_opt=5.0,
    ),
    HSSpec(
        name="hs23",
        obj=lambda x: x[0] ** 2 + x[1] ** 2,
        var_lb=_a(-50.0, -50.0),
        var_ub=_a(50.0, 50.0),
        x0=_a(3.0, 1.0),
        cons=lambda x: _vec(x, 
            [
                x[0] + x[1] - 1.0,
                x[0] ** 2 + x[1] ** 2 - 1.0,
                9.0 * x[0] ** 2 + x[1] ** 2 - 9.0,
                x[0] ** 2 - x[1],
                x[1] ** 2 - x[0],
            ]
        ),
        cons_lb=np.zeros(5),
        cons_ub=np.full(5, INF),
        x_opt=_a(1.0, 1.0),
        f_opt=2.0,
    ),
    HSSpec(
        name="hs31",
        obj=lambda x: 9.0 * x[0] ** 2 + x[1] ** 2 + 9.0 * x[2] ** 2,
        var_lb=_a(-10.0, 1.0, -10.0),
        var_ub=_a(10.0, 10.0, 1.0),
        x0=_a(1.0, 1.0, 1.0),
        cons=lambda x: _vec(x, [x[0] * x[1] - 1.0]),
        cons_lb=_a(0.0),
        cons_ub=_a(INF),
        x_opt=_a(1.0 / math.sqrt(3.0), math.sqrt(3.0), 0.0),
        f_opt=6.0,
    ),
    HSSpec(
        name="hs33",
        obj=lambda x: (x[0] - 1.0) * (x[0] - 2.0) * (x[0] - 3.0) + x[2],
        var_lb=_a(0.0, 0.0, 0.0),
        var_ub=_a(INF, INF, 5.0),
        x0=_a(0.0, 0.0, 3.0),
        cons=lambda x: _vec(x, 
            [
                x[2] ** 2 - x[1] ** 2 - x[0] ** 2,
                x[0] ** 2 + x[1] ** 2 + x[2] ** 2 - 4.0,
            ]
        ),
        cons_lb=_a(0.0, 0.0),
        cons_ub=_a(INF, INF),
        # nonconvex: from the book start the homotopy (like any local
        # method) converges to the KKT point x=(0,0,2), f=-4; the book's
        # global optimum is (0,sqrt2,sqrt2), f=sqrt2-6
        x_opt=None,
        f_opt=None,
    ),
    HSSpec(
        name="hs52",
        obj=lambda x: (
            (4.0 * x[0] - x[1]) ** 2
            + (x[1] + x[2] - 2.0) ** 2
            + (x[3] - 1.0) ** 2
            + (x[4] - 1.0) ** 2
        ),
        var_lb=np.full(5, -INF),
        var_ub=np.full(5, INF),
        x0=np.full(5, 2.0),
        cons=lambda x: _vec(x, 
            [
                x[0] + 3.0 * x[1],
                x[2] + x[3] - 2.0 * x[4],
                x[1] - x[4],
            ]
        ),
        num_eq_cons=3,
        f_opt=1859.0 / 349.0,
    ),
    HSSpec(
        name="hs76",
        obj=lambda x: (
            x[0] ** 2
            + 0.5 * x[1] ** 2
            + x[2] ** 2
            + 0.5 * x[3] ** 2
            - x[0] * x[2]
            + x[2] * x[3]
            - x[0]
            - 3.0 * x[1]
            + x[2]
            - x[3]
        ),
        var_lb=np.zeros(4),
        var_ub=np.full(4, INF),
        x0=np.full(4, 0.5),
        cons=lambda x: _vec(x, 
            [
                x[0] + 2.0 * x[1] + x[2] + x[3],
                3.0 * x[0] + x[1] + 2.0 * x[2] - x[3],
                x[1] + 4.0 * x[2],
            ]
        ),
        cons_lb=_a(-INF, -INF, 1.5),
        cons_ub=_a(5.0, 4.0, INF),
        f_opt=-4.681818181,
    ),
    # ---- round-3 additions: inequality-heavy problems stressing
    # active-set churn and the penalty filters (book formulations)
    HSSpec(
        name="hs34",
        obj=lambda x: -x[0],
        var_lb=_a(0.0, 0.0, 0.0),
        var_ub=_a(100.0, 100.0, 10.0),
        x0=_a(0.0, 1.05, 2.9),
        cons=lambda x: _vec(x, 
            [x[1] - torch.exp(x[0]), x[2] - torch.exp(x[1])]
        ),
        cons_lb=_a(0.0, 0.0),
        cons_ub=_a(INF, INF),
        x_opt=_a(math.log(math.log(10.0)), math.log(10.0), 10.0),
        f_opt=-math.log(math.log(10.0)),
    ),
    HSSpec(
        name="hs39",
        obj=lambda x: -x[0],
        var_lb=np.full(4, -INF),
        var_ub=np.full(4, INF),
        x0=np.full(4, 2.0),
        cons=lambda x: _vec(x, 
            [x[1] - x[0] ** 3 - x[2] ** 2, x[0] ** 2 - x[1] - x[3] ** 2]
        ),
        num_eq_cons=2,
        x_opt=_a(1.0, 1.0, 0.0, 0.0),
        f_opt=-1.0,
    ),
    HSSpec(
        name="hs40",
        obj=lambda x: -x[0] * x[1] * x[2] * x[3],
        var_lb=np.full(4, -INF),
        var_ub=np.full(4, INF),
        x0=np.full(4, 0.8),
        cons=lambda x: _vec(x, 
            [
                x[0] ** 3 + x[1] ** 2 - 1.0,
                x[0] ** 2 * x[3] - x[2],
                x[3] ** 2 - x[1],
            ]
        ),
        num_eq_cons=3,
        f_opt=-0.25,
    ),
    HSSpec(
        name="hs44",
        obj=lambda x: (
            x[0] - x[1] - x[2] - x[0] * x[2] + x[0] * x[3]
            + x[1] * x[2] - x[1] * x[3]
        ),
        var_lb=np.zeros(4),
        var_ub=np.full(4, INF),
        x0=np.zeros(4),
        cons=lambda x: _vec(x, 
            [
                8.0 - x[0] - 2.0 * x[1],
                12.0 - 4.0 * x[0] - x[1],
                12.0 - 3.0 * x[0] - 4.0 * x[1],
                8.0 - 2.0 * x[2] - x[3],
                8.0 - x[2] - 2.0 * x[3],
                5.0 - x[2] - x[3],
            ]
        ),
        cons_lb=np.zeros(6),
        cons_ub=np.full(6, INF),
        # nonconvex (bilinear): from the book start the homotopy reaches
        # the local KKT point f=-13 at (3,0,4,0); the book's global
        # optimum is f=-15 at (0,3,0,4)
        x_opt=None,
        f_opt=None,
    ),
    HSSpec(
        name="hs60",
        obj=lambda x: (
            (x[0] - 1.0) ** 2
            + (x[0] - x[1]) ** 2
            + (x[1] - x[2]) ** 4
        ),
        var_lb=np.full(3, -10.0),
        var_ub=np.full(3, 10.0),
        x0=np.full(3, 2.0),
        cons=lambda x: _vec(x, 
            [x[0] * (1.0 + x[1] ** 2) + x[2] ** 4 - 4.0 - 3.0 * math.sqrt(2.0)]
        ),
        num_eq_cons=1,
        f_opt=0.03256820025,
    ),
    HSSpec(
        name="hs63",
        obj=lambda x: (
            1000.0 - x[0] ** 2 - 2.0 * x[1] ** 2 - x[2] ** 2
            - x[0] * x[1] - x[0] * x[2]
        ),
        var_lb=np.zeros(3),
        var_ub=np.full(3, INF),
        x0=np.full(3, 2.0),
        cons=lambda x: _vec(x, 
            [
                8.0 * x[0] + 14.0 * x[1] + 7.0 * x[2] - 56.0,
                x[0] ** 2 + x[1] ** 2 + x[2] ** 2 - 25.0,
            ]
        ),
        num_eq_cons=2,
        f_opt=961.7151721,
    ),
    HSSpec(
        name="hs64",
        obj=lambda x: (
            5.0 * x[0] + 50000.0 / x[0]
            + 20.0 * x[1] + 72000.0 / x[1]
            + 10.0 * x[2] + 144000.0 / x[2]
        ),
        var_lb=np.full(3, 1e-5),
        var_ub=np.full(3, INF),
        x0=np.ones(3),
        cons=lambda x: _vec(x, 
            [1.0 - 4.0 / x[0] - 32.0 / x[1] - 120.0 / x[2]]
        ),
        cons_lb=_a(0.0),
        cons_ub=_a(INF),
        x_opt=_a(108.7347175, 85.12613942, 204.3247078),
        f_opt=6299.842428,
    ),
    HSSpec(
        name="hs65",
        obj=lambda x: (
            (x[0] - x[1]) ** 2
            + (x[0] + x[1] - 10.0) ** 2 / 9.0
            + (x[2] - 5.0) ** 2
        ),
        var_lb=_a(-4.5, -4.5, -5.0),
        var_ub=_a(4.5, 4.5, 5.0),
        x0=_a(-5.0, 5.0, 0.0),  # book start (outside bounds; clipped)
        cons=lambda x: _vec(x, 
            [48.0 - x[0] ** 2 - x[1] ** 2 - x[2] ** 2]
        ),
        cons_lb=_a(0.0),
        cons_ub=_a(INF),
        x_opt=_a(3.650461821, 3.65046168, 4.6204170507),
        f_opt=0.9535288567,
    ),
    HSSpec(
        name="hs66",
        obj=lambda x: 0.2 * x[2] - 0.8 * x[0],
        var_lb=_a(0.0, 0.0, 0.0),
        var_ub=_a(100.0, 100.0, 10.0),
        x0=_a(0.0, 1.05, 2.9),
        cons=lambda x: _vec(x, 
            [x[1] - torch.exp(x[0]), x[2] - torch.exp(x[1])]
        ),
        cons_lb=_a(0.0, 0.0),
        cons_ub=_a(INF, INF),
        x_opt=_a(0.1841264879, 1.202167873, 3.327322322),
        f_opt=0.5181632741,
    ),
    HSSpec(
        name="hs78",
        obj=lambda x: x[0] * x[1] * x[2] * x[3] * x[4],
        var_lb=np.full(5, -INF),
        var_ub=np.full(5, INF),
        x0=_a(-2.0, 1.5, 2.0, -1.0, -1.0),
        cons=lambda x: _vec(x, 
            [
                x[0] ** 2 + x[1] ** 2 + x[2] ** 2 + x[3] ** 2 + x[4] ** 2
                - 10.0,
                x[1] * x[2] - 5.0 * x[3] * x[4],
                x[0] ** 3 + x[1] ** 3 + 1.0,
            ]
        ),
        num_eq_cons=3,
        f_opt=-2.91970041,
    ),
    HSSpec(
        name="hs79",
        obj=lambda x: (
            (x[0] - 1.0) ** 2
            + (x[0] - x[1]) ** 2
            + (x[1] - x[2]) ** 2
            + (x[2] - x[3]) ** 4
            + (x[3] - x[4]) ** 4
        ),
        var_lb=np.full(5, -INF),
        var_ub=np.full(5, INF),
        x0=np.full(5, 2.0),
        cons=lambda x: _vec(x, 
            [
                x[0] + x[1] ** 2 + x[2] ** 3 - 2.0 - 3.0 * math.sqrt(2.0),
                x[1] - x[2] ** 2 + x[3] + 2.0 - 2.0 * math.sqrt(2.0),
                x[0] * x[4] - 2.0,
            ]
        ),
        num_eq_cons=3,
        f_opt=0.0787768209,
    ),
    HSSpec(
        name="hs93",
        obj=lambda x: (
            0.0204 * x[0] * x[3] * (x[0] + x[1] + x[2])
            + 0.0187 * x[1] * x[2] * (x[0] + 1.57 * x[1] + x[3])
            + 0.0607 * x[0] * x[3] * x[4] ** 2 * (x[0] + x[1] + x[2])
            + 0.0437 * x[1] * x[2] * x[5] ** 2 * (x[0] + 1.57 * x[1] + x[3])
        ),
        var_lb=np.zeros(6),
        var_ub=np.full(6, INF),
        x0=_a(5.54, 4.4, 12.02, 11.82, 0.702, 0.852),
        cons=lambda x: _vec(x, 
            [
                0.001 * x[0] * x[1] * x[2] * x[3] * x[4] * x[5] - 2.07,
                1.0
                - 0.00062 * x[0] * x[3] * x[4] ** 2 * (x[0] + x[1] + x[2])
                - 0.00058 * x[1] * x[2] * x[5] ** 2
                * (x[0] + 1.57 * x[1] + x[3]),
            ]
        ),
        cons_lb=_a(0.0, 0.0),
        cons_ub=_a(INF, INF),
        f_opt=135.075961,
    ),
    HSSpec(
        name="hs100",
        obj=lambda x: (
            (x[0] - 10.0) ** 2
            + 5.0 * (x[1] - 12.0) ** 2
            + x[2] ** 4
            + 3.0 * (x[3] - 11.0) ** 2
            + 10.0 * x[4] ** 6
            + 7.0 * x[5] ** 2
            + x[6] ** 4
            - 4.0 * x[5] * x[6]
            - 10.0 * x[5]
            - 8.0 * x[6]
        ),
        var_lb=np.full(7, -INF),
        var_ub=np.full(7, INF),
        x0=_a(1.0, 2.0, 0.0, 4.0, 0.0, 1.0, 1.0),
        cons=lambda x: _vec(x, 
            [
                127.0 - 2.0 * x[0] ** 2 - 3.0 * x[1] ** 4 - x[2]
                - 4.0 * x[3] ** 2 - 5.0 * x[4],
                282.0 - 7.0 * x[0] - 3.0 * x[1] - 10.0 * x[2] ** 2
                - x[3] + x[4],
                196.0 - 23.0 * x[0] - x[1] ** 2 - 6.0 * x[5] ** 2
                + 8.0 * x[6],
                -4.0 * x[0] ** 2 - x[1] ** 2 + 3.0 * x[0] * x[1]
                - 2.0 * x[2] ** 2 - 5.0 * x[5] + 11.0 * x[6],
            ]
        ),
        cons_lb=np.zeros(4),
        cons_ub=np.full(4, INF),
        f_opt=680.6300573,
    ),
    HSSpec(
        name="hs113",
        obj=lambda x: (
            x[0] ** 2 + x[1] ** 2 + x[0] * x[1]
            - 14.0 * x[0] - 16.0 * x[1]
            + (x[2] - 10.0) ** 2
            + 4.0 * (x[3] - 5.0) ** 2
            + (x[4] - 3.0) ** 2
            + 2.0 * (x[5] - 1.0) ** 2
            + 5.0 * x[6] ** 2
            + 7.0 * (x[7] - 11.0) ** 2
            + 2.0 * (x[8] - 10.0) ** 2
            + (x[9] - 7.0) ** 2
            + 45.0
        ),
        var_lb=np.full(10, -INF),
        var_ub=np.full(10, INF),
        x0=_a(2.0, 3.0, 5.0, 5.0, 1.0, 2.0, 7.0, 3.0, 6.0, 10.0),
        cons=lambda x: _vec(x, 
            [
                105.0 - 4.0 * x[0] - 5.0 * x[1] + 3.0 * x[6] - 9.0 * x[7],
                -10.0 * x[0] + 8.0 * x[1] + 17.0 * x[6] - 2.0 * x[7],
                8.0 * x[0] - 2.0 * x[1] - 5.0 * x[8] + 2.0 * x[9] + 12.0,
                -3.0 * (x[0] - 2.0) ** 2 - 4.0 * (x[1] - 3.0) ** 2
                - 2.0 * x[2] ** 2 + 7.0 * x[3] + 120.0,
                -5.0 * x[0] ** 2 - 8.0 * x[1] - (x[2] - 6.0) ** 2
                + 2.0 * x[3] + 40.0,
                -(x[0] ** 2) - 2.0 * (x[1] - 2.0) ** 2 + 2.0 * x[0] * x[1]
                - 14.0 * x[4] + 6.0 * x[5],
                -0.5 * (x[0] - 8.0) ** 2 - 2.0 * (x[1] - 4.0) ** 2
                - 3.0 * x[4] ** 2 + x[5] + 30.0,
                3.0 * x[0] - 6.0 * x[1] - 12.0 * (x[8] - 8.0) ** 2
                + 7.0 * x[9],
            ]
        ),
        cons_lb=np.zeros(8),
        cons_ub=np.full(8, INF),
        f_opt=24.30620907,
    ),
    # ---- round-3 batch 2: constrained-Rosenbrock family, volume /
    # trigonometric equality problems, and the hs51-53 quadratic family
    # completion (book formulations, Hock & Schittkowski 1981)
    HSSpec(
        name="hs15",
        obj=_rosenbrock_obj,
        var_lb=_a(-INF, -INF),
        var_ub=_a(0.5, INF),
        x0=_a(-2.0, 1.0),
        cons=lambda x: _vec(x, [x[0] * x[1] - 1.0, x[0] + x[1] ** 2]),
        cons_lb=np.zeros(2),
        cons_ub=np.full(2, INF),
        x_opt=_a(0.5, 2.0),
        f_opt=306.5,
    ),
    HSSpec(
        name="hs20",
        obj=_rosenbrock_obj,
        var_lb=_a(-0.5, -INF),
        var_ub=_a(0.5, INF),
        x0=_a(-2.0, 1.0),
        cons=lambda x: _vec(x, 
            [
                x[0] + x[1] ** 2,
                x[0] ** 2 + x[1],
                x[0] ** 2 + x[1] ** 2 - 1.0,
            ]
        ),
        cons_lb=np.zeros(3),
        cons_ub=np.full(3, INF),
        # book optimum sits at x1 = +0.5; from the clipped start
        # (-0.5, 1) the projected flow (like any local method started
        # there) converges to the symmetric KKT point at x1 = -0.5 with
        # f = f_opt + 2 — status Optimal, objective locally optimal
        x_opt=_a(0.5, np.sqrt(3.0) / 2.0),
        f_opt=81.5 - 25.0 * np.sqrt(3.0),
    ),
    HSSpec(
        name="hs37",
        obj=lambda x: -x[0] * x[1] * x[2],
        var_lb=np.zeros(3),
        var_ub=np.full(3, 42.0),
        x0=np.full(3, 10.0),
        cons=lambda x: _vec(x, 
            [
                72.0 - x[0] - 2.0 * x[1] - 2.0 * x[2],
                x[0] + 2.0 * x[1] + 2.0 * x[2],
            ]
        ),
        cons_lb=np.zeros(2),
        cons_ub=np.full(2, INF),
        x_opt=_a(24.0, 12.0, 12.0),
        f_opt=-3456.0,
    ),
    HSSpec(
        name="hs41",
        obj=lambda x: 2.0 - x[0] * x[1] * x[2],
        var_lb=np.zeros(4),
        var_ub=_a(1.0, 1.0, 1.0, 2.0),
        x0=np.full(4, 2.0),
        cons=lambda x: _vec(x, [x[0] + 2.0 * x[1] + 2.0 * x[2] - x[3]]),
        num_eq_cons=1,
        x_opt=_a(2.0 / 3.0, 1.0 / 3.0, 1.0 / 3.0, 2.0),
        f_opt=52.0 / 27.0,
    ),
    HSSpec(
        name="hs46",
        obj=lambda x: (
            (x[0] - x[1]) ** 2
            + (x[2] - 1.0) ** 2
            + (x[3] - 1.0) ** 4
            + (x[4] - 1.0) ** 6
        ),
        var_lb=np.full(5, -INF),
        var_ub=np.full(5, INF),
        x0=_a(np.sqrt(2.0) / 2.0, 1.75, 0.5, 2.0, 2.0),
        cons=lambda x: _vec(x, 
            [
                x[0] ** 2 * x[3] + torch.sin(x[3] - x[4]) - 1.0,
                x[1] + x[2] ** 4 * x[3] ** 2 - 2.0,
            ]
        ),
        num_eq_cons=2,
        x_opt=np.ones(5),
        f_opt=0.0,
    ),
    HSSpec(
        name="hs47",
        obj=lambda x: (
            (x[0] - x[1]) ** 2
            + (x[1] - x[2]) ** 3
            + (x[2] - x[3]) ** 4
            + (x[3] - x[4]) ** 4
        ),
        var_lb=np.full(5, -INF),
        var_ub=np.full(5, INF),
        x0=_a(2.0, np.sqrt(2.0), -1.0, 2.0 - np.sqrt(2.0), 0.5),
        cons=lambda x: _vec(x, 
            [
                x[0] + x[1] ** 2 + x[2] ** 3 - 3.0,
                x[1] - x[2] ** 2 + x[3] - 1.0,
                x[0] * x[4] - 1.0,
            ]
        ),
        num_eq_cons=3,
        x_opt=np.ones(5),
        f_opt=0.0,
    ),
    HSSpec(
        name="hs53",
        obj=lambda x: (
            (x[0] - x[1]) ** 2
            + (x[1] + x[2] - 2.0) ** 2
            + (x[3] - 1.0) ** 2
            + (x[4] - 1.0) ** 2
        ),
        var_lb=np.full(5, -10.0),
        var_ub=np.full(5, 10.0),
        x0=np.full(5, 2.0),
        cons=lambda x: _vec(x, 
            [
                x[0] + 3.0 * x[1],
                x[2] + x[3] - 2.0 * x[4],
                x[1] - x[4],
            ]
        ),
        num_eq_cons=3,
        f_opt=176.0 / 43.0,
    ),
    HSSpec(
        name="hs77",
        obj=lambda x: (
            (x[0] - 1.0) ** 2
            + (x[0] - x[1]) ** 2
            + (x[2] - 1.0) ** 2
            + (x[3] - 1.0) ** 4
            + (x[4] - 1.0) ** 6
        ),
        var_lb=np.full(5, -INF),
        var_ub=np.full(5, INF),
        x0=np.full(5, 2.0),
        cons=lambda x: _vec(x, 
            [
                x[0] ** 2 * x[3] + torch.sin(x[3] - x[4]) - 2.0 * np.sqrt(2.0),
                x[1] + x[2] ** 4 * x[3] ** 2 - 8.0 - np.sqrt(2.0),
            ]
        ),
        num_eq_cons=2,
        f_opt=0.24150513,
    ),
    # ---- round-4 batch: degenerate / data-fit / design problems widening
    # the sweep toward the engineering end of the book (Hock &
    # Schittkowski 1981 formulations)
    HSSpec(
        # LICQ fails at the solution (the active constraint gradient
        # vanishes at x*): a classic degeneracy stress test.  Both this
        # framework and the reference end LocallyInfeasible near the
        # optimum (f within 4e-2, 64 vs 68 iterations) — identical
        # degenerate behavior, counted as a reference-parity failure
        name="hs13",
        obj=lambda x: (x[0] - 2.0) ** 2 + x[1] ** 2,
        var_lb=np.zeros(2),
        var_ub=np.full(2, INF),
        x0=_a(-2.0, -2.0),
        cons=lambda x: _vec(x, [(1.0 - x[0]) ** 3 - x[1]]),
        cons_lb=np.zeros(1),
        cons_ub=np.full(1, INF),
        x_opt=_a(1.0, 0.0),
        f_opt=1.0,
    ),
    HSSpec(
        name="hs19",
        obj=lambda x: (x[0] - 10.0) ** 3 + (x[1] - 20.0) ** 3,
        var_lb=_a(13.0, 0.0),
        var_ub=_a(100.0, 100.0),
        x0=_a(20.1, 5.84),
        cons=lambda x: _vec(x, 
            [
                (x[0] - 5.0) ** 2 + (x[1] - 5.0) ** 2 - 100.0,
                82.81 - (x[1] - 5.0) ** 2 - (x[0] - 6.0) ** 2,
            ]
        ),
        cons_lb=np.zeros(2),
        cons_ub=np.full(2, INF),
        x_opt=_a(14.095, 0.84296079),
        # book value -6961.81381 is rounded; this framework and the
        # reference both reach -6961.8138756 on the same formulas
        f_opt=-6961.8138756,
    ),
    HSSpec(
        # 99-term exponential data fit; (u_i - x2)^x3 goes through
        # exp(x3 log(.)), so an infeasible probe yields NaN and rides the
        # reject-and-retry ladder rather than crashing.  The book start
        # sits on an exponentially flat plateau where the KKT residual is
        # already < 1e-6: both this framework and the reference declare
        # Optimal at iteration 0 with f = 32.835 (identical behavior)
        name="hs25",
        obj=lambda x: torch.sum(
            (
                -0.01 * _arange(x, 1.0, 100.0)
                + torch.exp(
                    -((25.0 + (-50.0 * torch.log(0.01 * _arange(x, 1.0, 100.0)))
                       ** (2.0 / 3.0)) - x[1])
                    ** x[2]
                    / x[0]
                )
            )
            ** 2
        ),
        var_lb=_a(0.1, 0.0, 0.0),
        var_ub=_a(100.0, 25.6, 5.0),
        x0=_a(100.0, 12.5, 3.0),
        x_opt=_a(50.0, 25.0, 1.5),
        f_opt=0.0,
    ),
    HSSpec(
        name="hs32",
        obj=lambda x: (x[0] + 3.0 * x[1] + x[2]) ** 2 + 4.0 * (x[0] - x[1]) ** 2,
        var_lb=np.zeros(3),
        var_ub=np.full(3, INF),
        x0=_a(0.1, 0.7, 0.2),
        cons=lambda x: _vec(x, 
            [
                1.0 - x[0] - x[1] - x[2],
                6.0 * x[1] + 4.0 * x[2] - x[0] ** 3 - 3.0,
            ]
        ),
        cons_lb=np.zeros(2),
        cons_ub=_a(0.0, INF),  # first is an equality, second one-sided
        x_opt=_a(0.0, 0.0, 1.0),
        f_opt=1.0,
    ),
    HSSpec(
        name="hs61",
        obj=lambda x: (
            4.0 * x[0] ** 2
            + 2.0 * x[1] ** 2
            + 2.0 * x[2] ** 2
            - 33.0 * x[0]
            + 16.0 * x[1]
            - 24.0 * x[2]
        ),
        var_lb=np.full(3, -INF),
        var_ub=np.full(3, INF),
        x0=np.zeros(3),
        cons=lambda x: _vec(x, 
            [
                3.0 * x[0] - 2.0 * x[1] ** 2 - 7.0,
                4.0 * x[0] - x[2] ** 2 - 11.0,
            ]
        ),
        num_eq_cons=2,
        x_opt=_a(5.326770157, -2.118998639, 3.210464239),
        f_opt=-143.6461422,
    ),
    HSSpec(
        # mixture/blending with log terms; feasible region keeps every
        # log argument positive.  Badly scaled objective (~1e4 slopes):
        # at default NoScaling both sides converge slowly (ours 2401 its,
        # reference 680 — drifting lambda trajectories on an ill-scaled
        # flow); with scaling_type=GradJac both need 15 iterations
        name="hs62",
        obj=lambda x: -32.174
        * (
            255.0
            * torch.log((x[0] + x[1] + x[2] + 0.03) / (0.09 * x[0] + x[1] + x[2] + 0.03))
            + 280.0 * torch.log((x[1] + x[2] + 0.03) / (0.07 * x[1] + x[2] + 0.03))
            + 290.0 * torch.log((x[2] + 0.03) / (0.13 * x[2] + 0.03))
        ),
        var_lb=np.zeros(3),
        var_ub=np.ones(3),
        x0=_a(0.7, 0.2, 0.1),
        cons=lambda x: _vec(x, [x[0] + x[1] + x[2] - 1.0]),
        num_eq_cons=1,
        x_opt=_a(0.6178126908, 0.3282020500, 0.0539852592),
        f_opt=-26272.51448,
    ),
    HSSpec(
        # both sides converge ~1e-2 below the book's rounded f* (ours
        # 727.6700, reference 727.6696 on the same formulas) — the book
        # optimum is quoted to limited precision
        name="hs72",
        obj=lambda x: 1.0 + x[0] + x[1] + x[2] + x[3],
        var_lb=np.full(4, 0.001),
        var_ub=_a(4e5, 3e5, 2e5, 1e5),
        x0=np.ones(4),
        cons=lambda x: _vec(x, 
            [
                0.0401 - 4.0 / x[0] - 2.25 / x[1] - 1.0 / x[2] - 0.25 / x[3],
                0.010085
                - 0.16 / x[0]
                - 0.36 / x[1]
                - 0.64 / x[2]
                - 0.64 / x[3],
            ]
        ),
        cons_lb=np.zeros(2),
        cons_ub=np.full(2, INF),
        x_opt=_a(193.4071, 179.5475, 185.0186, 168.7062),
        f_opt=727.67937,
    ),
    HSSpec(
        # cattle-feed: probabilistic constraint via a sqrt term
        name="hs73",
        obj=lambda x: 24.55 * x[0] + 26.75 * x[1] + 39.0 * x[2] + 40.50 * x[3],
        var_lb=np.zeros(4),
        var_ub=np.full(4, INF),
        x0=np.ones(4),
        cons=lambda x: _vec(x, 
            [
                2.3 * x[0] + 5.6 * x[1] + 11.1 * x[2] + 1.3 * x[3] - 5.0,
                12.0 * x[0]
                + 11.9 * x[1]
                + 41.8 * x[2]
                + 52.1 * x[3]
                - 21.0
                - 1.645
                * torch.sqrt(
                    0.28 * x[0] ** 2
                    + 0.19 * x[1] ** 2
                    + 20.5 * x[2] ** 2
                    + 0.62 * x[3] ** 2
                ),
                x[0] + x[1] + x[2] + x[3] - 1.0,
            ]
        ),
        cons_lb=_a(0.0, 0.0, 0.0),
        cons_ub=_a(INF, INF, 0.0),  # last is the equality
        x_opt=_a(0.6355216, 0.0, 0.3127019, 0.05177655),
        f_opt=29.894378,
    ),
    HSSpec(
        # hs78/79 family completion: exp objective, bounded variables
        name="hs80",
        obj=lambda x: torch.exp(x[0] * x[1] * x[2] * x[3] * x[4]),
        var_lb=_a(-2.3, -2.3, -3.2, -3.2, -3.2),
        var_ub=_a(2.3, 2.3, 3.2, 3.2, 3.2),
        x0=_a(-2.0, 2.0, 2.0, -1.0, -1.0),
        cons=lambda x: _vec(x, 
            [
                x[0] ** 2 + x[1] ** 2 + x[2] ** 2 + x[3] ** 2 + x[4] ** 2 - 10.0,
                x[1] * x[2] - 5.0 * x[3] * x[4],
                x[0] ** 3 + x[1] ** 3 + 1.0,
            ]
        ),
        num_eq_cons=3,
        x_opt=_a(-1.717143, 1.595709, 1.827247, -0.7636413, -0.7636450),
        f_opt=0.0539498,
    ),
    HSSpec(
        # nonconvex: from the book start both this framework and the
        # reference converge to the SAME secondary KKT point with
        # f = 0.4388512 (identical to 7 digits; the -0.5 c3^2 term bends
        # the off-manifold flow away from the hs80 basin)
        name="hs81",
        obj=lambda x: (
            torch.exp(x[0] * x[1] * x[2] * x[3] * x[4])
            - 0.5 * (x[0] ** 3 + x[1] ** 3 + 1.0) ** 2
        ),
        var_lb=_a(-2.3, -2.3, -3.2, -3.2, -3.2),
        var_ub=_a(2.3, 2.3, 3.2, 3.2, 3.2),
        x0=_a(-2.0, 2.0, 2.0, -1.0, -1.0),
        cons=lambda x: _vec(x, 
            [
                x[0] ** 2 + x[1] ** 2 + x[2] ** 2 + x[3] ** 2 + x[4] ** 2 - 10.0,
                x[1] * x[2] - 5.0 * x[3] * x[4],
                x[0] ** 3 + x[1] ** 3 + 1.0,
            ]
        ),
        num_eq_cons=3,
        x_opt=_a(-1.717143, 1.595709, 1.827247, -0.7636413, -0.7636450),
        f_opt=0.0539498,
    ),
    HSSpec(
        # heat-exchanger design: badly scaled bilinear constraints.  BOTH
        # sides fail at default scaling from the book start — the
        # reference aborts with the lambda-limit "incorrect derivatives?"
        # error, this framework grinds to IterationLimit (same failure
        # class; the lambda trajectories of failing solves differ).  WITH
        # scaling (the point of the ScalingType machinery on problems
        # like this) both sides solve it: scaling_type=GradJac ours 362
        # its vs reference 659, both f=7049.25; with the equilibrated-KKT
        # scaling ours solves in 180 its where the reference hits its
        # iteration limit
        name="hs106",
        obj=lambda x: x[0] + x[1] + x[2],
        var_lb=_a(100.0, 1000.0, 1000.0, 10.0, 10.0, 10.0, 10.0, 10.0),
        var_ub=_a(10000.0, 10000.0, 10000.0, 1000.0, 1000.0, 1000.0, 1000.0, 1000.0),
        x0=_a(5000.0, 5000.0, 5000.0, 200.0, 350.0, 150.0, 225.0, 425.0),
        cons=lambda x: _vec(x, 
            [
                1.0 - 0.0025 * (x[3] + x[5]),
                1.0 - 0.0025 * (x[4] + x[6] - x[3]),
                1.0 - 0.01 * (x[7] - x[4]),
                x[0] * x[5] - 833.33252 * x[3] - 100.0 * x[0] + 83333.333,
                x[1] * x[6] - 1250.0 * x[4] - x[1] * x[3] + 1250.0 * x[3],
                x[2] * x[7] - 1250000.0 - x[2] * x[4] + 2500.0 * x[4],
            ]
        ),
        cons_lb=np.zeros(6),
        cons_ub=np.full(6, INF),
        x_opt=_a(
            579.3167, 1359.943, 5110.071, 182.0174,
            295.5985, 217.9799, 286.4162, 395.5979,
        ),
        f_opt=7049.330923,
    ),
    HSSpec(
        # separable log barrier against both bound ends + geometric-mean
        # coupling; smooth interior optimum
        name="hs110",
        obj=lambda x: (
            torch.sum(torch.log(x - 2.0) ** 2 + torch.log(10.0 - x) ** 2)
            - torch.prod(x) ** 0.2
        ),
        var_lb=np.full(10, 2.001),
        var_ub=np.full(10, 9.999),
        x0=np.full(10, 9.0),
        x_opt=np.full(10, 9.35025655),
        f_opt=-45.77846971,
    ),
    HSSpec(
        # chemical equilibrium in log variables (the well-posed transform
        # of hs112): sum of exponentials with 3 mass-balance equalities
        name="hs111",
        obj=lambda x: torch.sum(
            torch.exp(x)
            * (
                _vec(x, 
                    [
                        -6.089, -17.164, -34.054, -5.914, -24.721,
                        -14.986, -24.100, -10.708, -26.662, -22.179,
                    ]
                )
                + x
                - torch.log(torch.sum(torch.exp(x)))
            )
        ),
        var_lb=np.full(10, -100.0),
        var_ub=np.full(10, 100.0),
        x0=np.full(10, -2.3),
        cons=lambda x: _vec(x, 
            [
                torch.exp(x[0]) + 2.0 * torch.exp(x[1]) + 2.0 * torch.exp(x[2])
                + torch.exp(x[5]) + torch.exp(x[9]) - 2.0,
                torch.exp(x[3]) + 2.0 * torch.exp(x[4]) + torch.exp(x[5])
                + torch.exp(x[6]) - 1.0,
                torch.exp(x[2]) + torch.exp(x[6]) + torch.exp(x[7])
                + 2.0 * torch.exp(x[8]) + torch.exp(x[9]) - 1.0,
            ]
        ),
        num_eq_cons=3,
        f_opt=-47.76109086,
    ),
    HSSpec(
        # 15-var staircase QP with ranged difference constraints — a
        # ranged-inequality (two-sided slack) stress test
        name="hs118",
        obj=lambda x: sum(
            2.3 * x[3 * k]
            + 0.0001 * x[3 * k] ** 2
            + 1.7 * x[3 * k + 1]
            + 0.0001 * x[3 * k + 1] ** 2
            + 2.2 * x[3 * k + 2]
            + 0.00015 * x[3 * k + 2] ** 2
            for k in range(5)
        ),
        var_lb=_a(8.0, 43.0, 3.0, *([0.0] * 12)),
        var_ub=_a(
            21.0, 57.0, 16.0,
            90.0, 120.0, 60.0,
            90.0, 120.0, 60.0,
            90.0, 120.0, 60.0,
            90.0, 120.0, 60.0,
        ),
        x0=_a(20.0, 55.0, 15.0, 20.0, 60.0, 20.0, 20.0, 60.0, 20.0,
              20.0, 60.0, 20.0, 20.0, 60.0, 20.0),
        cons=lambda x: torch.cat(
            [
                _vec(x, 
                    [x[3 * k] - x[3 * k - 3] + 7.0 for k in range(1, 5)]
                ),
                _vec(x, 
                    [x[3 * k + 1] - x[3 * k - 2] + 7.0 for k in range(1, 5)]
                ),
                _vec(x, 
                    [x[3 * k + 2] - x[3 * k - 1] + 7.0 for k in range(1, 5)]
                ),
                _vec(x, 
                    [
                        x[0] + x[1] + x[2],
                        x[3] + x[4] + x[5],
                        x[6] + x[7] + x[8],
                        x[9] + x[10] + x[11],
                        x[12] + x[13] + x[14],
                    ]
                ),
            ]
        ),
        cons_lb=np.concatenate(
            [np.zeros(12), _a(60.0, 50.0, 70.0, 85.0, 100.0)]
        ),
        cons_ub=np.concatenate(
            [np.full(4, 13.0), np.full(4, 14.0), np.full(4, 13.0),
             np.full(5, INF)]
        ),
        f_opt=664.8204500,
    ),
    # ---- round-4 batch 2: the classic engineering quintet (book
    # formulations; verification is book optimum where quoted precisely,
    # reference parity otherwise)
    HSSpec(
        # Himmelblau's process-design problem: quadratic objective,
        # three ranged quadratic constraints with empirical coefficients
        name="hs83",
        obj=lambda x: (
            5.3578547 * x[2] ** 2
            + 0.8356891 * x[0] * x[4]
            + 37.293239 * x[0]
            - 40792.141
        ),
        var_lb=_a(78.0, 33.0, 27.0, 27.0, 27.0),
        var_ub=_a(102.0, 45.0, 45.0, 45.0, 45.0),
        x0=_a(78.0, 33.0, 27.0, 27.0, 27.0),
        cons=lambda x: _vec(x, 
            [
                85.334407 + 0.0056858 * x[1] * x[4]
                + 0.0006262 * x[0] * x[3] - 0.0022053 * x[2] * x[4],
                80.51249 + 0.0071317 * x[1] * x[4]
                + 0.0029955 * x[0] * x[1] + 0.0021813 * x[2] ** 2,
                9.300961 + 0.0047026 * x[2] * x[4]
                + 0.0012547 * x[0] * x[2] + 0.0019085 * x[2] * x[3],
            ]
        ),
        cons_lb=_a(0.0, 90.0, 20.0),
        cons_ub=_a(92.0, 110.0, 25.0),
        x_opt=_a(78.0, 33.0, 29.9952560, 45.0, 36.7758129),
        f_opt=-30665.53867,
    ),
    HSSpec(
        # Colville No.1: cubic-polynomial objective over 10 linear
        # inequalities (dense data tables)
        name="hs86",
        obj=lambda x: (
            _vec(x, [-15.0, -27.0, -36.0, -18.0, -12.0]) @ x
            + x
            @ _vec(x, 
                [
                    [30.0, -20.0, -10.0, 32.0, -10.0],
                    [-20.0, 39.0, -6.0, -31.0, 32.0],
                    [-10.0, -6.0, 10.0, -6.0, -10.0],
                    [32.0, -31.0, -6.0, 39.0, -20.0],
                    [-10.0, 32.0, -10.0, -20.0, 30.0],
                ]
            )
            @ x
            + _vec(x, [4.0, 8.0, 10.0, 6.0, 2.0]) @ x**3
        ),
        var_lb=np.zeros(5),
        var_ub=np.full(5, INF),
        x0=_a(0.0, 0.0, 0.0, 0.0, 1.0),
        cons=lambda x: _vec(x, 
            [
                [-16.0, 2.0, 0.0, 1.0, 0.0],
                [0.0, -2.0, 0.0, 0.4, 2.0],
                [-3.5, 0.0, 2.0, 0.0, 0.0],
                [0.0, -2.0, 0.0, -4.0, -1.0],
                [0.0, -9.0, -2.0, 1.0, -2.8],
                [2.0, 0.0, -4.0, 0.0, 0.0],
                [-1.0, -1.0, -1.0, -1.0, -1.0],
                [-1.0, -2.0, -3.0, -2.0, -1.0],
                [1.0, 2.0, 3.0, 4.0, 5.0],
                [1.0, 1.0, 1.0, 1.0, 1.0],
            ]
        )
        @ x,
        cons_lb=_a(-40.0, -2.0, -0.25, -4.0, -4.0, -1.0, -40.0, -60.0, 5.0, 1.0),
        cons_ub=np.full(10, INF),
        x_opt=_a(0.3, 0.33346761, 0.4, 0.42831010, 0.22396487),
        f_opt=-32.34867897,
    ),
    HSSpec(
        # alkylation-reactor design: fractional powers, a ranged
        # constraint on the objective expression itself.  At default
        # scaling BOTH sides stall at the ranged constraint's upper end
        # (IterationLimit at f=4.1978, identical); with GradJac scaling
        # both solve it (ours 33 its / reference 31, f=3.951163 = book),
        # and with equilibrated-KKT scaling ours solves in 25 its where
        # the reference hits its iteration limit (same pattern as hs106)
        name="hs104",
        obj=lambda x: (
            0.4 * x[0] ** 0.67 * x[6] ** (-0.67)
            + 0.4 * x[1] ** 0.67 * x[7] ** (-0.67)
            + 10.0 - x[0] - x[1]
        ),
        var_lb=np.full(8, 0.1),
        var_ub=np.full(8, 10.0),
        x0=_a(6.0, 3.0, 0.4, 0.2, 6.0, 6.0, 1.0, 0.5),
        cons=lambda x: _vec(x, 
            [
                1.0 - 0.0588 * x[4] * x[6] - 0.1 * x[0],
                1.0 - 0.0588 * x[5] * x[7] - 0.1 * x[0] - 0.1 * x[1],
                1.0 - 4.0 * x[2] / x[4] - 2.0 / (x[2] ** 0.71 * x[4])
                - 0.0588 * x[6] / x[2] ** 1.3,
                1.0 - 4.0 * x[3] / x[5] - 2.0 / (x[3] ** 0.71 * x[5])
                - 0.0588 * x[7] / x[3] ** 1.3,
                0.4 * x[0] ** 0.67 * x[6] ** (-0.67)
                + 0.4 * x[1] ** 0.67 * x[7] ** (-0.67)
                + 10.0 - x[0] - x[1],
            ]
        ),
        cons_lb=_a(0.0, 0.0, 0.0, 0.0, 1.0),
        cons_ub=_a(INF, INF, INF, INF, 4.2),
        f_opt=3.9511634396,
    ),
    HSSpec(
        # maximal hexagon area in a unit-diameter set: strongly nonconvex
        # with many symmetric local optima — verification is parity, both
        # sides starting from the book point
        name="hs108",
        obj=lambda x: -0.5
        * (
            x[0] * x[3] - x[1] * x[2] + x[2] * x[8] - x[4] * x[8]
            + x[4] * x[7] - x[5] * x[6]
        ),
        var_lb=np.concatenate([np.full(8, -INF), _a(0.0)]),
        var_ub=np.full(9, INF),
        x0=np.ones(9),
        cons=lambda x: _vec(x, 
            [
                1.0 - x[2] ** 2 - x[3] ** 2,
                1.0 - x[8] ** 2,
                1.0 - x[4] ** 2 - x[5] ** 2,
                1.0 - x[0] ** 2 - (x[1] - x[8]) ** 2,
                1.0 - (x[0] - x[4]) ** 2 - (x[1] - x[5]) ** 2,
                1.0 - (x[0] - x[6]) ** 2 - (x[1] - x[7]) ** 2,
                1.0 - (x[2] - x[4]) ** 2 - (x[3] - x[5]) ** 2,
                1.0 - (x[2] - x[6]) ** 2 - (x[3] - x[7]) ** 2,
                1.0 - x[6] ** 2 - (x[7] - x[8]) ** 2,
                x[0] * x[3] - x[1] * x[2],
                x[2] * x[8],
                -x[4] * x[8],
                x[4] * x[7] - x[5] * x[6],
            ]
        ),
        cons_lb=np.zeros(13),
        cons_ub=np.full(13, INF),
        f_opt=-0.8660254038,
    ),
    HSSpec(
        # chemical equilibrium in mole numbers — the linear-constraint
        # form of hs111 (the book quotes f* = -47.707579 from a
        # lower-precision solution; the true optimum matches hs111's
        # -47.76109086, which both this framework and the reference reach)
        name="hs112",
        obj=lambda x: torch.sum(
            x
            * (
                _vec(x, 
                    [
                        -6.089, -17.164, -34.054, -5.914, -24.721,
                        -14.986, -24.100, -10.708, -26.662, -22.179,
                    ]
                )
                + torch.log(x / torch.sum(x))
            )
        ),
        var_lb=np.full(10, 1e-6),
        var_ub=np.full(10, INF),
        x0=np.full(10, 0.1),
        cons=lambda x: _vec(x, 
            [
                x[0] + 2.0 * x[1] + 2.0 * x[2] + x[5] + x[9] - 2.0,
                x[3] + 2.0 * x[4] + x[5] + x[6] - 1.0,
                x[2] + x[6] + x[7] + 2.0 * x[8] + x[9] - 1.0,
            ]
        ),
        num_eq_cons=3,
        f_opt=-47.76109086,
    ),
]

HS_BY_NAME = {spec.name: spec for spec in HS_SPECS}
