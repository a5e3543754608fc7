"""The configurations of the port-against-JAX parity harness, and the port's
side of it.

This module imports no JAX, so that ``chip_smoke.py`` can run the port's
side on the card.  ``tools/torch_parity_check.py`` runs the JAX package on
the same cases and holds the two against each other.

The cases are those of ``benchmarks/parity_check.py`` (which compared the
JAX package with the original pygradflow):

- the 49 Hock-Schittkowski specs of ``runners/hs.py`` at ``Params()``, from
  each spec's start with y = 0 (hs104 capped at 2,000 iterations);
- 39 option cases: Rosenbrock, HS71 (explicit slack) and Tame at the
  defaults and under each Newton type, step solver, step control (with
  rho = 0.1) and penalty update;
- the continuous engine on four small problems, host and device loops, at
  ``Params(iteration_limit=1000, rho=1e-2)``; the port's side uses the
  problems with written-out derivatives;
- the pendulum swing-up on the mixed-precision LDL^T tier at N = 128 (KKT
  644, the right-looking kernel) and N = 256 (KKT 1284, the left-looking
  one).

``EXPECTED_PARTINGS`` lists the cases where the port's counts or iterates
part from the JAX package's, each with the ROADMAP Queue C entry that records it.
Such a case is held to the same status and, when Optimal, objectives
within ``OBJ_RTOL``; every other case to equal status and counts and x, y
within ``X_TOL[device]``.
"""

from typing import NamedTuple

import numpy as np
import torch

from pygradflow_torch import Params, Problem, Solver
from pygradflow_torch.integration import IntegrationSolver

HS_CASES = [
    "hs8", "hs11", "hs16", "hs23", "hs31", "hs33", "hs52", "hs76",
    "hs34", "hs39", "hs40", "hs44", "hs60", "hs63", "hs64", "hs65",
    "hs66", "hs78", "hs79", "hs93", "hs100", "hs113",
    "hs15", "hs20", "hs37", "hs41", "hs46", "hs47", "hs53", "hs77",
    "hs13", "hs19", "hs25", "hs32", "hs61", "hs62", "hs72", "hs73",
    "hs80", "hs81", "hs106", "hs110", "hs111", "hs118",
    "hs83", "hs86", "hs104", "hs108", "hs112",
]  # fmt: skip
HS_KWARGS = {"hs104": {"iteration_limit": 2000}}

OPTION_PROBLEMS = ["rosenbrock", "hs71", "tame"]
OPTION_KWARGS = (
    [{}]
    + [{"newton_type": nt} for nt in ["Simplified", "Full", "ActiveSet", "Globalized"]]
    + [{"step_solver_type": s} for s in ["Standard", "Asymmetric", "Symmetric", "Extended"]]
    + [{"step_control_type": c, "rho": 1e-1} for c in ["ResiduumRatio", "Exact"]]
    + [{"penalty_update": p} for p in ["Constant", "DualNorm"]]
)

INTEGRATION_PROBLEMS = ["simple", "unbounded", "tame", "hs71"]
INTEGRATION_KWARGS = dict(iteration_limit=1000, rho=1e-2)

PENDULUM_N = [128, 256]
PENDULUM_KWARGS = dict(linear_solver_type="PallasLDLT", iteration_limit=3000, validate_input=False)

STARTS = {
    "rosenbrock": (np.array([0.0, 0.0]), np.array([])),
    "hs71": (np.array([1.0, 5.0, 5.0, 1.0, 0.0]), np.array([0.0, 0.0])),
    "tame": (np.array([0.0, 0.0]), np.array([0.0])),
    "simple": (np.array([10.0]), np.array([])),
    "unbounded": (np.array([0.0]), np.array([])),
}

X_TOL = {"cpu": 1e-8, "cuda": 1e-6}
"""x and y against the JAX package's, scaled by max(1, |the JAX value|_inf)
(PERF.md section 2)."""
OBJ_RTOL = 1e-6
"""Objectives of an expected parting that ends Optimal, relative to
max(1, |f|)."""

EXPECTED_PARTINGS = {
    "hs13": "ROADMAP Queue C, 'The HS sweep': degenerate at x* (LICQ fails); both LocallyInfeasible",
    "hs44": "ROADMAP Queue C, 'The HS sweep': DistanceRatio amplifies last bits after the first step",
    "hs62": "ROADMAP Queue C, 'The HS sweep': the log terms' rounding; both Optimal",
    "hs104": "ROADMAP Queue C, 'The HS sweep': both IterationLimit at 2,000 with equal counts, the "
    "unconverged iterates 7e-6 apart",
    "hs106": "ROADMAP Queue C, 'The HS sweep': both IterationLimit at 10,000, the iterates 3e-8 apart",
    "hs118": "ROADMAP Queue C, 'The HS sweep': both Optimal at one objective",
}
"""Cases whose counts or iterates part, port against JAX, with the entry that records
each.  The card may part from the CPU where these do; ``CARD_PARTINGS``
adds what the card alone parts."""

CARD_PARTINGS = {}
"""Cases that part from the JAX package on the card only, with their Queue
C entry (the card's products round differently from the CPU's)."""


class Case(NamedTuple):
    name: str
    kind: str  # "hs", "option", "integration" or "pendulum"
    problem: str
    kwargs: dict


def _label(problem, kwargs):
    return problem + "".join(f" {k}={v}" for k, v in kwargs.items())


def cases():
    out = [Case(name, "hs", name, HS_KWARGS.get(name, {})) for name in HS_CASES]
    for problem in OPTION_PROBLEMS:
        out += [Case(_label(problem, kw), "option", problem, kw) for kw in OPTION_KWARGS]
    for problem in INTEGRATION_PROBLEMS:
        for mode in ("host", "device"):
            kw = dict(INTEGRATION_KWARGS, integration_device_loop=mode == "device")
            out.append(Case(f"integration:{problem}:{mode}", "integration", problem, kw))
    out += [Case(f"pendulum N={N}", "pendulum", f"pendulum{N}", PENDULUM_KWARGS) for N in PENDULUM_N]
    return out


CASES = {case.name: case for case in cases()}


# -- the port's problems -------------------------------------------------------


class Rosenbrock(Problem):
    """The 2D Rosenbrock function, unconstrained; optimum (1, 1)."""

    def __init__(self):
        super().__init__(np.full(2, -np.inf), np.full(2, np.inf))

    def obj(self, v):
        return (1.0 - v[0]) ** 2 + 100.0 * (v[1] - v[0] ** 2) ** 2


class HS71(Problem):
    """Hock-Schittkowski 71 with both nonlinear constraints as equalities
    through an explicit slack variable."""

    def __init__(self):
        super().__init__(np.array([1.0, 1.0, 1.0, 1.0, 0.0]), np.array([5.0, 5.0, 5.0, 5.0, np.inf]), num_cons=2)

    def obj(self, x):
        xx = x[:-1]
        return xx[0] * xx[3] * (xx[0] + xx[1] + xx[2]) + xx[2]

    def cons(self, x):
        xx = x[:-1]
        return torch.stack([torch.prod(xx) - x[-1] - 25.0, torch.dot(xx, xx) - 40.0])


class Tame(Problem):
    """Two variables and one linear constraint; Newton converges in one step."""

    def __init__(self):
        super().__init__(np.full(2, -np.inf), np.full(2, np.inf), num_cons=1)

    def obj(self, z):
        return (z[0] - z[1]) ** 2

    def cons(self, z):
        return (z[0] + z[1] - 1.0)[None]


class HS71Explicit(HS71):
    """``HS71`` with its derivatives written out elementwise: a lane, the
    CPU and the card evaluate them in one order, as the continuous
    engine's event decisions need."""

    def obj(self, x):
        return x[0] * x[3] * (x[0] + x[1] + x[2]) + x[2]

    def obj_grad(self, x):
        s = x[0] + x[1] + x[2]
        x0x3 = x[0] * x[3]
        return torch.stack([x[3] * s + x0x3, x0x3, x0x3 + 1.0, x[0] * s, torch.zeros_like(s)])

    def cons(self, x):
        return torch.stack(
            [x[0] * x[1] * x[2] * x[3] - x[4] - 25.0, x[0] * x[0] + x[1] * x[1] + x[2] * x[2] + x[3] * x[3] - 40.0]
        )

    def cons_jac(self, x):
        a, b, c, d = x[0], x[1], x[2], x[3]
        zero = torch.zeros_like(a)
        return torch.stack(
            [
                torch.stack([b * c * d, a * c * d, a * b * d, a * b * c, zero - 1.0]),
                torch.stack([2.0 * a, 2.0 * b, 2.0 * c, 2.0 * d, zero]),
            ]
        )

    def lag_hess(self, x, y):
        a, b, c, d = x[0], x[1], x[2], x[3]
        y0, y1 = y[0], y[1]
        zero = torch.zeros_like(a)
        diag = 2.0 * y1
        h01 = d + y0 * (c * d)
        h02 = d + y0 * (b * d)
        h03 = (2.0 * a + b + c) + y0 * (b * c)
        h12 = y0 * (a * d)
        h13 = a + y0 * (a * c)
        h23 = a + y0 * (a * b)
        return torch.stack(
            [
                torch.stack([2.0 * d + diag, h01, h02, h03, zero]),
                torch.stack([h01, diag, h12, h13, zero]),
                torch.stack([h02, h12, diag, h23, zero]),
                torch.stack([h03, h13, h23, diag, zero]),
                torch.stack([zero, zero, zero, zero, zero]),
            ]
        )


class TameExplicit(Tame):
    """``Tame`` with its derivatives written out."""

    def obj_grad(self, z):
        d = 2.0 * (z[0] - z[1])
        return torch.stack([d, -d])

    def cons_jac(self, z):
        one = torch.ones_like(z[0])
        return torch.stack([torch.stack([one, one])])

    def lag_hess(self, z, y):
        two = torch.full_like(z[0], 2.0)
        return torch.stack([torch.stack([two, -two]), torch.stack([-two, two])])


class Simple(Problem):
    """``x^2 / 2`` on the line, derivatives written out."""

    def __init__(self):
        super().__init__(np.array([-np.inf]), np.array([np.inf]))

    def obj(self, x):
        return 0.5 * x[0] ** 2

    def obj_grad(self, x):
        return x

    def lag_hess(self, x, y):
        return torch.ones_like(x)[:, None]


class Unbounded(Problem):
    """``min x`` on the line, derivatives written out."""

    def __init__(self):
        super().__init__(np.array([-np.inf]), np.array([np.inf]))

    def obj(self, x):
        return x[0]

    def obj_grad(self, x):
        return torch.ones_like(x)

    def lag_hess(self, x, y):
        return torch.zeros_like(x)[:, None]


def hs_start(spec):
    """An HS spec's start: its x0, and y = 0 for each constraint."""
    m = len(spec.cons_lb) if spec.cons_lb is not None else (spec.num_eq_cons or 0)
    return np.asarray(spec.x0, dtype=np.float64), np.zeros(m)


def torch_problem(case: Case):
    """The port's problem of ``case``, its start (x0, y0 as numpy arrays,
    y0 None for the pendulum) and the objective to compare."""
    if case.kind == "hs":
        from pygradflow_torch.runners.hs import HS_BY_NAME

        spec = HS_BY_NAME[case.problem]
        problem = spec.problem()
        return problem, *hs_start(spec), problem.obj
    if case.kind == "pendulum":
        from pygradflow_torch.runners.control import PendulumControl

        problem = PendulumControl(N=int(case.problem[len("pendulum"):]))
        return problem, problem.x0_trajectory(), None, problem.obj
    if case.kind == "integration":
        problem = {"simple": Simple, "unbounded": Unbounded, "tame": TameExplicit, "hs71": HS71Explicit}[case.problem]()
    else:
        problem = {"rosenbrock": Rosenbrock, "hs71": HS71, "tame": Tame}[case.problem]()
    return problem, *STARTS[case.problem], problem.obj


def row(case: Case, result, x, y, obj):
    """One harness row from a result and its x, y as numpy arrays."""
    out = dict(
        case=case.name,
        status=result.status.name,
        iterations=int(result.iterations),
        accepted=int(result.num_accepted_steps),
        x=[float(v) for v in x],
        y=[float(v) for v in y],
        obj=float(obj),
    )
    if case.kind == "integration":
        out.update(segments=int(result.iterations), steps=int(result.num_integration_steps))
    return out


def run_torch(name, device="cpu"):
    """The port's row of the case ``name`` on ``device``."""
    case = CASES[name]
    problem, x0, y0, obj = torch_problem(case)
    params = Params(**case.kwargs)
    cls = IntegrationSolver if case.kind == "integration" else Solver
    t = lambda a: None if a is None else torch.as_tensor(a, dtype=torch.float64, device=device)  # noqa: E731
    result = cls(problem, params, device=device).solve(t(x0), t(y0))
    x = result.x.detach().to(torch.float64)
    f = obj(x).item()
    return row(case, result, x.cpu().numpy(), result.y.detach().cpu().numpy(), f)


def _scaled_diff(ours, ref):
    ours, ref = np.asarray(ours, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    if ours.shape != ref.shape:
        return np.inf
    if ref.size == 0:
        return 0.0
    return float(np.max(np.abs(ours - ref)) / max(1.0, float(np.max(np.abs(ref)))))


def compare(ours, ref, device="cpu", partings=None):
    """The verdict on one case: ("equal" | "parted as expected" | "FAILED",
    details).  ``partings`` are the expected partings on ``device``."""
    if partings is None:
        partings = expected_partings(device)
    dx, dy = _scaled_diff(ours["x"], ref["x"]), _scaled_diff(ours["y"], ref["y"])
    counts = ("iterations", "accepted", "segments", "steps")
    same_counts = all(ours.get(k) == ref.get(k) for k in counts)
    details = dict(dx=dx, dy=dy, ours={k: ours.get(k) for k in ("status",) + counts if k in ours},
                   jax={k: ref.get(k) for k in ("status",) + counts if k in ref})
    name = ours["case"]
    if name in partings:
        ok = ours["status"] == ref["status"]
        if ok and ref["status"] == "Optimal":
            dobj = abs(ours["obj"] - ref["obj"]) / max(1.0, abs(ref["obj"]))
            details["dobj"] = dobj
            ok = dobj <= OBJ_RTOL
        return ("parted as expected" if ok else "FAILED"), details
    tol = X_TOL["cuda" if str(device).startswith("cuda") else "cpu"]
    ok = ours["status"] == ref["status"] and same_counts and dx <= tol and dy <= tol
    return ("equal" if ok else "FAILED"), details


def expected_partings(device="cpu"):
    out = dict(EXPECTED_PARTINGS)
    if str(device).startswith("cuda"):
        out.update(CARD_PARTINGS)
    return out


def format_line(name, verdict, details):
    o, j = details["ours"], details["jax"]

    def counts(d):
        return "/".join(str(d[k]) for k in ("iterations", "accepted", "segments", "steps") if k in d)

    extra = f" |dobj| {details['dobj']:.2e}" if "dobj" in details else ""
    return (
        f"{verdict:>19s}  {name:<52s} port {o['status']} {counts(o)}  jax {j['status']} {counts(j)}"
        f"  |dx| {details['dx']:.2e} |dy| {details['dy']:.2e}{extra}"
    )
