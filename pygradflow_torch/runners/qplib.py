"""QPLIB file reader (the port's own copy of ``pygradflow_tpu/runners/qplib.py``).

Reads the QPLIB format (Furini et al., "QPLIB: a library of quadratic
programming instances"): quadratic/linear objective and constraints with
default-value run-length encoding, producing dense numpy matrices for
:class:`pygradflow_torch.problem.QuadraticProblem`.

Supports the continuous problem classes (QP/QCQP objectives are read; only
linear constraints are kept — quadratic constraint matrices are rejected
explicitly, like the reference adapter which targets QP instances).
"""

from typing import NamedTuple

import numpy as np

INF = 1e20


class QPLIBData(NamedTuple):
    name: str
    sense: str  # 'minimize' / 'maximize'
    Q: np.ndarray
    c: np.ndarray
    obj_const: float
    A: np.ndarray
    cons_lb: np.ndarray
    cons_ub: np.ndarray
    var_lb: np.ndarray
    var_ub: np.ndarray
    x0: np.ndarray


def _tokens(f):
    for line in f:
        # strip comments (! or #) and blank lines
        for marker in ("!", "#", "%"):
            idx = line.find(marker)
            if idx >= 0:
                line = line[:idx]
        parts = line.split()
        if parts:
            yield parts


def parse_qplib(path: str) -> QPLIBData:
    with open(path) as f:
        tok = _tokens(f)

        name = next(tok)[0]
        ptype = next(tok)[0].upper()  # e.g. QGL, LCL, QCQ ...
        sense = next(tok)[0].lower()

        if len(ptype) == 3 and ptype[1] not in ("C", "L", "B", "G", "V"):
            raise ValueError(f"Unrecognized QPLIB problem type {ptype}")

        n = int(next(tok)[0])
        has_cons = ptype[2] != "N" and ptype[2] != "B"
        m = int(next(tok)[0]) if has_cons else 0

        # objective quadratic part
        Q = np.zeros((n, n))
        nq = int(next(tok)[0])
        for _ in range(nq):
            i, j, v = next(tok)
            i, j, v = int(i) - 1, int(j) - 1, float(v)
            Q[i, j] += v
            if i != j:
                Q[j, i] += v

        # objective linear part: default then exceptions
        b_default = float(next(tok)[0])
        c = np.full(n, b_default)
        nb = int(next(tok)[0])
        for _ in range(nb):
            i, v = next(tok)
            c[int(i) - 1] = float(v)

        obj_const = float(next(tok)[0])

        A = np.zeros((m, n))
        if m > 0:
            if ptype[1] == "Q":
                raise ValueError("Quadratic constraints are not supported")
            na = int(next(tok)[0])
            for _ in range(na):
                i, j, v = next(tok)
                A[int(i) - 1, int(j) - 1] += float(v)

            lc_default = float(next(tok)[0])
            cons_lb = np.full(m, lc_default)
            nlc = int(next(tok)[0])
            for _ in range(nlc):
                i, v = next(tok)
                cons_lb[int(i) - 1] = float(v)

            uc_default = float(next(tok)[0])
            cons_ub = np.full(m, uc_default)
            nuc = int(next(tok)[0])
            for _ in range(nuc):
                i, v = next(tok)
                cons_ub[int(i) - 1] = float(v)
        else:
            cons_lb = np.zeros(0)
            cons_ub = np.zeros(0)

        if ptype[2] == "B":
            var_lb = np.zeros(n)
            var_ub = np.ones(n)
        else:
            lv_default = float(next(tok)[0])
            var_lb = np.full(n, lv_default)
            nlv = int(next(tok)[0])
            for _ in range(nlv):
                i, v = next(tok)
                var_lb[int(i) - 1] = float(v)

            uv_default = float(next(tok)[0])
            var_ub = np.full(n, uv_default)
            nuv = int(next(tok)[0])
            for _ in range(nuv):
                i, v = next(tok)
                var_ub[int(i) - 1] = float(v)

        # variable types (integer problems) — skipped for continuous classes
        if ptype[2] in ("G", "I", "M"):
            nvt_default = next(tok)[0]  # default type
            nvt = int(next(tok)[0])
            for _ in range(nvt):
                next(tok)

        # initial primal point: default then exceptions
        try:
            x0_default = float(next(tok)[0])
            x0 = np.full(n, x0_default)
            nx0 = int(next(tok)[0])
            for _ in range(nx0):
                i, v = next(tok)
                x0[int(i) - 1] = float(v)
        except StopIteration:
            x0 = np.zeros(n)

    def map_inf(a):
        a = np.asarray(a, dtype=np.float64)
        a = np.where(a >= INF, np.inf, a)
        return np.where(a <= -INF, -np.inf, a)

    sign = -1.0 if sense.startswith("max") else 1.0

    return QPLIBData(
        name=name,
        sense=sense,
        Q=sign * Q,
        c=sign * c,
        obj_const=sign * obj_const,
        A=A,
        cons_lb=map_inf(cons_lb),
        cons_ub=map_inf(cons_ub),
        var_lb=map_inf(var_lb),
        var_ub=map_inf(var_ub),
        x0=x0,
    )
