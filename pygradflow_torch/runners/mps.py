"""MPS file reader for linear programs (the port's own copy of
``pygradflow_tpu/runners/mps.py``).

A self-contained reader for the standard sections (ROWS, COLUMNS, RHS,
RANGES, BOUNDS, incl. integer markers, free-format), producing dense numpy
data for :class:`pygradflow_torch.problem.QuadraticProblem` with a zero
Hessian.  The port's C++ reader (``pygradflow_torch/native``) takes over
when it builds; ``parse_mps_py`` is the reader in Python.
"""

from typing import NamedTuple

import numpy as np

INF = np.inf


class MPSData(NamedTuple):
    name: str
    c: np.ndarray  # objective coefficients
    A: np.ndarray  # constraint matrix (m, n)
    cons_lb: np.ndarray
    cons_ub: np.ndarray
    var_lb: np.ndarray
    var_ub: np.ndarray
    obj_offset: float
    col_names: list
    row_names: list


def parse_mps(path: str, native: bool = True) -> MPSData:
    if native:
        try:
            from ..native import parse_mps_native

            data = parse_mps_native(path)
            if data is not None:
                return data
        except FileNotFoundError:
            raise
        except Exception:
            pass  # fall back to the Python parser

    return parse_mps_py(path)


def parse_mps_py(path: str) -> MPSData:
    name = ""
    section = None

    row_types = {}
    row_order = []
    obj_row = None

    col_order = []
    col_index = {}
    entries = []  # (row, col_idx, value)
    obj_entries = {}

    rhs = {}
    ranges = {}
    bounds = []  # (type, col, value)

    with open(path) as f:
        for raw in f:
            line = raw.rstrip("\n")
            if not line.strip() or line.lstrip().startswith("*"):
                continue

            if not line[0].isspace():
                parts = line.split()
                section = parts[0].upper()
                if section == "NAME":
                    name = parts[1] if len(parts) > 1 else ""
                if section == "ENDATA":
                    break
                continue

            parts = line.split()

            if section == "ROWS":
                rtype, rname = parts[0].upper(), parts[1]
                if rtype == "N":
                    if obj_row is None:
                        obj_row = rname
                else:
                    row_types[rname] = rtype
                    row_order.append(rname)

            elif section == "COLUMNS":
                if len(parts) >= 3 and parts[1].upper() == "'MARKER'":
                    continue  # integer markers: treat as continuous
                cname = parts[0]
                if cname not in col_index:
                    col_index[cname] = len(col_order)
                    col_order.append(cname)
                ci = col_index[cname]
                for rname, val in zip(parts[1::2], parts[2::2]):
                    v = float(val)
                    if rname == obj_row:
                        obj_entries[ci] = obj_entries.get(ci, 0.0) + v
                    elif rname in row_types:
                        entries.append((rname, ci, v))

            elif section == "RHS":
                # first token is the rhs-set name
                for rname, val in zip(parts[1::2], parts[2::2]):
                    rhs[rname] = float(val)

            elif section == "RANGES":
                for rname, val in zip(parts[1::2], parts[2::2]):
                    ranges[rname] = float(val)

            elif section == "BOUNDS":
                btype = parts[0].upper()
                cname = parts[2]
                value = float(parts[3]) if len(parts) > 3 else 0.0
                bounds.append((btype, cname, value))

    n = len(col_order)
    m = len(row_order)
    row_index = {r: i for i, r in enumerate(row_order)}

    c = np.zeros(n)
    for ci, v in obj_entries.items():
        c[ci] = v

    A = np.zeros((m, n))
    for rname, ci, v in entries:
        A[row_index[rname], ci] += v

    obj_offset = -rhs.get(obj_row, 0.0)

    cons_lb = np.full(m, -INF)
    cons_ub = np.full(m, INF)
    for rname in row_order:
        i = row_index[rname]
        rt = row_types[rname]
        b = rhs.get(rname, 0.0)
        if rt == "E":
            cons_lb[i] = cons_ub[i] = b
        elif rt == "L":
            cons_ub[i] = b
        elif rt == "G":
            cons_lb[i] = b
        if rname in ranges:
            r = ranges[rname]
            if rt == "L":
                cons_lb[i] = cons_ub[i] - abs(r)
            elif rt == "G":
                cons_ub[i] = cons_lb[i] + abs(r)
            elif rt == "E":
                if r >= 0:
                    cons_ub[i] = cons_lb[i] + r
                else:
                    cons_lb[i] = cons_ub[i] + r

    var_lb = np.zeros(n)
    var_ub = np.full(n, INF)
    for btype, cname, value in bounds:
        if cname not in col_index:
            continue
        j = col_index[cname]
        if btype == "UP":
            var_ub[j] = value
            if value < 0 and var_lb[j] == 0.0:
                var_lb[j] = -INF
        elif btype == "LO":
            var_lb[j] = value
        elif btype == "FX":
            var_lb[j] = var_ub[j] = value
        elif btype == "FR":
            var_lb[j] = -INF
            var_ub[j] = INF
        elif btype == "MI":
            var_lb[j] = -INF
        elif btype == "PL":
            var_ub[j] = INF
        elif btype in ("BV",):
            var_lb[j], var_ub[j] = 0.0, 1.0
        elif btype in ("UI",):
            var_ub[j] = value
        elif btype in ("LI",):
            var_lb[j] = value

    return MPSData(
        name=name,
        c=c,
        A=A,
        cons_lb=cons_lb,
        cons_ub=cons_ub,
        var_lb=var_lb,
        var_ub=var_ub,
        obj_offset=obj_offset,
        col_names=col_order,
        row_names=row_order,
    )
