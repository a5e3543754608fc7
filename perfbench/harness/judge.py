"""The comparison that decides ``correct``: every answer of the window,
judged by the configuration's plain reference against its own instance
(the problem data that the harness drew for its lane and call) once the
window has closed.

The numbers compared, each against its limit from ``limits/<cell>.json``:

- ``not_optimal``: answers whose status is not Optimal (limit 0);
- ``kkt_res_max``: the largest optimality measure of an answer, worked out
  by the reference from (x, y) alone (the configuration's ``opt_tol``);
- ``cons_viol_max``: the largest constraint violation of an answer, where
  the limits file names it;
- ``f32_grid_share``: the share of answers whose every x component is a
  float32 number, which a float64 solve reaches with probability about
  2^-29 per component and a float32 one always.

An answer fails when its status is not Optimal or one of its own numbers
is over its limit; ``f32_grid_share`` judges the answers together (an
exact optimum such as Rosenbrock's (1, 1) is a float32 number, and right).
"""

from types import SimpleNamespace

import numpy as np

from pygradflow_torch import SolverStatus

NAMES = ("not_optimal", "kkt_res_max", "cons_viol_max", "f32_grid_share")


def on_f32_grid(x):
    """(L,) bool: every component of the row is a float32 number."""
    x = np.asarray(x, dtype=np.float64)
    with np.errstate(over="ignore", invalid="ignore"):
        same = x.astype(np.float32).astype(np.float64) == x
    return same.all(axis=1)


def judge(reference, numbers, size, status, x, y, data, limits, reported=None):
    """``correct``, ``failed``, the ``checks`` object of the result line
    and the lines that print them, for the answers ``status`` (L,), ``x``
    (L, n), ``y`` (L, m) to the instances ``data`` (each leaf by name, (L,
    ...), as the harness drew them); with the solver's ``reported`` optimality
    measure (L,) also ``gap``, the largest distance between it and the
    reference's over the Optimal answers (a reading of the rounding
    between the two, not compared)."""
    unknown = set(limits) - set(NAMES)
    if unknown or "not_optimal" not in limits or "kkt_res_max" not in limits:
        raise ValueError(f"bad limits {sorted(limits)}")
    res = reference.residuals(x, y, data, numbers, size, numbers["params"]["active_tol"])
    kkt = np.maximum(np.maximum(res["stat"], res["cons"]), res["bound"])
    not_optimal = status != int(SolverStatus.Optimal)
    grid = on_f32_grid(x)
    values = {
        "not_optimal": int(not_optimal.sum()),
        "kkt_res_max": float(kkt.max()),
        "cons_viol_max": float(res["cons"].max()),
        "f32_grid_share": float(grid.mean()),
    }
    bad = not_optimal | ~(kkt <= limits["kkt_res_max"])
    if "cons_viol_max" in limits:
        bad |= ~(res["cons"] <= limits["cons_viol_max"])
    checks = {k: {"value": values[k], "limit": limits[k]} for k in NAMES if k in limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    lines = [f"check {k}: {c['value']!r} limit {c['limit']!r}" for k, c in checks.items()]
    lines.append(f"check correct: {correct} ({int(bad.sum())} of {status.size} answers failed)")
    gap = None
    if reported is not None and (~not_optimal).any():
        gap = float(np.abs(kkt - reported)[~not_optimal].max())
    return SimpleNamespace(correct=bool(correct), failed=int(bad.sum()), checks=checks, lines=lines, gap=gap)
