"""Console output of a solve (counterpart of ``pygradflow_tpu/display.py``).

The problem-statistics banner, the ``Format`` helpers and the live
iteration table (``Params.display``): columns with ANSI colouring, a header
every 25 rows (reference ``solver.py:23``) and rate limiting by
``display_interval``.  Rows are logged through the package's logger; the
solve loop reads a row's values on the host only when ``should_display``
lets it through.
"""

import logging
import sys
import time

import numpy as np

from .log import logger

HEADER_INTERVAL = 25

BOLD = "\033[1m"
RED = "\033[31m"
GREEN = "\033[32m"
RESET = "\033[0m"


def _supports_color():
    return hasattr(sys.stderr, "isatty") and sys.stderr.isatty()


class Format:
    @staticmethod
    def bold(s):
        if not _supports_color():
            return s
        return f"{BOLD}{s}{RESET}"

    @staticmethod
    def redgreen(s, cond, bold=False):
        if not _supports_color():
            return s
        color = GREEN if cond else RED
        prefix = BOLD if bold else ""
        return f"{prefix}{color}{s}{RESET}"


class Column:
    def __init__(self, name, width, fmt):
        self.name = name
        self.width = width
        self.fmt = fmt

    def header(self):
        return "{:>{w}s}".format(self.name, w=self.width)

    def cell(self, value):
        if callable(self.fmt):
            return self.fmt(value)
        return self.fmt.format(value, w=self.width)


def _bool_cell(width):
    def fmt(value):
        s = "{:>{w}s}".format("yes" if value else "no", w=width)
        return Format.redgreen(s, bool(value))

    return fmt


class Display:
    """A table of ``columns`` logged at ``level``, one row at most every
    ``interval`` seconds."""

    def __init__(self, columns, interval=0.1, level=None, indent=""):
        self.columns = columns
        self.interval = interval
        self.level = logging.INFO if level is None else level
        self.indent = indent
        self._rows_since_header = 0
        self._last_time = 0.0

    @property
    def header(self):
        return self.indent + " ".join(c.header() for c in self.columns)

    def should_display(self):
        now = time.time()
        if now - self._last_time >= self.interval:
            self._last_time = now
            return True
        return False

    def row(self, values: dict):
        if self._rows_since_header % HEADER_INTERVAL == 0:
            logger.log(self.level, self.header)
        self._rows_since_header += 1
        cells = []
        for c in self.columns:
            v = values.get(c.name, None)
            cells.append(c.cell(v) if v is not None else " " * c.width)
        logger.log(self.level, self.indent + " ".join(cells))


def solver_display(num_cons: int, params) -> Display:
    """The discrete solver's rows (reference ``display.py:240-286``)."""
    cols = [
        Column("iter", 6, "{:>{w}d}"),
        Column("aug_lag", 16, "{:{w}.8e}"),
        Column("obj", 16, "{:{w}.8e}"),
    ]
    if num_cons > 0:
        cols.append(Column("cons_viol", 16, "{:{w}.8e}"))
    cols += [
        Column("stat_res", 16, "{:{w}.8e}"),
        Column("active", 8, "{:>{w}d}"),
        Column("obj_nonlin", 12, "{:{w}.4e}"),
        Column("|dx|", 16, "{:{w}.8e}"),
        Column("|dy|", 16, "{:{w}.8e}"),
        Column("lamb", 12, "{:{w}.4e}"),
        Column("rho", 12, "{:{w}.4e}"),
    ]
    # the rcond column when the estimate is on (reference display.py:240-242)
    if params.report_rcond:
        cols.append(Column("rcond", 12, "{:{w}.4e}"))
    cols.append(Column("accept", 8, _bool_cell(8)))
    return Display(cols, interval=params.display_interval)


def inner_display(params) -> Display:
    """Rows of the inner Newton iterations at DEBUG level (reference
    ``display.py:307-315``), indented under the outer row."""
    cols = [
        Column("inner", 6, "{:>{w}d}"),
        Column("residuum", 16, "{:{w}.8e}"),
        Column("dist", 16, "{:{w}.8e}"),
        Column("active", 10, "{:>{w}d}"),
    ]
    return Display(cols, interval=0.0, level=logging.DEBUG, indent="     ")


def integrator_display(num_cons: int, params) -> Display:
    """Rows of the continuous engine, one per segment (reference
    ``display.py:289-304``)."""
    cols = [
        Column("iter", 6, "{:>{w}d}"),
        Column("t", 14, "{:{w}.6e}"),
        Column("obj", 16, "{:{w}.8e}"),
        Column("res", 14, "{:{w}.6e}"),
        Column("rho", 12, "{:{w}.4e}"),
        Column("steps", 8, "{:>{w}d}"),
        Column("free", 6, "{:>{w}d}"),
    ]
    return Display(cols, interval=params.display_interval)


def print_problem_stats(problem, num_vars, num_cons):
    """Problem statistics banner (reference ``display.py:318-372``)."""
    logger.info("Solving problem with %d variables and %d constraints", num_vars, num_cons)
    lb_finite = np.isfinite(problem.var_lb).sum()
    ub_finite = np.isfinite(problem.var_ub).sum()
    logger.info(
        "  bounded variables: %d lower / %d upper of %d", lb_finite, ub_finite, num_vars
    )
    if num_cons > 0:
        eq = (problem.cons_lb == problem.cons_ub).sum()
        logger.info("  constraints: %d equalities / %d total", eq, num_cons)
