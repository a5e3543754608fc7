"""Console output of a solve (counterpart of ``pygradflow_tpu/display.py``).

Only the problem-statistics banner and the ``Format`` helpers are ported;
the live iteration table (``Params.display``) is ROADMAP A12.
"""

import sys

import numpy as np

from .log import logger

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
