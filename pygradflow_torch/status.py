"""Solver status codes (reference ``pygradflow/status.py``).

The eager loop keeps the status as a plain int; :class:`SolverStatus`
provides the enum view.  ``RUNNING`` (0) is internal and never
escapes a solve.
"""

from enum import IntEnum


class SolverStatus(IntEnum):
    Running = 0
    Optimal = 1
    IterationLimit = 2
    TimeLimit = 3
    Unbounded = 4
    LocallyInfeasible = 5
    LambdaLimit = 6
    """lambda exceeded lamb_max: the reference raises
    '(incorrect derivatives?)' (``solver.py:323-326``); the Python wrapper
    re-raises when it sees this code."""

    @staticmethod
    def short_name(status):
        return {
            SolverStatus.Optimal: "optimal",
            SolverStatus.IterationLimit: "iteration_limit",
            SolverStatus.TimeLimit: "time_limit",
            SolverStatus.Unbounded: "unbounded",
            SolverStatus.LocallyInfeasible: "infeasible",
            SolverStatus.LambdaLimit: "lambda_limit",
        }[status]

    @staticmethod
    def description(status):
        return {
            SolverStatus.Optimal: "Converged to first-order optimal solution",
            SolverStatus.IterationLimit: "Reached iteration limit",
            SolverStatus.TimeLimit: "Reached time limit",
            SolverStatus.Unbounded: "Problem appears unbounded",
            SolverStatus.LocallyInfeasible: "Local infeasibility detected",
            SolverStatus.LambdaLimit: "Inverse step size exceeded maximum",
        }[status]

    @staticmethod
    def success(status):
        return status == SolverStatus.Optimal


RUNNING = int(SolverStatus.Running)
