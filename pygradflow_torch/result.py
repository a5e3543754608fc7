"""Solve result container (counterpart of ``pygradflow_tpu/result.py``).

``x``, ``y`` and ``d`` are float tensors on the solver's device.  Further
statistics (``final_stat_res``, ``num_evals``, ...) are reachable as
attributes, as in the reference (``result.py:80-95``).  With
``params.collect_path``: ``path`` ((n+m, k) columns of accepted iterates,
in the solver's transformed variables), ``model_times`` and the speeds
along them.
"""

import torch

from .status import SolverStatus


class SolverResult:
    """Primal/dual solution plus run statistics."""

    def __init__(
        self,
        problem,
        x,
        y,
        d,
        status: SolverStatus,
        iterations: int,
        num_accepted_steps: int,
        total_time: float,
        dist_factor: float,
        **attrs,
    ):
        self.num_vars = problem.num_vars
        self.num_cons = problem.num_cons
        self._attrs = attrs

        self._x = x
        self._y = y
        self._d = d
        self._status = status
        self.iterations = iterations
        self.num_accepted_steps = num_accepted_steps
        self.total_time = total_time
        self.dist_factor = dist_factor

    def _set_path(self, path, model_times):
        """The recorded path and its model times (reference ``result.py:39-60``)."""
        num_vars = self.num_vars

        def speed(p):
            return lambda: torch.linalg.vector_norm(torch.diff(p, dim=1), dim=0) / torch.diff(model_times)

        self._attrs.update(
            path=path,
            model_times=model_times,
            primal_path=path[:num_vars],
            dual_path=path[num_vars:],
            model_speed=speed(path),
            primal_model_speed=speed(path[:num_vars]),
            dual_model_speed=speed(path[num_vars:]),
        )

    @property
    def status(self) -> SolverStatus:
        return self._status

    def __getattr__(self, name):
        val = super().__getattribute__("_attrs").get(name, None)
        return val() if callable(val) else val

    def __setitem__(self, name, value):
        self._attrs[name] = value

    def __getitem__(self, name):
        return self._attrs[name]

    @property
    def x(self):
        return self._x

    @property
    def y(self):
        return self._y

    @property
    def d(self):
        return self._d

    def __repr__(self) -> str:
        return "SolverResult(status={0})".format(self.status)

    @property
    def success(self):
        return SolverStatus.success(self.status)
