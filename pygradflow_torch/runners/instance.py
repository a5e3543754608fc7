"""Benchmark instance ABC (counterpart of ``pygradflow_tpu/runners/instance.py``)."""

from abc import ABC, abstractmethod


class Instance(ABC):
    def __init__(self, name, num_vars, num_cons):
        self.name = name
        self.num_vars = num_vars
        self.num_cons = num_cons

    def __repr__(self):
        return f"{self.__class__.__name__}({self.name})"

    @property
    def size(self):
        return self.num_vars + self.num_cons

    def solve(self, params, device=None, debug_nans=False):
        """Solve with the port's ``Solver`` on ``device`` (None: the card).
        ``debug_nans`` raises ``FloatingPointError`` at the first evaluation
        of the problem that returns a non-finite value."""
        from ..solver import Solver

        problem = self.problem()
        if debug_nans:
            problem = FiniteCheckProblem(problem)
        solver = Solver(problem, params, device=device)
        return solver.solve(self.x0(), self.y0())

    @abstractmethod
    def problem(self):
        raise NotImplementedError()

    @abstractmethod
    def x0(self):
        raise NotImplementedError()

    def y0(self):
        return 0.0


class FiniteCheckProblem:
    """A problem whose evaluations (values and derivatives) are each read on
    the host; the first one that holds a NaN or an infinity raises
    ``FloatingPointError``.  Every other attribute is the wrapped
    problem's."""

    evaluates_on_host = True  # each check reads the host: the solve loop runs eagerly

    _CHECKED = ("obj", "obj_grad", "cons", "cons_jac", "lag_hess", "lag_hvp", "cons_vjp", "cons_jvp")

    def __init__(self, problem):
        self._problem = problem

    def __getattr__(self, name):
        attr = getattr(self._problem, name)
        if name not in self._CHECKED:
            return attr

        def checked(*args):
            import torch

            out = attr(*args)
            if not bool(torch.isfinite(out).all()):
                raise FloatingPointError(f"non-finite value in {name}")
            return out

        return checked
