from .control import ControlResult, compute_step, make_control_cfg, make_controller  # noqa: F401
from .solvers import StepResult, step_solver_def  # noqa: F401
