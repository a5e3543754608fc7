"""Problem scaling (counterpart of ``pygradflow_tpu/scale.py``).

Only ``ScalingType.NoScaling`` is ported so far; the power-of-2 scalings
are ROADMAP A2.
"""

from .params import Params, ScalingType
from .problem import Problem


def create_scaling(problem: Problem, params: Params, scaling_primal, scaling_dual):
    """Factory keyed on ``ScalingType``: ``None`` for ``NoScaling``."""
    if params.scaling is None and params.scaling_type == ScalingType.NoScaling:
        return None
    raise NotImplementedError(
        f"scaling {params.scaling_type.name} is not yet ported (ROADMAP A2)"
    )
