"""Penalty (rho) update strategies (counterpart of
``pygradflow_tpu/penalty.py``)::

    initial() -> (rho0, state0)
    update(prev_iterate, next_iterate, rho, state) -> PenaltyResult(rho_n, accept, state_n)

DualNorm (the default) is ported.
"""

from typing import Any, NamedTuple

from .iterate import Iterate
from .params import Params, PenaltyUpdate
from .util import inf_norm


class PenaltyResult(NamedTuple):
    rho: float
    accept: bool
    state: Any


def _dual_norm(params: Params, m: int):
    """Keep rho within a factor of ||y||_inf (reference ``penalty.py:46-74``)."""

    def initial():
        return params.rho, ()

    def update(prev: Iterate, nxt: Iterate, rho, state):
        if m == 0:
            return PenaltyResult(rho, True, state)
        ynorm = inf_norm(nxt.y).item()
        rho_n = min(ynorm, 10.0 * rho) if ynorm >= 10.0 * rho else rho
        return PenaltyResult(rho_n, True, state)

    return initial, update


def penalty_strategy(params: Params, num_cons: int):
    """Factory keyed on PenaltyUpdate (reference ``penalty.py:258-274``)."""
    if params.penalty_update == PenaltyUpdate.DualNorm:
        return _dual_norm(params, num_cons)
    raise NotImplementedError(
        f"penalty update {params.penalty_update.name} is not yet ported (ROADMAP A5)"
    )
