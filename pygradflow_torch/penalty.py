"""Penalty (rho) update strategies (counterpart of
``pygradflow_tpu/penalty.py``)::

    initial() -> (rho0, state0)
    update(prev_iterate, next_iterate, rho, state) -> PenaltyResult(rho_n, accept, state_n)

The six strategies of the reference (``pygradflow/penalty.py``): Constant,
DualNorm (the default), DualEquilibration, ParetoDecrease, and the filters
ObjectiveFilter and LagrangianFilter.  Each is written once on tensors and
serves both forms: ``rho`` and ``accept`` are 0-dim tensors for one
instance and (B,) tensors for a lane stack, with no host read, and
``initial(batch)`` gives the lane state.

The reference keeps a filter's Pareto front as an unbounded list; here, as
in the JAX package, it is a ring of ``params.filter_capacity`` entries with
a validity mask and an overwrite cursor ((B, capacity, 2), (B, capacity)
and (B,) for a lane stack).  ``FilterState`` also carries the strategy's
own rho, which the reference changes on every rejection while the solver's
rho follows only on accepted steps.
"""

from typing import Any, NamedTuple

import torch

from .iterate import Iterate, _jac_t, aug_lag_deriv_x, cons_violation
from .params import Params, PenaltyUpdate
from .util import dot, inf_norm


class PenaltyResult(NamedTuple):
    rho: Any
    accept: Any
    state: Any


def _constant(params: Params, m: int, fns):
    def update(prev: Iterate, nxt: Iterate, rho, state):
        return torch.full_like(rho, params.rho), None, state

    return update


def _dual_norm(params: Params, m: int, fns):
    """Keep rho within a factor of ||y||_inf (reference ``penalty.py:46-74``)."""

    def update(prev: Iterate, nxt: Iterate, rho, state):
        ynorm = inf_norm(nxt.y)
        grow = ynorm >= 10.0 * rho
        return torch.where(grow, torch.minimum(ynorm, 10.0 * rho), rho), None, state

    return update


def _dual_equilibration(params: Params, m: int, fns):
    """Target rho = 0.01 |y^T c| / (1/2 ||c||^2) (reference
    ``penalty.py:77-112``)."""

    def update(prev: Iterate, nxt: Iterate, rho, state):
        cons = nxt.cons
        yprod = torch.abs(dot(nxt.y, cons))
        viol = 0.5 * dot(cons, cons)
        target = 0.01 * yprod / torch.where(viol == 0.0, 1.0, viol)
        grow = (viol > 0.0) & (rho < target)
        return torch.where(grow, torch.maximum(rho * 10.0, target), rho), None, state

    return update


def _pareto_decrease(params: Params, m: int, fns):
    """Bound rho so that the flow direction weakly decreases the objective
    or the violation (reference ``penalty.py:115-183``); the J^T products go
    through ``fns`` for a matrix-free iterate."""

    def update(prev: Iterate, nxt: Iterate, rho, state):
        cons = nxt.cons
        viol = 0.5 * dot(cons, cons)
        infeas_res = _jac_t(nxt, cons, fns)
        # skip when feasible or locally infeasible
        skip = (viol <= params.opt_tol) | (inf_norm(infeas_res) <= params.local_infeas_tol)

        obj_grad = nxt.obj_grad
        obj_prod = dot(obj_grad, infeas_res)
        cons_dual_prod = _jac_t(nxt, nxt.y, fns)

        lhs_obj = -(torch.linalg.vector_norm(obj_grad, dim=-1) + dot(cons_dual_prod, obj_grad))
        big = torch.abs(obj_prod) > 1e-10
        obj_bound = torch.where(big, lhs_obj / torch.where(big, obj_prod, 1.0), torch.inf)

        infeas_res_norm = torch.linalg.vector_norm(infeas_res, dim=-1)
        lhs_cons = -dot(infeas_res, obj_grad + cons_dual_prod)
        cons_bound = lhs_cons / torch.where(infeas_res_norm == 0.0, 1.0, infeas_res_norm)

        bound = torch.minimum(obj_bound, cons_bound)
        rho_n = torch.maximum(torch.minimum(rho * 10.0, bound), rho)
        return torch.where(skip, rho, rho_n), None, state

    return update


class FilterState(NamedTuple):
    entries: Any  # (..., capacity, 2)
    valid: Any  # (..., capacity) bool
    cursor: Any  # (...) int64, the overwrite position when the ring is full
    rho: Any  # the strategy's own rho


def _filter_initial(params: Params, device, batch=None):
    lead = () if batch is None else (batch,)
    cap = params.filter_capacity
    return FilterState(
        entries=torch.full(lead + (cap, 2), torch.inf, dtype=params.dtype, device=device),
        valid=torch.zeros(lead + (cap,), dtype=torch.bool, device=device),
        cursor=torch.zeros(lead, dtype=torch.int64, device=device),
        rho=torch.full(lead, params.rho, dtype=params.dtype, device=device),
    )


def _filter_insert(state: FilterState, first, second):
    """Insert (first, second) into the Pareto front; returns (accepted,
    new state).  Rejected iff an entry dominates it (reference
    ``penalty.py:199-213``); entries it dominates are dropped, and it takes
    the first free slot, or the cursor's once the ring is full."""
    f, s = first[..., None], second[..., None]
    dominated = (state.valid & (state.entries[..., 0] <= f) & (state.entries[..., 1] <= s)).any(dim=-1)
    valid = state.valid & ~((f <= state.entries[..., 0]) & (s <= state.entries[..., 1]))

    free = ~valid
    cap = valid.shape[-1]
    # torch.argmax takes no bool tensor; on integers it returns the first
    # maximum, as jnp.argmax does
    idx = torch.where(free.any(dim=-1), torch.argmax(free.to(torch.int32), dim=-1), state.cursor % cap)
    slot = torch.arange(cap, device=valid.device) == idx[..., None]
    entries_n = torch.where(slot[..., None], torch.stack([first, second], dim=-1)[..., None, :], state.entries)

    keep = dominated[..., None]
    new_state = FilterState(
        entries=torch.where(keep[..., None], state.entries, entries_n),
        valid=torch.where(keep, state.valid, valid | slot),
        cursor=state.cursor + (~dominated).to(state.cursor.dtype),
        rho=state.rho,
    )
    return ~dominated, new_state


def _filter(entry_fn):
    def update(prev: Iterate, nxt: Iterate, rho, state: FilterState):
        first, second = entry_fn(nxt, state.rho)
        inserted, state_n = _filter_insert(state, first, second)
        rho_n = torch.where(inserted, state.rho, state.rho * 10.0)
        return rho_n, inserted, state_n._replace(rho=rho_n)

    return update


def _objective_filter(params: Params, m: int, fns):
    """Pareto filter on (objective, constraint violation) (reference
    ``penalty.py:229-238``)."""
    return _filter(lambda it, rho: (it.obj, cons_violation(it)))


def _lagrangian_filter(params: Params, m: int, fns):
    """Pareto filter on (||grad L||^2, ||c||) (reference
    ``penalty.py:241-255``)."""

    def entry(it: Iterate, rho):
        lag_x = aug_lag_deriv_x(it, rho, fns)
        norm_sq = dot(lag_x, lag_x) + dot(it.cons, it.cons)
        return norm_sq, torch.linalg.vector_norm(it.cons, dim=-1)

    return _filter(entry)


_STRATEGIES = {
    PenaltyUpdate.Constant: _constant,
    PenaltyUpdate.DualNorm: _dual_norm,
    PenaltyUpdate.DualEquilibration: _dual_equilibration,
    PenaltyUpdate.ParetoDecrease: _pareto_decrease,
    PenaltyUpdate.ObjectiveFilter: _objective_filter,
    PenaltyUpdate.LagrangianFilter: _lagrangian_filter,
}

# strategies that leave rho as it is without constraints
_NEED_CONS = (PenaltyUpdate.DualNorm, PenaltyUpdate.DualEquilibration, PenaltyUpdate.ParetoDecrease)


def penalty_strategy(params: Params, num_cons: int, fns=None, device="cpu"):
    """Factory keyed on PenaltyUpdate (reference ``penalty.py:258-274``).
    ``fns`` routes the J^T products of a matrix-free iterate through
    ``cons_vjp``; ``device`` holds a filter's state; ``initial`` takes the
    batch size of a lane stack (None for one instance)."""
    pu = params.penalty_update
    if pu not in _STRATEGIES:
        raise ValueError("Invalid penalty update strategy")
    is_filter = pu in (PenaltyUpdate.ObjectiveFilter, PenaltyUpdate.LagrangianFilter)
    passive = pu in _NEED_CONS and num_cons == 0
    rule = _STRATEGIES[pu](params, num_cons, fns)

    def initial(batch=None):
        state = _filter_initial(params, device, batch) if is_filter else ()
        return params.rho, state

    def update(prev: Iterate, nxt: Iterate, rho, state):
        if passive:
            return PenaltyResult(rho, torch.ones_like(rho, dtype=torch.bool), state)
        rho_n, accept, state_n = rule(prev, nxt, rho, state)
        if accept is None:
            accept = torch.ones_like(rho, dtype=torch.bool)
        return PenaltyResult(rho_n, accept, state_n)

    return initial, update
