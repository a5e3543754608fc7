"""Carry data from the JAX package to this port.

``params_from_jax`` maps a ``pygradflow_tpu.Params`` field by field: enums
by member name, arrays through numpy, a ``Scaling`` by its integer weights.
Callables (``step_solver``, ``active_set_method``) are not carried: they
are written against one package's types, so each package gets its own.
``tensor`` makes a float64 tensor from a numpy array.  Neither imports
JAX: they read the objects they are given.
"""

import dataclasses
import enum

import numpy as np
import torch

from .params import Params
from .scale import Scaling

_NOT_CARRIED = ("step_solver", "active_set_method")


def tensor(a, device="cpu"):
    """A float64 tensor on ``device`` from a numpy array (or array-like)."""
    return torch.as_tensor(np.asarray(a, dtype=np.float64), device=device)


def scaling_from_jax(s) -> Scaling:
    """The port's ``Scaling`` with the weights of a JAX one (read by their
    names, ``var_weights``, ``cons_weights`` and ``obj_weight``)."""
    return Scaling(np.asarray(s.var_weights), np.asarray(s.cons_weights), int(s.obj_weight))


def _convert(value, target):
    if isinstance(value, enum.Enum):
        return type(target)[value.name] if isinstance(target, enum.Enum) else value.name
    if hasattr(value, "var_weights") and hasattr(value, "cons_weights"):
        return scaling_from_jax(value)
    if hasattr(value, "__array__") and not isinstance(value, (str, bytes)):
        return np.asarray(value)
    return value


def params_from_jax(p) -> Params:
    """The port's ``Params`` with every field of ``p`` carried over but the
    callables, which keep their defaults."""
    defaults = Params()
    values = {}
    for field in dataclasses.fields(Params):
        if field.name in _NOT_CARRIED:
            continue
        value = getattr(p, field.name)
        values[field.name] = _convert(value, getattr(defaults, field.name))
    return Params(**values)


def tensor_like(a, example):
    """A tensor of ``example``'s dtype on its device from a numpy array (or
    array-like): the values a snapshot of either package holds, in the
    form of the leaf they restore."""
    return torch.as_tensor(np.asarray(a), device=example.device).to(example.dtype)
