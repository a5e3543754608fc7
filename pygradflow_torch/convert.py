"""Carry data from the JAX package to this port.

``params_from_jax`` maps a ``pygradflow_tpu.Params`` field by field: enums
by member name, arrays through numpy.  ``tensor`` makes a float64 tensor
from a numpy array.  Neither imports JAX: they read the objects they are
given.
"""

import dataclasses
import enum

import numpy as np
import torch

from .params import Params


def tensor(a, device="cpu"):
    """A float64 tensor on ``device`` from a numpy array (or array-like)."""
    return torch.as_tensor(np.asarray(a, dtype=np.float64), device=device)


def _convert(value, target):
    if isinstance(value, enum.Enum):
        return type(target)[value.name] if isinstance(target, enum.Enum) else value.name
    if hasattr(value, "__array__") and not isinstance(value, (str, bytes)):
        return np.asarray(value)
    return value


def params_from_jax(p) -> Params:
    """The port's ``Params`` with every field of ``p`` carried over."""
    defaults = Params()
    values = {}
    for field in dataclasses.fields(Params):
        value = getattr(p, field.name)
        values[field.name] = _convert(value, getattr(defaults, field.name))
    return Params(**values)
