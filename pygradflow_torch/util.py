"""Small numeric helpers (counterpart of ``pygradflow_tpu/util.py``)."""

import torch


def norm_sq(x):
    return torch.dot(x, x)


def norm_mult(*args):
    """Joint Euclidean norm of several vectors (reference ``util.py:19-25``)."""
    value = 0.0
    for arg in args:
        value = value + norm_sq(arg)
    return torch.sqrt(value)


def inf_norm(x):
    """Infinity norm that is 0 for empty vectors."""
    if x.numel() == 0:
        return torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.max(torch.abs(x))
