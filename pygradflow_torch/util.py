"""Small numeric helpers (counterpart of ``pygradflow_tpu/util.py``).

Every helper acts on the last axis, so it serves one instance (vectors
(n,)) and a lane stack (B, n) alike.
"""

from collections import Counter

import torch

HOST_READS = Counter()
"""Host reads of the inner loops that stop when no lane still runs (the
box solver, the interior point, MINRES and GMRES), one count per read,
keyed by loop."""


def any_running(running, loop: str) -> bool:
    """Whether any lane (or the one instance) still runs: one host read,
    counted in ``HOST_READS[loop]``."""
    HOST_READS[loop] += 1
    return bool(running.any())


def cuda_graphed(fn, example):
    """``fn``, a function of a tuple of CUDA tensors that returns a tuple of
    tensors of the same shapes and reads nothing on the host, captured once
    as a CUDA graph.  The callable returned copies its arguments into the
    graph's inputs, replays the graph and returns its output tensors, which
    the next replay overwrites."""
    inputs = tuple(t.clone() for t in example)
    stream = torch.cuda.Stream(device=inputs[0].device)
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn(*inputs)  # warm-up: cuBLAS handles and workspaces outside the capture
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outputs = fn(*inputs)

    def replay(*args):
        for dst, src in zip(inputs, args):
            if dst is not src:
                dst.copy_(src)
        graph.replay()
        return outputs

    return replay


def lanes(s, k: int):
    """A per-lane scalar ``s`` made to broadcast against ``k`` trailing
    axes: a (B,) tensor becomes (B, 1, ..., 1); a Python number or a 0-dim
    tensor stays as it is."""
    if torch.is_tensor(s) and s.ndim > 0:
        return s.reshape(s.shape + (1,) * k)
    return s


class PerDevice:
    """A value made by ``make(device)`` on first use on a device and kept,
    so constant data (a QP's matrices, scaling weights) is copied to the
    card once, not at every evaluation."""

    def __init__(self, make):
        self._make = make
        self._copies = {}

    def on(self, x):
        """The copy on the device of tensor ``x``."""
        if x.device not in self._copies:
            self._copies[x.device] = self._make(x.device)
        return self._copies[x.device]


def tree_map(fn, *trees):
    """``fn`` over the tensors of equally shaped (Named)tuples of tensors."""
    first = trees[0]
    if isinstance(first, tuple):
        vals = [tree_map(fn, *leaves) for leaves in zip(*trees)]
        return type(first)(*vals) if hasattr(first, "_fields") else tuple(vals)
    return fn(*trees)


def select(mask, a, b):
    """Per lane: ``a`` where ``mask`` is true, else ``b``, through tuples
    and NamedTuples of tensors.  A ``torch.where``, never a multiply by the
    mask, so that NaN or inf in a discarded lane never reaches a kept one."""
    return tree_map(lambda u, v: torch.where(lanes(mask, u.ndim - mask.ndim), u, v), a, b)


def dot(x, y):
    """Inner product over the last axis."""
    if x.ndim == 1:
        return torch.dot(x, y)
    return torch.linalg.vecdot(x, y)


def matvec(a, x):
    """``a @ x`` for a matrix (..., k, n) and a vector (..., n)."""
    if x.ndim == 1:
        return a @ x
    return (a @ x[..., None])[..., 0]


def norm_sq(x):
    return dot(x, x)


def norm_mult(*args):
    """Joint Euclidean norm of several vectors (reference ``util.py:19-25``)."""
    value = 0.0
    for arg in args:
        value = value + norm_sq(arg)
    return torch.sqrt(value)


def inf_norm(x):
    """Infinity norm over the last axis that is 0 for empty vectors."""
    if x.shape[-1] == 0:
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    return torch.amax(torch.abs(x), dim=-1)
