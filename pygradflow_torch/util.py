"""Small numeric helpers (counterpart of ``pygradflow_tpu/util.py``).

Every helper acts on the last axis, so it serves one instance (vectors
(n,)) and a lane stack (B, n) alike.
"""

import gc
from collections import Counter

import torch

HOST_READS = Counter()
"""Host reads of the inner loops that stop when no lane still runs (the
box solver, the interior point, MINRES and GMRES, and the continuous
engine's loops: ``newton``, ``segment``, ``bisect``, ``device_loop`` and
``flat``, and ``branch``, the reads that skip a branch no lane takes), one
count per read, keyed by loop."""


def any_running(running, loop: str) -> bool:
    """Whether any lane (or the one instance) still runs: one host read,
    counted in ``HOST_READS[loop]``."""
    HOST_READS[loop] += 1
    return bool(running.any())


def _capture(fn, inputs):
    """``fn(*inputs)`` captured as a CUDA graph after one warm-up run on a
    side stream; returns the graph and its output tensors.  No garbage is
    collected during the capture, and only this thread's CUDA calls can
    invalidate it: a collection in another thread of the process (a worker
    pool's result handler, say) frees CUDA memory and destroys graphs
    outside the capture."""
    stream = torch.cuda.Stream(device=inputs[0].device)
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn(*inputs)  # warm-up: cuBLAS handles and workspaces outside the capture
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            outputs = fn(*inputs)
    finally:
        if collecting:
            gc.enable()
    return graph, outputs


def cuda_graphed(fn, example):
    """``fn``, a function of a tuple of CUDA tensors that returns a tuple of
    tensors of the same shapes and reads nothing on the host, captured once
    as a CUDA graph.  The callable returned copies its arguments into the
    graph's inputs, replays the graph and returns its output tensors, which
    the next replay overwrites."""
    inputs = tuple(t.clone() for t in example)
    graph, outputs = _capture(fn, inputs)

    def replay(*args):
        for dst, src in zip(inputs, args):
            if dst is not src:
                dst.copy_(src)
        graph.replay()
        return outputs

    return replay


class GraphPair:
    """Two functions of the same CUDA tensors, ``fast`` and ``full``, each
    returning a tuple whose last entry is a bool tensor, captured as CUDA
    graphs on one set of static inputs per argument shape.  A call copies
    its arguments in and replays ``fast``; when ``fast``'s flag has a true
    entry (one host read, ``HOST_READS[loop]``) it replays ``full`` on the
    same inputs, captured at its first use.  Returns the outputs of the
    graph replayed, buffers that its next replay overwrites.  A failed
    capture raises."""

    def __init__(self, fast, full, loop: str):
        self.fast, self.full, self.loop = fast, full, loop
        self._graphs = {}
        self.replays = Counter()  # "fast" and "full" replays

    def _entry(self, args):
        """[inputs, fast graph, its outputs, full graph, its outputs] for
        the shapes of ``args``, the full pair still None until first used."""
        key = tuple((tuple(a.shape), a.dtype) for a in args)
        if key not in self._graphs:
            inputs = tuple(a.clone() for a in args)
            self._graphs[key] = [inputs, *_capture(self.fast, inputs), None, None]
        return self._graphs[key]

    def _full(self, entry):
        if entry[3] is None:
            entry[3], entry[4] = _capture(self.full, entry[0])
        return entry[3], entry[4]

    def graphs(self, *args):
        """The fast and the full graph for arguments of these shapes (to time
        them), capturing what is not yet captured."""
        entry = self._entry(args)
        return entry[1], self._full(entry)[0]

    def __call__(self, *args):
        entry = self._entry(args)
        for dst, src in zip(entry[0], args):
            if dst is not src:
                dst.copy_(src)
        entry[1].replay()
        self.replays["fast"] += 1
        outputs = entry[2]
        if any_running(outputs[-1], self.loop):
            graph, outputs = self._full(entry)
            graph.replay()
            self.replays["full"] += 1
        return outputs


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
    """``fn`` over the tensors of equally shaped (Named)tuples and dicts of
    tensors."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, tuple):
        vals = [tree_map(fn, *leaves) for leaves in zip(*trees)]
        return type(first)(*vals) if hasattr(first, "_fields") else tuple(vals)
    return fn(*trees)


def select(mask, a, b):
    """Per lane: ``a`` where ``mask`` is true, else ``b``, through tuples
    and NamedTuples of tensors.  A ``torch.where``, never a multiply by the
    mask, so that NaN or inf in a discarded lane never reaches a kept one."""
    return tree_map(lambda u, v: torch.where(lanes(mask, u.ndim - mask.ndim), u, v), a, b)


def masked_while(cond, body, carry, every, loop: str, trips=None):
    """``lax.while_loop(cond, body, carry)`` as masked iterations: each
    iteration applies ``body`` only on the lanes where ``cond`` holds, so a
    lane whose loop has ended keeps its carry bit for bit.  Whether any lane
    still runs is read on the host before every ``every``-th iteration
    (``HOST_READS[loop]``); with ``every`` 0 there is no read and the loop
    runs ``trips`` iterations, as a CUDA graph needs.  The result does not
    depend on ``every``.  ``trips`` bounds the iterations (None: no bound,
    which needs ``every``)."""
    if not every and trips is None:
        raise ValueError("a loop with no host read needs a trip count")
    i = 0
    while trips is None or i < trips:
        active = cond(carry)
        if every and i % every == 0 and not any_running(active, loop):
            break
        carry = select(active, body(carry), carry)
        i += 1
    return carry


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


UNROLL_MAX = 16
"""Longest axis that the fixed-order sums below unroll."""


def rowsum(v):
    """Sum over the last axis.  Up to ``UNROLL_MAX`` entries it is a fixed
    left-to-right chain of elementwise additions, so that one instance, a
    lane stack of any width, the CPU and a card add in the same order and
    give the same bits (a library reduction's order depends on the shape
    and the device)."""
    k = v.shape[-1]
    if k == 0:
        return v.new_zeros(v.shape[:-1])
    if k > UNROLL_MAX:
        return torch.sum(v, dim=-1)
    total = v[..., 0]
    for i in range(1, k):
        total = total + v[..., i]
    return total


def rowdot(x, y):
    """Inner product over the last axis in ``rowsum``'s order."""
    return rowsum(x * y)


def small_matvec(a, x):
    """``a @ x`` for a matrix (..., k, n) and a vector (..., n), summed over
    ``n`` in ``rowsum``'s order."""
    n = x.shape[-1]
    if n == 0:
        return a.new_zeros(a.shape[:-1])
    if n > UNROLL_MAX:
        return matvec(a, x)
    total = a[..., :, 0] * x[..., 0, None]
    for i in range(1, n):
        total = total + a[..., :, i] * x[..., i, None]
    return total


def norm_sq(x):
    return dot(x, x)


def norm_mult(*args):
    """Joint Euclidean norm of several vectors (reference ``util.py:19-25``)."""
    value = 0.0
    for arg in args:
        value = value + norm_sq(arg)
    return torch.sqrt(value)


def keep_rows(mat, row_mask):
    """Zero the rows of ``mat`` where ``row_mask`` is False, keeping the
    shape (reference ``util.py:27-55``)."""
    return torch.where(row_mask[..., :, None], mat, torch.zeros_like(mat))


def inf_norm(x):
    """Infinity norm over the last axis that is 0 for empty vectors."""
    if x.shape[-1] == 0:
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    return torch.amax(torch.abs(x), dim=-1)
