"""Small numeric helpers (counterpart of ``pygradflow_tpu/util.py``) and
the solve's telemetry.

Every numeric helper acts on the last axis, so it serves one instance
(vectors (n,)) and a lane stack (B, n) alike.  The telemetry is the
process's counters, the program spans (``span``) and the kernel launch
counts (``count_launch``); the CUDA graph runtime is ``graphs.py``.
"""

import contextlib
import itertools
import threading
import time
from collections import Counter, deque
from typing import NamedTuple

import torch

HOST_READS = Counter()
"""Host reads, one count per read, keyed by loop: ``chunk``, the solve
loop's one read per chunk of ``params.jit_chunk`` iterations (single and
lockstep), ``start``, a single solve's one read of its input check's
verdicts on the graphed route, and ``eager``, the per-iteration reads of
the loop run without a CUDA graph on the card; the inner loops that stop
when no lane still runs (the box solver, the interior point, MINRES and
GMRES, and the continuous engine's loops: ``newton``, ``segment``,
``bisect``, ``device_loop`` and ``flat``, and ``branch``, the reads that
skip a branch no lane takes)."""

LAUNCH_COUNTERS = []
"""The kernel wrappers' launch counts: dicts of ints whose keys are fixed
when they register (``register_launches``).  A wrapper counts each launch
where it makes it, through ``count_launch``."""

LAUNCH_SLOTS = 16
"""Entries of a device's launch counts: room for every key registered, also
for a wrapper module imported after a first graph was captured."""

_DEVICE_LAUNCHES = {}
"""Per device: [the launches counted on the device by CUDA graph replays,
one int64 entry per key of ``LAUNCH_COUNTERS`` in order (``LAUNCH_SLOTS``
of them), and the part of each already added on the host]."""


CAPTURES = Counter()
"""The process's solve-loop captures, a loop body's (``graphs.py``) and a
single solver's start graph (``solver.SolveLoop.graphed_start``):
``graphs`` captured and ``ns``, the host time they took, warm-up run
included."""

STARTS = Counter()
"""The process's single-solve starts (``solver.Solver``): ``graphed``,
starts evaluated by a replay of the solver's start graph; ``eager``, starts
evaluated eagerly, on the CPU or on the card's eager route; ``fallback``,
graphed starts whose input check read a false verdict, or was captured
with shapes that are not the problem's, so that the eager check ran to
name the failure."""

SPAN_RING = 65536


class Span(NamedTuple):
    """One program span: ``index`` numbers every span recorded in the
    process, ``parent`` is the index of the span that encloses it (-1 for
    none), ``call`` the ``begin_call`` number of the solve it belongs to;
    times are ``time.time_ns()``, the clock of the profiler's events."""

    index: int
    name: str
    start_ns: int
    end_ns: int
    call: int
    parent: int
    attrs: dict


SPANS = deque(maxlen=SPAN_RING)
"""The last ``SPAN_RING`` program spans (``Span``), in the order they
ended.  ``span`` records only while a ``torch.profiler`` records."""

_NO_SPAN = contextlib.nullcontext()
_SPAN_INDEX = itertools.count()
_CALLS = itertools.count(1)
_call = 0
_open_spans = threading.local()  # the indices of this thread's open spans
_profiler_enabled = torch._C._autograd._profiler_enabled


def begin_call() -> None:
    """Start a new solve call: the spans recorded from here on carry its
    number."""
    global _call
    _call = next(_CALLS)


def span(name: str, **attrs):
    """A context manager that records the host's time inside it as a
    ``Span`` in ``SPANS`` and as an operator event ``name`` in the
    profiler's trace, while a ``torch.profiler`` records; it enters as the
    span's ``attrs`` dict, which the site may update until the span ends.
    Otherwise it returns one shared null context, which enters as None: no
    record, no clock read.  Span sites
    lie at the solve drivers' layer boundaries, never inside a captured body or
    around a single graph replay.

    The profiler's copy is a record function of operator scope, not
    ``torch.profiler.record_function``: the profiler mirrors a user
    annotation onto the device's timeline over the kernels launched inside
    it, and torch 2.11 reports that mirror as a kernel, which a reader of
    the trace would count as device work."""
    if not _profiler_enabled():
        return _NO_SPAN
    return _recorded(name, attrs)


@contextlib.contextmanager
def _recorded(name, attrs):
    stack = _open_spans.__dict__.setdefault("stack", [])
    parent = stack[-1] if stack else -1
    index = next(_SPAN_INDEX)
    stack.append(index)
    event = torch._C._profiler._RecordFunctionFast(name)
    # each clock read follows the profiler's own by about a microsecond
    event.__enter__()
    start = time.time_ns()
    try:
        yield attrs
    finally:
        event.__exit__(None, None, None)
        end = time.time_ns()
        stack.pop()
        SPANS.append(Span(index, name, start, end, _call, parent, attrs))


def register_launches(counter) -> None:
    """Register a wrapper module's launch counts in ``LAUNCH_COUNTERS``."""
    if len(_launch_keys()) + len(counter) > LAUNCH_SLOTS:
        raise RuntimeError(f"more than LAUNCH_SLOTS = {LAUNCH_SLOTS} kernel launch counts")
    LAUNCH_COUNTERS.append(counter)


def _launch_keys():
    return [(counter, name) for counter in LAUNCH_COUNTERS for name in counter]


_LAUNCH_LOCK = threading.Lock()  # the shards of a mesh read in a thread per device


def device_launches(device):
    """The launch counts that CUDA graph replays made on ``device``, one
    entry per key of ``LAUNCH_COUNTERS`` and zeros after them; made on first
    use, which must come before a graph that launches a counted kernel is
    captured."""
    with _LAUNCH_LOCK:
        if device not in _DEVICE_LAUNCHES:
            zeros = torch.zeros(LAUNCH_SLOTS, dtype=torch.int64, device=device)
            _DEVICE_LAUNCHES[device] = [zeros, [0] * LAUNCH_SLOTS]
        return _DEVICE_LAUNCHES[device][0]


def count_launch(counter, name, device, times: int = 1) -> None:
    """Count ``times`` launches of kernel ``name`` in ``counter``.  A launch
    made while a CUDA graph is captured is counted by an add on the device,
    captured beside the kernel, so that every replay that runs the launch
    counts it; ``add_device_launches`` brings those counts to the host."""
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        if device not in _DEVICE_LAUNCHES:
            raise RuntimeError(f"{name}: launched in a CUDA graph capture without device_launches({device})")
        slot = next(i for i, (c, k) in enumerate(_launch_keys()) if c is counter and k == name)
        _DEVICE_LAUNCHES[device][0][slot].add_(times)
    else:
        counter[name] += times


def add_device_launches(device, values) -> None:
    """Add to ``LAUNCH_COUNTERS`` the launches that graph replays counted on
    ``device`` since the last call; ``values`` is ``device_launches(device)``
    read on the host (with a loop's one read per chunk)."""
    with _LAUNCH_LOCK:
        seen = _DEVICE_LAUNCHES[device][1]
        for i, ((counter, name), value) in enumerate(zip(_launch_keys(), values)):
            counter[name] += int(value) - seen[i]
            seen[i] = int(value)


def any_running(running, loop: str) -> bool:
    """Whether any lane (or the one instance) still runs: one host read,
    counted in ``HOST_READS[loop]``."""
    HOST_READS[loop] += 1
    return bool(running.any())


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
    """Inner product over the last axis.  Of empty vectors (a problem
    without constraints) it is a zero made by a kernel: the library's
    product of no entries leaves a node that a CUDA graph's conditional
    node refuses at instantiation."""
    if x.shape[-1] == 0:
        return x.new_zeros(torch.broadcast_shapes(x.shape, y.shape)[:-1])
    if x.ndim == 1:
        return torch.dot(x, y)
    return torch.linalg.vecdot(x, y)


def matvec(a, x):
    """``a @ x`` for a matrix (..., k, n) and a vector (..., n); zeros made
    by a kernel when n is 0, as ``dot``."""
    if a.shape[-1] == 0:
        return a.new_zeros(torch.broadcast_shapes(a.shape[:-2], x.shape[:-1]) + a.shape[-2:-1])
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
