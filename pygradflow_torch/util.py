"""Small numeric helpers (counterpart of ``pygradflow_tpu/util.py``).

Every helper acts on the last axis, so it serves one instance (vectors
(n,)) and a lane stack (B, n) alike.
"""

import contextlib
import gc
import itertools
import threading
import time
import weakref
from collections import Counter, deque
from typing import NamedTuple

import torch

from .status import RUNNING

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
"""The process's solve-loop captures, a ``ChunkGraph``'s and a single
solver's start graph (``solver.SolveLoop.graphed_start``): ``graphs``
captured and ``ns``, the host time they took, warm-up run included."""

REPLAYS = Counter()
"""The process's ``ChunkGraph`` replays: ``bodies``, the graph replays run
(one loop body each), and ``stopped``, the chunks that ended before their
``k`` bodies because a replay's done flag read terminal."""

STARTS = Counter()
"""The process's single-solve starts (``solver.Solver``): ``graphed``,
starts evaluated by a replay of the solver's start graph; ``eager``, starts
evaluated eagerly, on the CPU or on the card's eager route; ``fallback``,
graphed starts whose input check read a false verdict, or was captured
with shapes that are not the problem's, so that the eager check ran to
name the failure."""

LOOKAHEAD = 2
"""Graph replays that ``ChunkGraph.run`` keeps queued ahead of the done
flag it reads (``replay_until_done``): before it enqueues replay ``i`` it
waits for replay ``i - LOOKAHEAD`` and reads that replay's flag, so
``LOOKAHEAD - 1`` bodies stay queued on the device while the host wakes,
reads and enqueues the next one, and a chunk that ends early runs at most
``LOOKAHEAD - 1`` bodies past its terminal one.  Measured on an H100
(Rosenbrock under ``Params()``, no profiler): the host enqueues a replay
in about 31 us, and a body runs 0.74 ms on the device at width 1 and
0.95 ms at width 16384, so one queued body covers the host's turn more
than twenty times over; the flag's copy, event and read leave a body's
device time as it was."""

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


@contextlib.contextmanager
def _capturing(graph, stream, pool):
    """``torch.cuda.graph(graph)`` on ``stream`` into the memory pool
    ``pool``, in ``thread_local`` mode and with no garbage collected during
    the capture: only this thread's CUDA calls can invalidate it (a
    collection in another thread of the process, a worker pool's result
    handler say, frees CUDA memory and destroys graphs outside the
    capture).  A capture that fails leaves no state behind: the current
    stream is restored and the allocator no longer routes allocations to
    ``pool``, so the process goes on solving and capturing."""
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.stream(stream):
            try:
                with torch.cuda.graph(graph, pool=pool, stream=stream, capture_error_mode="thread_local"):
                    yield
            except BaseException:
                _stop_allocating_to(stream.device, pool)
                raise
    finally:
        if collecting:
            gc.enable()


def _stop_allocating_to(device, pool) -> None:
    """End the allocator's routing to ``pool``, which a capture whose end
    failed leaves on (``torch.cuda.graph`` ends it only after a successful
    end of capture)."""
    end = getattr(torch._C, "_cuda_endAllocateToPool", None)
    if end is None:
        return
    try:
        end(device.index, pool)
    except RuntimeError:
        pass  # the capture's own end had stopped it


def _capture(fn, inputs, diagnose=None, what="a function"):
    """``fn(*inputs)`` captured as a CUDA graph after one warm-up run on a
    side stream (``_capturing``'s rules); returns the graph and its output
    tensors.  With ``diagnose``, a capture that fails (not the warm-up)
    raises ``capture_error``'s :class:`GraphCaptureError` for ``what``,
    naming ``diagnose()``'s problem function."""
    stream = torch.cuda.Stream(device=inputs[0].device)
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn(*inputs)  # warm-up: cuBLAS handles and workspaces outside the capture
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    try:
        with _capturing(graph, stream, torch.cuda.graph_pool_handle()):
            outputs = fn(*inputs)
    except RuntimeError as err:
        if diagnose is None:
            raise
        raise capture_error(err, diagnose(), what) from err
    return graph, outputs


def cuda_graphed(fn, example, diagnose=None, what="a function"):
    """``fn``, a function of a tuple of CUDA tensors that returns a tuple
    (tree) of tensors and reads nothing on the host, captured once
    as a CUDA graph (``_capture``, with its ``diagnose`` and ``what``).
    The callable returned copies its arguments into the graph's inputs,
    replays the graph and returns its output tensors, which the next replay
    overwrites."""
    inputs = tuple(t.clone() for t in example)
    graph, outputs = _capture(fn, inputs, diagnose, what)

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


def _flat(tree):
    """The tensors of a (Named)tuple and dict tree, in order."""
    if isinstance(tree, dict):
        return [t for k in tree for t in _flat(tree[k])]
    if isinstance(tree, tuple):
        return [t for leaf in tree for t in _flat(leaf)]
    return [tree]


class GraphCaptureError(RuntimeError):
    """A part of the solve loop (its iteration, or a single solve's start)
    could not be captured as a CUDA graph: something in it reads the
    host."""


def capture_error(err, name, what) -> GraphCaptureError:
    """The error of a failed capture of ``what``: it names the problem
    function ``name`` that reads the host when there is one (None: no
    problem function was found at fault)."""
    if name is not None:
        return GraphCaptureError(
            f"the problem's {name} reads the host (a Python branch on a tensor, "
            ".item(), .tolist(), or a copy between host and device memory), so the "
            f"solve loop cannot run as a CUDA graph: write it as pure tensor code ({err})"
        )
    return GraphCaptureError(f"capturing {what} failed: {err}")


def replay_until_done(replay, done, k: int, lookahead: int) -> int:
    """Up to ``k`` graph replays with ``lookahead`` of them in flight,
    stopped once a replay's done flag reads true.  ``replay(i)`` enqueues
    replay ``i`` (from 0) and the copy of its done flag; ``done(i)`` waits
    for replay ``i`` and reads its flag.  Before replay ``i >= lookahead``
    the flag read is replay ``i - lookahead``'s own, so the count is exact:
    if the ``t``-th replay (from 1) is the first whose flag is true, the
    replays made are ``min(k, t + lookahead - 1)``.  Returns that count."""
    for i in range(k):
        if i >= lookahead and done(i - lookahead):
            return i
        replay(i)
    return k


class ChunkGraph:
    """A loop body ``body(state) -> state`` run on the card as a CUDA graph,
    the counterpart of the JAX package's ``lax.while_loop`` chunk.

    For each shape of the state (a width tier of a lane stack) the body is
    captured once (``_capturing``'s rules, after a warm-up on the capture
    stream) on static state buffers, with its result copied back into them
    and a one-element done flag set: every entry of the state's ``status``
    terminal.  A chunk copies the state in and replays the graph up to
    ``k`` times with no blocking read of the state: after each replay the
    host copies the done flag into a pinned slot of its own and records an
    event, and it stops once a flag ``LOOKAHEAD`` replays back reads true
    (``replay_until_done``).  A terminal state passes through a replay
    unchanged (the body's masked select), so the chunk's result does not
    depend on ``k`` or on where the replays stop.  The stop is the host's,
    with plain replays, copies and events: a conditional IF node around the
    body stopped the replays on the device, but on a card time-sliced
    between several processes its launches failed at random with an
    unspecified launch failure.  Every shape shares one memory pool:
    nothing allocated during a capture outlives it, so each graph's pool
    memory is scratch of its own replay.  A failed capture raises
    :class:`GraphCaptureError`, naming through ``diagnose(state)`` the
    problem function that reads the host when there is one; there is no
    eager fallback.

    The state returned is the static buffers, which the next chunk of the
    same shape goes on from and overwrites; ``replayed`` is the number of
    replays the last chunk made (``REPLAYS`` sums them).  The kernels
    launched in the body count their launches on the device
    (``count_launch``), once per body run."""

    def __init__(self, body, diagnose=None):
        # a bound method is held weakly: the loop that owns this graph owns
        # its body, and no cycle keeps the graph's memory past the loop
        self._body = weakref.WeakMethod(body) if hasattr(body, "__self__") else (lambda: body)
        self.diagnose = diagnose
        self._entries = {}
        self._pool = None
        self._flags = None  # pinned slots of the done flags and their events
        self.captures = 0
        self.capture_seconds = 0.0
        self.replayed = 0

    @staticmethod
    def _key(state):
        return tuple((tuple(t.shape), t.dtype) for t in _flat(state))

    def _capture(self, state):
        device = state.status.device
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        device_launches(device)
        t0 = time.perf_counter_ns()
        static = tree_map(torch.clone, state)
        stream = torch.cuda.Stream(device=device)
        stream.wait_stream(torch.cuda.current_stream(device))
        body = self._body()
        with torch.cuda.stream(stream):
            body(static)  # warm-up: handles, workspaces and caches outside the capture
        torch.cuda.current_stream(device).wait_stream(stream)

        done = torch.zeros((), dtype=torch.bool, device=device)
        graph = torch.cuda.CUDAGraph()
        try:
            with _capturing(graph, stream, self._pool):
                for dst, src in zip(_flat(static), _flat(body(static))):
                    if dst is not src:
                        dst.copy_(src)
                torch.all(static.status != RUNNING, out=done)
        except RuntimeError as err:
            name = self.diagnose(state) if self.diagnose is not None else None
            raise capture_error(err, name, "the solve loop's iteration") from err

        entry = {"static": static, "graph": graph, "done": done}
        ns = time.perf_counter_ns() - t0
        self.captures += 1
        self.capture_seconds += ns * 1e-9
        CAPTURES.update(graphs=1, ns=ns)
        return entry

    def entry(self, state):
        """The captured graph for states of this shape, captured now if new."""
        key = self._key(state)
        if key not in self._entries:
            self._entries[key] = self._capture(state)
        return self._entries[key]

    def run(self, state, k: int):
        """Up to ``k`` graph replays from ``state``, ending ``LOOKAHEAD - 1``
        replays after the first whose state is terminal; those bodies keep
        the state bit for bit."""
        entry = self.entry(state)
        static, graph, done = entry["static"], entry["graph"], entry["done"]
        for dst, src in zip(_flat(static), _flat(state)):
            if dst is not src:
                dst.copy_(src)
        if self._flags is None:
            pinned = torch.zeros(LOOKAHEAD + 1, dtype=torch.bool, pin_memory=True)
            self._flags = ([pinned[j] for j in range(LOOKAHEAD + 1)], pinned.numpy(),
                           [torch.cuda.Event() for _ in range(LOOKAHEAD + 1)])
        slots, flags, events = self._flags
        stream = torch.cuda.current_stream(done.device)

        def replay(i):
            graph.replay()
            slots[i % len(slots)].copy_(done, non_blocking=True)
            events[i % len(slots)].record(stream)

        def read(i):
            events[i % len(slots)].synchronize()
            return bool(flags[i % len(slots)])

        self.replayed = replay_until_done(replay, read, k, len(slots) - 1)
        REPLAYS.update(bodies=self.replayed, stopped=int(self.replayed < k))
        return static


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
