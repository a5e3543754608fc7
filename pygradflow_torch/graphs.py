"""The CUDA graph runtime: the one warm-up-then-capture sequence
(``capture``) and what is built on it, ``cuda_graphed`` (a function
replayed), ``GraphPair`` (a fast graph and a full one) and ``ChunkGraph``
(a solve loop's body replayed up to a chunk's length).  The JAX package
has no counterpart: XLA compiles its loops whole.
"""

import contextlib
import gc
import time
import weakref
from collections import Counter

import torch

from .status import RUNNING
from .util import CAPTURES, any_running, device_launches, tree_map

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


def capture(fn, inputs, diagnose=None, what="a function", pool=None):
    """``fn(*inputs)``, ``inputs`` a tuple of tensor trees, captured as a
    CUDA graph after one warm-up run on a side stream (``_capturing``'s
    rules), into the memory pool ``pool`` (a new one when None); returns
    the graph and its output tensors.  With
    ``diagnose``, a capture that fails (not the warm-up) raises
    ``capture_error``'s :class:`GraphCaptureError` for ``what``, naming
    ``diagnose()``'s problem function."""
    device = _flat(inputs)[0].device
    stream = torch.cuda.Stream(device=device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        fn(*inputs)  # warm-up: cuBLAS handles, workspaces and caches outside the capture
    torch.cuda.current_stream(device).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    try:
        with _capturing(graph, stream, torch.cuda.graph_pool_handle() if pool is None else pool):
            outputs = fn(*inputs)
    except RuntimeError as err:
        if diagnose is None:
            raise
        raise capture_error(err, diagnose(), what) from err
    return graph, outputs


def cuda_graphed(fn, example, diagnose=None, what="a function"):
    """``fn``, a function of a tuple of CUDA tensors that returns a tuple
    (tree) of tensors and reads nothing on the host, captured once
    as a CUDA graph (``capture``, with its ``diagnose`` and ``what``).
    The callable returned copies its arguments into the graph's inputs,
    replays the graph and returns its output tensors, which the next replay
    overwrites."""
    inputs = tuple(t.clone() for t in example)
    graph, outputs = capture(fn, inputs, diagnose, what)

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
            self._graphs[key] = [inputs, *capture(self.fast, inputs), None, None]
        return self._graphs[key]

    def _full(self, entry):
        if entry[3] is None:
            entry[3], entry[4] = capture(self.full, entry[0])
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
    captured once (``capture``) on static state buffers, with its result
    copied back into them and a one-element done flag set: every entry of
    the state's ``status`` terminal.  A chunk copies the state in and
    replays the graph up to ``k`` times with no blocking read of the state:
    after each replay the host copies the done flag into a pinned slot of
    its own and records an event, and it stops once a flag ``LOOKAHEAD``
    replays back reads true (``replay_until_done``).  A terminal state
    passes through a replay unchanged (the body's masked select), so the
    chunk's result does not depend on ``k`` or on where the replays stop.
    The stop is the host's, with plain replays, copies and events: a
    conditional IF node around the body stopped the replays on the device,
    but on a card time-sliced between several processes its launches failed
    at random with an unspecified launch failure.  Every shape shares one
    memory pool: nothing allocated during a capture outlives it, so each
    graph's pool memory is scratch of its own replay.  A failed capture
    raises :class:`GraphCaptureError`, naming through ``diagnose(state)``
    the problem function that reads the host when there is one; there is
    no eager fallback.

    The state returned is the static buffers, which the next chunk of the
    same shape goes on from and overwrites.  ``captures`` counts the shapes
    captured (each also in ``util.CAPTURES``), ``replayed`` the replays of
    the last chunk.  The kernels launched in the body count their launches
    on the device (``util.count_launch``), once per body run."""

    def __init__(self, body, diagnose=None):
        # a bound method is held weakly: the loop that owns this graph owns
        # its body, and no cycle keeps the graph's memory past the loop
        self._body = weakref.WeakMethod(body) if hasattr(body, "__self__") else (lambda: body)
        self.diagnose = diagnose
        self._entries = {}
        self._pool = None
        self._flags = None  # pinned slots of the done flags and their events
        self.captures = 0
        self.replayed = 0

    def _capture(self, state):
        device = state.status.device
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        device_launches(device)
        t0 = time.perf_counter_ns()
        static = tree_map(torch.clone, state)
        done = torch.zeros((), dtype=torch.bool, device=device)
        body = self._body()

        def step(static):
            for dst, src in zip(_flat(static), _flat(body(static))):
                if dst is not src:
                    dst.copy_(src)
            torch.all(static.status != RUNNING, out=done)

        diagnose = self.diagnose or (lambda state: None)
        graph, _ = capture(step, (static,), lambda: diagnose(state), "the solve loop's iteration", self._pool)
        self.captures += 1
        CAPTURES.update(graphs=1, ns=time.perf_counter_ns() - t0)
        return static, graph, done

    def entry(self, state):
        """The static state, the graph and the done flag for states of this
        shape, captured now if new."""
        key = tuple((tuple(t.shape), t.dtype) for t in _flat(state))
        if key not in self._entries:
            self._entries[key] = self._capture(state)
        return self._entries[key]

    def run(self, state, k: int):
        """Up to ``k`` graph replays from ``state``, ending ``LOOKAHEAD - 1``
        replays after the first whose state is terminal; those bodies keep
        the state bit for bit."""
        static, graph, done = self.entry(state)
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
        return static
