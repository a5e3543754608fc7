"""One run of one cell: set-up, the measured window, the traced stretch,
and the comparison that decides ``correct``.

Set-up builds the cell's one solver and warms every shape its traffic
uses: one warm solve for a single mix, one per width tier for a batched
one (``BatchedSolver`` captures a CUDA graph per width, and a compacting
solve may shrink to any power-of-four tier down to ``min_tier``).  On the
card it then settles: it goes on solving the warm-up's traffic for
``SETTLE_SECONDS``, because a process's calls there run 10-15% slower for
its first 20-40 s, and the window is to read the steady state.  The
window is a closed loop: draw the next instances (their data and
starts), solve, synchronise, keep the answer with the instances it
answers; until ``seconds`` have passed.  With ``trace`` the profiler
covers a bounded stretch near the window's end (from ``2 *
TRACE_SECONDS`` before it: at least ``TRACE_MIN_CALLS`` calls and
``TRACE_SECONDS``, at most ``TRACE_MAX_CALLS`` calls), where the process
has run longest.  Once the window has closed the memory peak
is read, the solver freed, and the answers, copied to the host after each
call, are judged (``harness.judge``).

Every metric, end-to-end or per-layer, is read by
``metrics/<name>.py``'s ``read(ctx)`` from the ``Context`` below; a reader
that finds nothing to read returns None and the metric is left out.
"""

import dataclasses
import enum
import gc
import math
import time
from types import SimpleNamespace

import numpy as np

from . import judge
from .manifest import Manifest
from .stats import percentile
from .trace import STRETCH, Trace
from .traffic import Traffic, validate

TRACE_SECONDS = 1.0
TRACE_MIN_CALLS = 2
TRACE_MAX_CALLS = 64
SETTLE_SECONDS = 24.0
WARM_SEED_OFFSET = 0x5EED  # the warm-up's instances: another stream of the same seed


def json_safe(value):
    """``value`` with every non-finite float (a failed solve's time, the
    residual of a non-finite answer) as None, so that the result line is
    strict JSON."""
    if isinstance(value, float):
        return value if math.isfinite(value) else None
    if isinstance(value, dict):
        return {k: json_safe(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [json_safe(v) for v in value]
    return value


def make_params(numbers, overrides=None):
    """``pygradflow_torch.Params`` from a configuration's ``params``: enum
    fields given by member name."""
    from pygradflow_torch import Params

    defaults = Params()
    kwargs = {}
    for key, value in {**numbers["params"], **(overrides or {})}.items():
        if not any(f.name == key for f in dataclasses.fields(Params)):
            raise KeyError(f"Params has no field {key!r}")
        default = getattr(defaults, key)
        if isinstance(default, enum.Enum) and isinstance(value, str):
            value = type(default)[value]
        kwargs[key] = value
    return Params(**kwargs)


def tier_widths(solver, lanes):
    """The lane widths a batched solve of ``lanes`` starts can run at: the
    batch, and with compaction every power-of-four tier down to
    ``min_tier`` (``BatchedSolver._solve_compacting``)."""
    compact = solver.compact if solver.compact is not None else lanes >= 4 * solver.min_tier
    widths = [lanes]
    while compact and widths[-1] // 4 >= solver.min_tier:
        widths.append(widths[-1] // 4)
    return widths


class Cell:
    """The program under test for one cell: its problem, params, solver
    and traffic, on ``device``."""

    def __init__(self, manifest: Manifest, name, seed, device, overrides=None):
        import torch

        from pygradflow_torch import Solver
        from pygradflow_torch.parallel import BatchedSolver

        self.name = name
        self.spec = manifest.cell(name)
        self.numbers = manifest.config_numbers(self.spec["config"])
        config = manifest.config_module(self.spec["config"])
        self.data_names = tuple(getattr(config, "DATA", ()))
        self.mix = validate(manifest.traffic(self.spec["traffic"]), self.data_names)
        self.params = make_params(self.numbers, overrides)
        self.device = torch.device(device)
        self.problem = config.make_problem(self.numbers, self.mix["size"], self.device, self.params.dtype)
        base = config.base_start(self.problem)
        dtype = self.params.dtype
        self.traffic = Traffic(self.mix, base, self.data_names, seed, self.device, dtype)
        self.warm_traffic = Traffic(self.mix, base, self.data_names, seed + WARM_SEED_OFFSET, self.device, dtype)
        self.batched = self.mix["kind"] == "batched"
        if self.batched:
            self.solver = BatchedSolver(self.problem, self.params, device=self.device)
        else:
            self.solver = Solver(self.problem, self.params, device=self.device)

    @property
    def graph(self):
        loop = self.solver.loop if self.batched else self.solver._loop
        return loop.graph

    def solve(self, x0, data):
        """One call on the instances ``data`` from ``x0``; returns the answer
        as (status, iterations, x, y, residual): status and iterations
        (lanes,) int64, x and y (lanes, ...), and the optimality measure the
        solver reports for its answer (lanes,), tensors left where the
        solver put them.  A single solver poses its instance by the
        problem's ``example_data``, overwritten in place."""
        import torch

        if self.batched:
            res = self.solver.solve(x0, data=data or None)
            return res.status, res.iterations, res.x, res.y, res.total_res
        for buf, leaf in zip(getattr(self.problem, "example_data", ()), data):
            buf.copy_(leaf)
        res = self.solver.solve(x0)
        status = torch.tensor([int(res.status)])
        reported = torch.tensor([max(res.final_stat_res, res.final_cons_violation)])
        return status, torch.tensor([res.iterations]), res.x[None], res.y[None], reported

    def warm(self):
        """One warm solve at each width the traffic can run at."""
        x0, data = self.warm_traffic.draw()
        widths = tier_widths(self.solver, self.mix["lanes"]) if self.batched else [None]
        for width in widths:
            if width is None:
                self.solve(x0, data)
            else:
                self.solve(x0[:width], tuple(leaf[:width] for leaf in data))
        self.sync()

    def settle(self, seconds):
        """Calls on the warm-up's traffic until ``seconds`` have passed."""
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            self.solve(*self.warm_traffic.draw())
            self.sync()

    def sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def _counters():
    from pygradflow_torch.linalg import ldlt_kernels
    from pygradflow_torch.util import HOST_READS

    return HOST_READS["chunk"], dict(ldlt_kernels.LAUNCHES)


def _close_stretch(span, prof, before, first, end):
    """The traced stretch of calls ``first`` to ``end`` (exclusive), its
    profiler and span stopped."""
    span.__exit__(None, None, None)
    after = _counters()
    prof.__exit__(None, None, None)
    return SimpleNamespace(
        calls=slice(first, end),
        chunk_reads=after[0] - before[0],
        launches={k: after[1][k] - before[1].get(k, 0) for k in after[1]},
        trace=Trace.from_profile(prof),
    )


def _host(answer, data, lanes):
    """The answer and its instances' data on the host, the data with a
    leading lane axis."""
    host = tuple(t.detach().to("cpu").numpy() for t in answer)
    return host + tuple(leaf.to("cpu").numpy().reshape((lanes, -1)) for leaf in data)


def _window(cell, seconds, trace):
    """The measured window: ``(t_start, calls, stretch)``, the calls as
    (start, end, answer and instances on the host) and the traced stretch
    (None without ``trace``)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cell.device.type == "cuda" else [])
    calls = []
    stretch = prof = span = None
    t_start = time.perf_counter()
    deadline = t_start + seconds
    trace_from = t_start + max(0.0, seconds - 2 * TRACE_SECONDS) if trace else math.inf
    while not calls or time.perf_counter() < deadline:
        if stretch is None and span is None and time.perf_counter() >= trace_from:
            prof = profile(activities=activities)
            prof.__enter__()
            span = record_function(STRETCH)
            span.__enter__()
            before, first = _counters(), len(calls)
        with record_function("draw"):
            x0, data = cell.traffic.draw()
        t0 = time.perf_counter()
        with record_function("solve"):
            answer = cell.solve(x0, data)
        with record_function("sync"):
            cell.sync()
        t1 = time.perf_counter()
        with record_function("check"):  # the answer leaves the card, as a caller takes it
            calls.append((t0, t1, _host(answer, data, cell.mix["lanes"])))
        if span is not None and (
            len(calls) - first >= TRACE_MAX_CALLS
            or (len(calls) - first >= TRACE_MIN_CALLS and t1 - trace_from >= TRACE_SECONDS)
        ):
            stretch = _close_stretch(span, prof, before, first, len(calls))
            span = prof = None
    if span is not None:  # the window closed inside the stretch
        stretch = _close_stretch(span, prof, before, first, len(calls))
    return t_start, calls, stretch


def run(name, seed, seconds, trace, device="cuda", manifest=None, t_process=None, overrides=None):
    """One run of cell ``name``; returns ``(result, lines)``: the result
    line's object and the lines for standard error, which end with each
    compared number beside its limit.  ``t_process`` is the process's
    start on ``time.perf_counter``'s clock (default: now); ``overrides``
    replace fields of the configuration's ``Params`` (the control's
    precision)."""
    import torch

    from pygradflow_torch import SolverStatus

    if t_process is None:
        t_process = time.perf_counter()
    manifest = manifest or Manifest()
    t_built = time.perf_counter()
    cell = Cell(manifest, name, seed, device, overrides)
    t_warm = time.perf_counter()
    cell.warm()
    on_card = cell.device.type == "cuda"
    t_settle = time.perf_counter()
    if on_card:
        cell.settle(SETTLE_SECONDS)
    captures_warm = cell.graph.captures if on_card else 0
    # what set-up made lives on: out of the collector's full passes, which
    # would otherwise walk it during the window
    gc.collect()
    gc.freeze()
    t_start, calls, stretch = _window(cell, seconds, trace)
    captures_in_window = (cell.graph.captures if on_card else 0) - captures_warm
    gc.unfreeze()

    peak = torch.cuda.max_memory_allocated(cell.device) if on_card else 0
    answers = [a for _, _, a in calls]
    times = [(t0, t1) for t0, t1, _ in calls]
    spec, numbers, mix, params, data_names = cell.spec, cell.numbers, cell.mix, cell.params, cell.data_names
    n, m = cell.problem.num_vars, cell.problem.num_cons
    del calls, cell
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    status, iterations, x, y, reported, *leaves = (np.concatenate(parts) for parts in zip(*answers))
    limits = manifest.limits(name)["limits"]
    verdict = judge.judge(manifest.reference(spec["config"]), numbers, mix["size"], status, x, y,
                          dict(zip(data_names, leaves)), limits, reported)

    optimal = int(SolverStatus.Optimal)
    lanes = mix["lanes"]
    ctx = SimpleNamespace(
        kind=mix["kind"], lanes=lanes, n=n, m=m, jit_chunk=params.jit_chunk,
        setup_s=t_start - t_process,
        window_s=times[-1][1] - t_start,
        solves=int((status == optimal).sum()),
        solve_ms=[1e3 * (t1 - t0) if (a[0] == optimal).all() else float("inf") for (t0, t1), a in zip(times, answers)],
        stretch=stretch,
    )
    if stretch is not None:
        stretch.solves = sum(a[0].size for a in answers[stretch.calls])
        stretch.iterations = int(sum(a[1].sum() for a in answers[stretch.calls]))

    metrics = {}
    for metric in (manifest.per_layer(name) if trace else manifest.end_to_end(name)):
        value = manifest.metric_reader(metric["name"]).read(ctx)
        if value is not None:
            metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}

    result = {
        "correct": verdict.correct,
        "attempted": int(status.size),
        "failed": verdict.failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(torch.device(device)) if on_card else "cpu",
            "count": spec["chips"],
            "memory_peak_bytes": int(peak),
        },
    }
    if stretch is not None:
        result["device"]["busy_s"] = stretch.trace.busy_s
        result["device"]["window_s"] = stretch.trace.window_s
        result["breakdown"] = {"device_ops": stretch.trace.device_ops(), "idle_gaps": stretch.trace.idle_gaps()}
    result["notes"] = {
        "calls": len(times),
        "iterations_mean": float(iterations.mean()),
        "captures_in_window": captures_in_window,
        "kkt_gap_max": verdict.gap,
        "setup_parts_s": {"imports": t_built - t_process, "solver": t_warm - t_built, "warm": t_settle - t_warm,
                          "settle": t_start - t_settle},
    }
    if stretch is not None:
        result["notes"]["trace_events"] = dict(stretch.trace.kinds)
    lines = list(verdict.lines)
    if ctx.kind == "single":
        deciles = [percentile(ctx.solve_ms, q) for q in range(10, 101, 10)]
        result["notes"]["solve_ms_deciles"] = deciles
        lines.insert(0, f"solve ms: median {percentile(ctx.solve_ms, 50)!r}, p90 {deciles[8]!r} over {len(ctx.solve_ms)} solves")
    result["checks"] = verdict.checks
    return result, lines
