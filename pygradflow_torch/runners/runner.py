"""Benchmark runner harness (counterpart of ``pygradflow_tpu/runners/runner.py``).

Emits the JAX package's CSV schema (the same columns in the same order),
a ``params.yml`` and per-instance logs, in two execution modes:

- **sequential** (default): one solve per instance in this process,
  guarded by a SIGALRM watchdog, so that a hang becomes a ``timeout`` CSV
  row instead of blocking the sweep;
- **parallel** (``--parallel N``): each instance solved in a fresh
  subprocess with a hard ``terminate`` kill at the time limit, with up to
  N instances in flight; the subprocesses fork from a server that has
  imported torch and the port once (``_child_context``).

Every solve runs on ``--device`` (default ``cuda``), the children of
``--parallel`` too: several CUDA processes share one card.  Without a card
and without ``--device cpu`` the runner exits non-zero before it writes a
row.  Batches of same-structure instances go through
``pygradflow_torch.parallel`` instead (``BatchedSolver``/``ShardedSolver``).
"""

import csv
import datetime
import enum
import logging
import math
import multiprocessing
import os
import signal
from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Any, Optional

from ..log import logger
from ..params import Params
from ..status import SolverStatus

run_logger = logging.getLogger(__name__)

LOG_FORMAT = logging.Formatter("%(asctime)s:%(name)s:%(levelname)s:%(message)s")

# CSV schema — must stay identical to the reference output
FIELDNAMES = [
    "instance",
    "num_vars",
    "num_cons",
    "size",
    "status",
    "total_time",
    "iterations",
    "num_accepted_steps",
    "final_scaled_obj",
    "final_stat_res",
    "final_cons_violation",
    "dist_factor",
]

# SolverResult attributes copied verbatim into the row for a completed solve
_RESULT_FIELDS = (
    "iterations",
    "num_accepted_steps",
    "final_scaled_obj",
    "final_stat_res",
    "final_cons_violation",
    "dist_factor",
)


@dataclass
class Outcome:
    """What happened to one instance: ``kind`` is "solved", "error" or
    "timeout"; ``result`` is the SolverResult when solved."""

    kind: str
    result: Any = None
    elapsed: float = 0.0

    def row(self, instance) -> dict:
        row = dict.fromkeys(FIELDNAMES, 0)
        row.update(
            instance=instance.name,
            num_vars=instance.num_vars,
            num_cons=instance.num_cons,
            size=instance.size,
        )
        for key in ("final_scaled_obj", "final_stat_res", "final_cons_violation", "dist_factor"):
            row[key] = 0.0
        if self.kind == "solved":
            row["status"] = SolverStatus.short_name(self.result.status)
            row["total_time"] = self.result.total_time
            for key in _RESULT_FIELDS:
                row[key] = getattr(self.result, key)
        else:
            row["status"] = self.kind
            row["total_time"] = self.elapsed
        return row


class InstanceTimeout(Exception):
    """Raised by the SIGALRM watchdog when an instance overruns."""


class _Watchdog:
    """SIGALRM-based hard limit around one instance solve (main thread,
    POSIX).  Weaker than a subprocess kill — a wedged C call only gets
    interrupted once the interpreter runs again — but costs nothing and
    keeps the in-process compile cache warm."""

    def __init__(self, seconds: Optional[float]):
        self.seconds = seconds
        self._prev = None

    def __enter__(self):
        if not self._armed():
            return self

        def fire(signum, frame):
            raise InstanceTimeout()

        self._prev = signal.signal(signal.SIGALRM, fire)
        signal.setitimer(signal.ITIMER_REAL, self.seconds)
        return self

    def __exit__(self, *exc):
        if self._armed():
            signal.setitimer(signal.ITIMER_REAL, 0.0)
            signal.signal(signal.SIGALRM, self._prev)
        return False

    def _armed(self):
        return (
            self.seconds is not None
            and math.isfinite(self.seconds)
            and hasattr(signal, "SIGALRM")
        )


def _check_device(device):
    """Exit non-zero unless ``device`` can be used here."""
    import torch

    kind = torch.device(device).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"runner: --device {device} but no CUDA device is available; "
            "pass --device cpu to solve on the CPU"
        )


def _route_instance_log(log_path, verbose: bool):
    """Point the solver logger at the per-instance logfile (and stderr when
    verbose)."""
    logger.handlers.clear()
    logger.setLevel(logging.INFO)
    for handler in (
        [logging.FileHandler(log_path)] if log_path else []
    ) + ([logging.StreamHandler()] if verbose else []):
        handler.setFormatter(LOG_FORMAT)
        logger.addHandler(handler)


def _child_context():
    """Children of ``--parallel`` start from a fork server that has imported
    torch and the port once (``import torch`` alone takes seconds), so that
    a child does not pay the imports; each child is still a fresh process
    of its own, that initializes its device itself and is killed hard at
    the time limit."""
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(["torch", "pygradflow_torch.runners.runner"])
    return ctx


def _spawned_solve(runner_cls, argv, index, conn):
    """Entry point of a spawned per-instance worker: re-derive the instance
    list from the CLI args (instances need not be picklable), solve one on
    the runner's device, ship the CSV payload back through the pipe."""
    runner = runner_cls()
    args = runner.parser().parse_args(argv)
    instance = runner.select_instances(args)[index]
    params = runner.create_params(args)
    _route_instance_log(runner.instance_log_path(args, instance), args.verbose)
    # interpreter + library startup is not the instance's time: the parent
    # starts its kill clock on this marker
    conn.send(("started", None))
    try:
        import numpy as np

        with np.errstate(divide="raise", over="raise", invalid="raise"):
            result = instance.solve(params, args.device, debug_nans=args.debug_nans)
        payload = Outcome("solved", result).row(instance)
    except Exception as exc:  # noqa: BLE001 — any failure = error row
        logger.error("Error solving %s", instance.name, exc_info=exc)
        payload = Outcome("error").row(instance)
    conn.send(("row", payload))
    conn.close()


class Runner(ABC):
    """Base class for benchmark sweeps; subclasses provide a name and
    ``get_instances``."""

    # absolute deadline for a --parallel child to reach its 'started'
    # marker (interpreter, imports, instance setup)
    STARTUP_TIMEOUT = 600.0

    def __init__(self, name):
        self.name = name

    @abstractmethod
    def get_instances(self, args):
        raise NotImplementedError()

    # -- configuration ---------------------------------------------------

    def create_params(self, args) -> Params:
        """Params assembled from whatever CLI flags match its fields
        (enums arrive as their member names)."""
        params = Params()
        for key, attr in params.annotations():
            if not hasattr(args, key):
                continue
            value = getattr(args, key)
            if isinstance(attr, enum.EnumMeta) and isinstance(value, str):
                value = attr[value]
            setattr(params, key, value)
        return params

    def parser(self):
        import argparse

        parser = argparse.ArgumentParser(description=f"{self.name} benchmark sweep")

        params_group = parser.add_argument_group(title="parameters")
        defaults = Params()
        for key, attr in defaults.annotations():
            if isinstance(attr, enum.EnumMeta):
                params_group.add_argument(
                    f"--{key}",
                    default=getattr(defaults, key).name,
                    type=str,
                    help="Default: %(default)s",
                )
                continue
            if isinstance(attr, type) and attr in (int, float, bool, str):
                params_group.add_argument(
                    f"--{key}",
                    default=getattr(defaults, key),
                    type=attr,
                    help="Default: %(default)s",
                )

        sweep = parser.add_argument_group(title="runner")
        sweep.add_argument("--output", type=str)
        sweep.add_argument("--no_output", action="store_true")
        sweep.add_argument("--max_size", type=int)
        sweep.add_argument("--name", type=str)
        sweep.add_argument("--unconstrained", action="store_true")
        sweep.add_argument("--verbose", action="store_true")
        sweep.add_argument(
            "--parallel",
            type=int,
            default=0,
            metavar="N",
            help="solve up to N instances concurrently, each in an "
            "isolated subprocess on --device with a hard kill at the time "
            "limit (0 = sequential in-process)",
        )
        sweep.add_argument(
            "--device",
            type=str,
            default="cuda",
            help="device of every solve (default: %(default)s; 'cpu' solves "
            "on the CPU)",
        )
        sweep.add_argument(
            "--debug_nans",
            action="store_true",
            help="raise at the first evaluation of the problem that returns "
            "a NaN or an infinity (debugging only: the solver's failure "
            "recovery normally turns such values into rejected steps)",
        )
        return parser

    def select_instances(self, args):
        """Instances surviving the CLI filters, in definition order."""

        def keep(instance):
            if args.max_size is not None and instance.size > args.max_size:
                return False
            if args.unconstrained and instance.num_cons > 0:
                return False
            return args.name is None or args.name == instance.name

        return [inst for inst in self.get_instances(args) if keep(inst)]

    # -- output ----------------------------------------------------------

    def output_path(self, args, filename):
        return os.path.join(args.output, filename)

    def instance_log_path(self, args, instance):
        if args.no_output:
            return None
        return self.output_path(args, f"{instance.name}.log")

    # -- execution -------------------------------------------------------

    def _solve_in_process(self, instance, params, args):
        """Sequential-mode solve of one instance under the SIGALRM
        watchdog and the numeric sanitizer."""
        import numpy as np

        _route_instance_log(self.instance_log_path(args, instance), args.verbose)
        limit = getattr(params, "time_limit", None)
        try:
            # host-side FP anomalies (instance setup, host callbacks such as
            # CUTEst's) become exceptions per instance, the analog of the
            # reference's np.seterr.  Non-finite values on the device stay
            # non-raising (they feed the solver's reject-and-double-lambda
            # recovery) unless --debug_nans asks otherwise.
            with _Watchdog(limit), np.errstate(
                divide="raise", over="raise", invalid="raise"
            ):
                return Outcome("solved", instance.solve(params, args.device, debug_nans=args.debug_nans))
        except InstanceTimeout:
            logger.error("Instance %s hit the %gs watchdog", instance.name, limit)
            return Outcome("timeout", elapsed=limit)
        except Exception as exc:  # noqa: BLE001 — any failure = error row
            logger.error("Error solving %s", instance.name, exc_info=exc)
            return Outcome("error")

    def _rows_sequential(self, instances, args, argv):
        params = self.create_params(args)
        limit = getattr(params, "time_limit", None)
        if limit is not None and math.isfinite(limit):
            # the SIGALRM watchdog only fires between Python bytecodes: a
            # call wedged in C (a device synchronization) is never
            # interrupted.  --parallel N is the real watchdog (hard
            # subprocess kill); surface that instead of timing out silently
            logger.warning(
                "sequential mode cannot interrupt a wedged device dispatch "
                "(SIGALRM fires between Python bytecodes only); with "
                "time_limit=%gs prefer --parallel 1 for a hard kill",
                limit,
            )
        for instance in instances:
            outcome = self._solve_in_process(instance, params, args)
            yield instance, outcome.row(instance)

    def _rows_parallel(self, instances, args, argv):
        """Spawned per-instance workers, ``args.parallel`` in flight, hard
        kill at the time limit."""
        ctx = _child_context()
        params = self.create_params(args)
        limit = getattr(params, "time_limit", None)
        if limit is not None and not math.isfinite(limit):
            limit = None

        pending = list(enumerate(instances))
        # index -> [process, parent_conn, solve-start time or None, spawn time]
        live = {}
        import time as _time

        while pending or live:
            while pending and len(live) < max(1, args.parallel):
                index, instance = pending.pop(0)
                parent_conn, child_conn = ctx.Pipe(duplex=False)
                proc = ctx.Process(
                    target=_spawned_solve,
                    args=(type(self), argv, index, child_conn),
                )
                proc.start()
                child_conn.close()
                live[index] = [proc, parent_conn, None, _time.monotonic()]

            _time.sleep(0.05)
            for index in list(live):
                proc, conn, started, spawned = live[index]
                instance = instances[index]
                if conn.poll():
                    tag, payload = conn.recv()
                    if tag == "started":
                        # startup (interpreter + imports) excluded from the
                        # instance's time budget
                        live[index][2] = _time.monotonic()
                        continue
                    proc.join()
                    del live[index]
                    yield instance, payload
                elif not proc.is_alive():
                    del live[index]
                    yield instance, Outcome("error").row(instance)
                elif (
                    limit is not None
                    and started is not None
                    and _time.monotonic() - started > limit
                ):
                    proc.terminate()
                    proc.join()
                    del live[index]
                    run_logger.warning(
                        "Killed %s after %gs", instance.name, limit
                    )
                    yield instance, Outcome("timeout", elapsed=limit).row(instance)
                elif (
                    started is None
                    and _time.monotonic() - spawned > self.STARTUP_TIMEOUT
                ):
                    # a child that wedges BEFORE the 'started' marker
                    # (import/compile hang) never enters the time-limit
                    # clock above; without this absolute startup deadline
                    # the sweep would block forever on it
                    proc.terminate()
                    proc.join()
                    del live[index]
                    run_logger.warning(
                        "Killed %s: no startup within %gs",
                        instance.name,
                        self.STARTUP_TIMEOUT,
                    )
                    yield instance, Outcome("error").row(instance)

    # -- entry point -----------------------------------------------------

    def main(self, argv=None):
        import sys

        run_logger.setLevel(logging.INFO)
        stream = logging.StreamHandler()
        stream.setFormatter(LOG_FORMAT)
        run_logger.addHandler(stream)

        argv = list(sys.argv[1:]) if argv is None else list(argv)
        args = self.parser().parse_args(argv)

        # the device is checked before any row: no sweep falls back to the
        # CPU unless it was asked for
        _check_device(args.device)

        if not args.no_output and args.output is None:
            stamp = datetime.datetime.now().isoformat("T", "seconds")
            args.output = f"output_{self.name}_{stamp}"
            # children re-parse argv: hand them the resolved directory
            argv += ["--output", args.output]
        if not args.no_output:
            os.makedirs(args.output, exist_ok=True)

        instances = self.select_instances(args)
        run_logger.info(
            "Sweep over %d instances (%s)",
            len(instances),
            f"parallel x{args.parallel}" if args.parallel else "sequential",
        )

        produce = self._rows_parallel if args.parallel else self._rows_sequential
        rows = produce(instances, args, argv)

        if args.no_output:
            for instance, _ in rows:
                run_logger.info("Done: %s", instance.name)
            return

        self.create_params(args).write(self.output_path(args, "params.yml"))
        csv_path = self.output_path(args, "output.csv")
        run_logger.info("Results stream to '%s'", csv_path)
        with open(csv_path, "w") as csv_file:
            writer = csv.DictWriter(csv_file, fieldnames=FIELDNAMES)
            writer.writeheader()
            for instance, row in rows:
                run_logger.info("Done: %s", instance.name)
                writer.writerow(row)
                csv_file.flush()
