"""The port's ``torch.distributed`` frontend on the CPU: ``init_distributed``
without a coordinator, ``host_batch_slice`` (``tests/test_distributed.py:26-39``),
and a two-process gloo sweep whose ranks must both return the full batch of
``BatchedSolver`` bit for bit, then stop together on a skewed-clock
``TimeLimit`` (``tests/distributed_worker.py``'s second part).

The processes are spawned from this file (``_worker``) on a free TCP port,
each with its own timeout.
"""

import multiprocessing
import os
import socket
import sys
import time

import numpy as np
import pytest
import torch

from pygradflow_torch import Params, SolverStatus
from pygradflow_torch.parallel import (
    BatchedSolver,
    DistributedSolver,
    ShardedSolver,
    host_batch_slice,
    init_distributed,
)

from .torch_parity import Rosenbrock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT = 120.0


def _starts():
    """``tests/distributed_worker.py``'s global batch."""
    return np.stack([np.array([0.1 * i - 0.4, 0.05 * i]) for i in range(8)], axis=0)


def _worker(rank, port, out_path):
    sys.path.insert(0, ROOT)
    torch.set_num_threads(1)
    from tests.torch_parity import Rosenbrock as Rb

    info = init_distributed(coordinator_address=f"localhost:{port}", num_processes=2, process_id=rank)
    assert info.num_processes == 2 and info.process_id == rank, info
    assert host_batch_slice(8) == slice(rank * 4, rank * 4 + 4)

    # every process passes the full batch; each solves its rows on two
    # simulated devices
    result = DistributedSolver(Rb(), Params(), mesh=["cpu"] * 2).solve(_starts())

    # rank 1 starts its clock 3.5 s late: only rank 0 sees the 2 s limit
    # pass, and its broadcast verdict must stop rank 1 too
    params = Params(jit_chunk=4, opt_tol=0.0, iteration_limit=100000, time_limit=2.0)
    if rank == 1:
        time.sleep(3.5)
    limited = DistributedSolver(Rb(), params, mesh=["cpu"]).solve(_starts())
    np.savez(
        out_path,
        **{f: getattr(result, f).numpy() for f in ("x", "y", "d", "status", "iterations", "accepted_steps")},
        counters=np.stack([c.numpy() for c in result.counters]),
        status_timelimit=limited.status.numpy(),
        global_devices=info.global_devices,
    )


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_init_distributed_single_process_noop():
    info = init_distributed()
    assert info.num_processes == 1
    assert info.process_id == 0
    assert info.local_devices == info.global_devices
    assert not torch.distributed.is_initialized()


def test_host_batch_slice():
    assert host_batch_slice(12, process_id=0, num_processes=3) == slice(0, 4)
    assert host_batch_slice(12, process_id=2, num_processes=3) == slice(8, 12)
    assert host_batch_slice(12) == slice(0, 12)
    with pytest.raises(ValueError, match="divisible"):
        host_batch_slice(10, process_id=0, num_processes=3)


def test_without_a_group_it_is_the_sharded_solver():
    x0s = _starts()
    ours = DistributedSolver(Rosenbrock(), Params(), mesh=["cpu"] * 2).solve(x0s)
    ref = ShardedSolver(Rosenbrock(), Params(), mesh=["cpu"] * 2).solve(x0s)
    assert torch.equal(ours.x, ref.x) and torch.equal(ours.iterations, ref.iterations)


def test_two_process_gloo_sweep(tmp_path):
    """2 processes x 2 simulated devices: both ranks return the same full
    batch, bit for bit the single-process ``BatchedSolver``'s, and both stop
    on TimeLimit."""
    port = _free_port()
    ctx = multiprocessing.get_context("spawn")
    outs = [str(tmp_path / f"rank{r}.npz") for r in range(2)]
    procs = [ctx.Process(target=_worker, args=(r, port, outs[r])) for r in range(2)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(WORKER_TIMEOUT)
            assert p.exitcode == 0, f"worker exit code {p.exitcode}"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()

    r0, r1 = (np.load(o) for o in outs)
    for key in r0.files:
        np.testing.assert_array_equal(r0[key], r1[key], err_msg=key)
    assert int(r0["global_devices"]) == 2
    assert (r0["status_timelimit"] == int(SolverStatus.TimeLimit)).all()

    ref = BatchedSolver(Rosenbrock(), Params(), device="cpu").solve(_starts())
    assert (r0["status"] == int(SolverStatus.Optimal)).all()
    for field in ("x", "y", "d", "status", "iterations", "accepted_steps"):
        np.testing.assert_array_equal(r0[field], getattr(ref, field).numpy(), err_msg=field)
    np.testing.assert_array_equal(r0["counters"], np.stack([c.numpy() for c in ref.counters]))
