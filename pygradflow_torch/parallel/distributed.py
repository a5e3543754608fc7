"""Multi-process sweeps on ``torch.distributed`` (counterpart of
``pygradflow_tpu/parallel/distributed.py``).

One process per card (or several processes sharing a card, or CPU
processes) run the same program; each solves its contiguous rows of the
instance batch on its local mesh, and the only traffic between processes
is the continuation vote between chunks and the gather of the results::

    from pygradflow_torch.parallel import DistributedSolver, init_distributed

    init_distributed()                  # torchrun's MASTER_ADDR/WORLD_SIZE/RANK
    solver = DistributedSolver(problem, params)
    result = solver.solve(x0_global)    # every process passes the FULL batch

``init_distributed`` picks NCCL when each process has a card of its own,
and gloo on the CPU or when processes share a card (NCCL refuses two
ranks on one device).  Without a coordinator it does nothing but report
the topology of the single process.
"""

import math
import os
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..params import Params
from ..problem import Problem
from ..timer import Timer
from .batch import BatchResult, _time_out
from .shard import ShardedSolver

_LOCAL_IDS = None  # CUDA indices of this process's mesh, set by init_distributed


class DistributedInfo(NamedTuple):
    process_id: int
    num_processes: int
    local_devices: int
    global_devices: int


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def _comm_device():
    """Where the collectives' tensors live: the CPU under gloo, this
    process's card under NCCL."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def local_mesh() -> list:
    """This process's devices: those given to ``init_distributed`` as
    ``local_device_ids``, else the current CUDA device.  Raises, as the
    entry points do, without a card (CPU use passes ``mesh=["cpu"]``)."""
    from ..solver import _resolve_device

    if _LOCAL_IDS is not None:
        return [torch.device("cuda", i) for i in _LOCAL_IDS]
    return [_resolve_device(None)]


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
) -> DistributedInfo:
    """Join the process group and report the global topology.

    ``coordinator_address`` (``host:port``) with ``num_processes`` and
    ``process_id`` starts the group explicitly; without it, torchrun's
    ``MASTER_ADDR``, ``WORLD_SIZE`` and ``RANK`` do.  ``LOCAL_RANK`` and
    ``LOCAL_WORLD_SIZE``, where set, say which card is this process's and
    how many processes share the host (otherwise all of them, ranked by
    ``process_id``).  Already initialized, or with neither, it only
    reports."""
    global _LOCAL_IDS
    env = os.environ
    explicit = coordinator_address is not None
    env_driven = all(k in env for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK"))
    if not _initialized() and (explicit or env_driven):
        if explicit:
            if num_processes is None or process_id is None:
                raise ValueError("a coordinator_address needs num_processes and process_id")
            init_method = f"tcp://{coordinator_address}"
            world, rank = int(num_processes), int(process_id)
        else:
            init_method = "env://"
            world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
        local_world = int(env.get("LOCAL_WORLD_SIZE", world))
        local_rank = int(env.get("LOCAL_RANK", rank))
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        backend = "nccl" if 0 < local_world <= cards else "gloo"
        if local_device_ids is not None:
            _LOCAL_IDS = [int(i) for i in local_device_ids]
        elif cards:
            _LOCAL_IDS = [local_rank % cards]
        if _LOCAL_IDS:
            torch.cuda.set_device(_LOCAL_IDS[0])
        dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)

    local = 1 if _LOCAL_IDS is None else len(_LOCAL_IDS)
    if not _initialized():
        return DistributedInfo(process_id=0, num_processes=1, local_devices=local, global_devices=local)
    total = torch.tensor([local], dtype=torch.int64, device=_comm_device())
    dist.all_reduce(total)
    return DistributedInfo(
        process_id=dist.get_rank(),
        num_processes=dist.get_world_size(),
        local_devices=local,
        global_devices=int(total),
    )


def host_batch_slice(batch_size: int, process_id: Optional[int] = None, num_processes: Optional[int] = None) -> slice:
    """The contiguous rows of a global instance batch owned by one process:
    ``batch_size / num_processes`` rows in rank order."""
    pid = (dist.get_rank() if _initialized() else 0) if process_id is None else process_id
    np_ = (dist.get_world_size() if _initialized() else 1) if num_processes is None else num_processes
    if batch_size % np_ != 0:
        raise ValueError(
            f"batch size {batch_size} must be divisible by the process count {np_} (pad the batch)"
        )
    per = batch_size // np_
    return slice(pid * per, (pid + 1) * per)


class DistributedSolver(ShardedSolver):
    """``ShardedSolver`` over the processes of a ``torch.distributed`` group.

    Every process calls :meth:`solve` with the same full batch; each solves
    its rows (``host_batch_slice``) on its local mesh (default
    ``local_mesh()``).  Between chunks an all-reduce of the running-lane
    count is the continuation vote; under a finite ``time_limit`` rank 0's
    timeout verdict is broadcast, so that clock skew between processes
    cannot leave one of them waiting in a collective.  At the end the rows
    are all-gathered in rank order and every process returns the complete
    ``BatchResult``.  Without a process group it is ``ShardedSolver``; in a
    group of one process it takes the collective path, with the same
    result.
    """

    def __init__(self, problem: Problem, params: Optional[Params] = None, mesh: Optional[Sequence] = None):
        super().__init__(problem, params, mesh=local_mesh() if mesh is None else mesh)

    def solve(self, x0, y0=None, data=None) -> BatchResult:
        if not _initialized():
            return super().solve(x0, y0, data=data)
        return self._solve_multiprocess(x0, y0, data)

    def _solve_multiprocess(self, x0, y0, data) -> BatchResult:
        world = dist.get_world_size()
        comm = _comm_device()
        batch = np.shape(x0)[0]
        parts = self.num_devices * world
        if batch % parts != 0:
            raise ValueError(
                f"batch size {batch} must be divisible by the global device count {parts} (pad the batch)"
            )
        states = self._init_shards(x0, y0, data, rows=host_batch_slice(batch))

        timer = Timer(self.params.time_limit)
        has_time_limit = math.isfinite(self.params.time_limit)
        while True:
            states = self._chunk(states)
            running = torch.tensor([self._local_running(states)], dtype=torch.int64, device=comm)
            dist.all_reduce(running)
            if int(running) == 0:
                break
            timed_out = timer.reached_time_limit()
            if has_time_limit:
                verdict = torch.tensor([int(timed_out)], dtype=torch.int64, device=comm)
                dist.broadcast(verdict, src=0)
                timed_out = bool(verdict)
            if timed_out:
                states = [_time_out(s) for s in states]
                break

        return _all_gather_tree(self._finalize(states), world, comm, self.mesh[0])


def _all_gather_tree(tree, world, comm, device):
    """Every rank's ``tree`` of tensors, joined along the lane axis in rank
    order on ``device``."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        vals = [_all_gather_tree(leaf, world, comm, device) for leaf in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    local = tree.to(comm).contiguous()
    parts = [torch.empty_like(local) for _ in range(world)]
    dist.all_gather(parts, local)
    return torch.cat(parts).to(device)
