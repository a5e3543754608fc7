"""Checkpoint and resume of the homotopy state (counterpart of
``pygradflow_tpu/checkpoint.py``).

The loop state is small (iterate, lambda, rho, PI sum, penalty state,
counters), so a checkpoint is one ``.npz`` snapshot, written at the chunk
boundaries of ``SolveLoop.run_chunks``; a solve resumed from it goes on bit
for bit as the uninterrupted one.

The format is the JAX package's, so that a snapshot of either package
resumes in this one: each leaf is keyed by its field path in the JAX
package's ``LoopState`` (``leaf.it.x``, ``leaf.lamb``, ``leaf.pstate.rho``,
``leaf.path[0]``, ...), beside ``__format_version__`` 2.  This module keeps
its own copy of that layout (``_leaves``): the port's ``rcond`` is the JAX
package's ``last_rcond``, and its ``eval_fail`` tuple the JAX package's
``(flag, first_x, first_y, cand_x, cand_y)`` under ``validate_input``.  A
snapshot whose keys do not match the state's (``validate_input`` or
``collect_path`` toggled, another penalty strategy) fails with an
"incompatible checkpoint" error.  Snapshots from before the format was
versioned (positional ``leaf_{i}`` keys) load when the leaf count matches.
"""

import os

import numpy as np

from .convert import tensor_like
from .eval import Counters
from .iterate import Iterate

FORMAT_VERSION = 2


def _leaves(state) -> dict:
    """The state's tensors by their key, in the JAX package's flattening
    order."""
    out = {f"leaf.it.{k}": v for k, v in state.it._asdict().items()}
    out.update({"leaf.lamb": state.lamb, "leaf.rho": state.rho, "leaf.error_sum": state.error_sum})
    if state.pstate != ():
        out.update({f"leaf.pstate.{k}": v for k, v in state.pstate._asdict().items()})
    for k in ("iteration", "accepted_steps", "num_penalty_changes", "path_dist", "status"):
        out[f"leaf.{k}"] = getattr(state, k)
    out.update({f"leaf.counters.{k}": v for k, v in state.counters._asdict().items()})
    out.update({f"leaf.path[{i}]": v for i, v in enumerate(state.path)})
    out["leaf.last_rcond"] = state.rcond
    out.update({f"leaf.eval_fail[{i}]": v for i, v in enumerate(state.eval_fail)})
    return out


def _host(value):
    """A leaf as the numpy array the snapshot holds, counts as int32, as the
    JAX package writes them."""
    value = value.detach().cpu().numpy()
    return value.astype(np.int32) if value.dtype == np.int64 else value


def save_state(path: str, state) -> None:
    """Write a ``solver.LoopState`` to ``path`` (.npz), atomically."""
    arrays = {k: _host(v) for k, v in _leaves(state).items()}
    arrays["__format_version__"] = np.asarray(FORMAT_VERSION)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:  # a file handle: savez must not append ".npz"
        np.savez(f, **arrays)
    os.replace(tmp, path)




def load_state(path: str, example_state):
    """The ``solver.LoopState`` that :func:`save_state` (or the JAX
    package's) wrote to ``path``; ``example_state`` (``SolveLoop.init_state``)
    gives its structure, dtype and device.  Raises ``ValueError`` when the
    snapshot's keys do not match that structure."""
    example = _leaves(example_state)
    keys = list(example)

    with np.load(path) as data:
        saved_keys = set(data.files) - {"__format_version__"}
        if "__format_version__" not in data.files:
            # the positional format: only safe when the count matches
            if saved_keys != {f"leaf_{i}" for i in range(len(keys))}:
                raise ValueError(
                    f"incompatible checkpoint '{path}': legacy positional format with "
                    f"{len(saved_keys)} leaves, current state has {len(keys)}"
                )
            restored = {k: data[f"leaf_{i}"] for i, k in enumerate(keys)}
        else:
            missing = [k for k in keys if k not in saved_keys]
            extra = sorted(saved_keys - set(keys))
            if missing or extra:
                raise ValueError(
                    f"incompatible checkpoint '{path}': leaf keys do not match the current "
                    f"LoopState structure (missing {missing or 'none'}, unexpected "
                    f"{extra or 'none'}; was validate_input toggled, or the checkpoint "
                    f"written by a different version?)"
                )
            restored = {k: data[k] for k in keys}

    leaf = {k: tensor_like(restored[k], example[k]) for k in keys}

    def group(prefix):
        return {k[len(prefix):]: v for k, v in leaf.items() if k.startswith(prefix)}

    def seq(prefix):
        return tuple(v for k, v in leaf.items() if k.startswith(prefix + "["))

    pstate = example_state.pstate
    if pstate != ():
        pstate = type(pstate)(**group("leaf.pstate."))
    return example_state._replace(
        it=Iterate(**group("leaf.it.")),
        lamb=leaf["leaf.lamb"],
        rho=leaf["leaf.rho"],
        error_sum=leaf["leaf.error_sum"],
        pstate=pstate,
        iteration=leaf["leaf.iteration"],
        accepted_steps=leaf["leaf.accepted_steps"],
        num_penalty_changes=leaf["leaf.num_penalty_changes"],
        path_dist=leaf["leaf.path_dist"],
        status=leaf["leaf.status"],
        counters=Counters(**group("leaf.counters.")),
        path=seq("leaf.path"),
        rcond=leaf["leaf.last_rcond"],
        eval_fail=seq("leaf.eval_fail"),
    )


class CheckpointManager:
    """The checkpoints of ``Solver.solve``: a snapshot every ``every``
    chunk boundaries; ``restore`` reads the resume point."""

    def __init__(self, path: str, every: int = 1):
        self.path = path
        self.every = max(1, int(every))
        self._count = 0

    def maybe_save(self, state) -> bool:
        self._count += 1
        if self._count % self.every != 0:
            return False
        save_state(self.path, state)
        return True

    def exists(self) -> bool:
        return os.path.exists(self.path)

    def restore(self, example_state):
        return load_state(self.path, example_state)
