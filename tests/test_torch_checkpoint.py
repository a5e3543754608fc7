"""Checkpoint and resume in the port (``pygradflow_torch/checkpoint.py``).

The three cases of ``tests/test_checkpoint.py``: an interrupted solve
resumed from its snapshot goes on bit for bit; a snapshot of another state
structure raises; a snapshot in the positional format loads.  Then the
carry across packages: a snapshot that the JAX package writes resumes in
the port to the JAX package's uninterrupted count and point.
"""

import numpy as np
import pytest
import torch

import pygradflow_tpu
from pygradflow_torch import Params, Solver, SolverStatus
from pygradflow_torch.checkpoint import FORMAT_VERSION, load_state, save_state

from . import problems as jprob
from . import torch_parity as tprob
from .torch_parity import numpy, params_pair


def _rosenbrock():
    inst = jprob.rosenbrock_instance()
    return tprob.Rosenbrock(), np.asarray(inst.x_0), np.asarray(inst.y_0)


def _solve(params, **kwargs):
    problem, x0, y0 = _rosenbrock()
    return Solver(problem, params, device="cpu").solve(x0, y0, **kwargs)


def test_checkpoint_resume(tmp_path):
    path = str(tmp_path / "state.npz")
    full = _solve(Params())
    assert full.success

    # interrupted: small chunks and an iteration limit stop it midway
    ra = _solve(Params(jit_chunk=4, iteration_limit=12), checkpoint_path=path)
    assert ra.status == SolverStatus.IterationLimit

    rb = _solve(Params(jit_chunk=4), checkpoint_path=path, resume=True)
    assert rb.success
    assert torch.equal(rb.x, full.x) and torch.equal(rb.y, full.y)
    assert (rb.iterations, rb.num_accepted_steps) == (full.iterations, full.num_accepted_steps)
    assert rb.num_evals == full.num_evals
    assert rb.dist_factor == full.dist_factor


def test_checkpoint_structure_mismatch_raises(tmp_path):
    """Toggling validate_input between save and restore changes the
    state's leaves; the restore fails loudly instead of shifting them."""
    path = str(tmp_path / "state.npz")
    _solve(Params(jit_chunk=4, iteration_limit=8, validate_input=True), checkpoint_path=path)
    with pytest.raises(ValueError, match="incompatible checkpoint"):
        _solve(Params(jit_chunk=4, validate_input=False), checkpoint_path=path, resume=True)


def test_checkpoint_legacy_positional_load(tmp_path):
    """A snapshot with positional ``leaf_{i}`` keys restores when the leaf
    count matches the current structure."""
    path = str(tmp_path / "state.npz")
    _solve(Params(jit_chunk=4, iteration_limit=8), checkpoint_path=path)

    with np.load(path) as data:
        keys = [k for k in data.files if k != "__format_version__"]
        legacy = {f"leaf_{i}": data[k] for i, k in enumerate(keys)}
    np.savez(path, **legacy)

    resumed = _solve(Params(jit_chunk=4), checkpoint_path=path, resume=True)
    assert resumed.success
    assert resumed.iterations == _solve(Params()).iterations


def test_port_snapshot_has_the_jax_layout(tmp_path):
    """The port writes the JAX package's keys, dtypes and shapes; the state
    read back equals the state written."""
    path = str(tmp_path / "state.npz")
    kwargs = dict(penalty_update="LagrangianFilter", collect_path=True, path_capacity=16)
    jp, tp = params_pair(**kwargs)
    inst = jprob.hs71_instance()
    jsolver = pygradflow_tpu.Solver(inst.problem, jp)
    jx, jy = jsolver.transform.create_transformed_initial(inst.x_0, inst.y_0)
    jpath = str(tmp_path / "jax.npz")
    from pygradflow_tpu.checkpoint import save_state as jsave_state

    jsave_state(jpath, jsolver._loop.init_state(jx, jy))

    solver = Solver(tprob.HS71(), tp, device="cpu")
    x, y = solver.transform.create_transformed_initial(inst.x_0, inst.y_0, solver.device)
    state = solver._loop.init_state(x, y)
    save_state(path, state)
    with np.load(path) as ours, np.load(jpath) as theirs:
        assert ours.files == theirs.files
        assert int(ours["__format_version__"]) == FORMAT_VERSION
        for k in ours.files:
            assert ours[k].shape == theirs[k].shape, k
            if k != "leaf.pstate.cursor":  # int64 in the port, as torch indexes
                assert ours[k].dtype == theirs[k].dtype, k
            np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-15, atol=0, err_msg=k)
    back = load_state(path, state)
    for a, b in zip(
        (back.it, back.pstate, back.path[:2], back.eval_fail[1:]),
        (state.it, state.pstate, state.path[:2], state.eval_fail[1:]),
    ):
        for u, v in zip(a, b):
            assert torch.equal(u, v)
    assert back._replace(it=None, pstate=None, path=None, eval_fail=None, rcond=0.0) == state._replace(
        it=None, pstate=None, path=None, eval_fail=None, rcond=0.0
    )


@pytest.mark.parametrize("precision", ["Double", "Single"])
def test_jax_snapshot_resumes_in_the_port(tmp_path, precision):
    """The JAX package stops at iteration 12 and writes its snapshot; the
    port resumes from it to JAX's uninterrupted count, x to 1e-12 (f64) or
    to f32 rounding."""
    inst = jprob.rosenbrock_instance()
    path = str(tmp_path / "jax.npz")
    extra = {} if precision == "Double" else dict(opt_tol=1e-4, lamb_min=1e-6)
    jp_a, _ = params_pair(precision=precision, jit_chunk=4, iteration_limit=12, **extra)
    ra = pygradflow_tpu.Solver(inst.problem, jp_a).solve(inst.x_0, inst.y_0, checkpoint_path=path)
    assert ra.status.name == "IterationLimit" and ra.iterations == 12

    jp, tp = params_pair(precision=precision, jit_chunk=4, **extra)
    full = pygradflow_tpu.Solver(inst.problem, jp).solve(inst.x_0, inst.y_0)
    problem, x0, y0 = _rosenbrock()
    resumed = Solver(problem, tp, device="cpu").solve(x0, y0, checkpoint_path=path, resume=True)
    assert (resumed.status.name, resumed.iterations, resumed.num_accepted_steps) == (
        full.status.name, full.iterations, full.num_accepted_steps,
    )
    assert {c.name(): int(n) for c, n in resumed.num_evals.items()} == {
        c.name(): int(n) for c, n in full.num_evals.items()
    }
    tol = 1e-12 if precision == "Double" else 1e-6
    np.testing.assert_allclose(numpy(resumed.x), np.asarray(full.x), rtol=0, atol=tol)
