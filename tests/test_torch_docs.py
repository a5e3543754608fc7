"""The port's documentation: ``docs/torch/api/`` in sync with
``docs/torch/gen_api.py``, the index's links, the five examples of
``docs/torch/`` against the JAX package's solves of the same problems, and
the migration note.

Each example's ``main(device="cpu", ...)`` runs at a small size; the JAX
package solves the same problem from the same start with the same
parameters.  Tolerances: equal status and counts (iterations and accepted
steps; segments and integration steps for the continuous engine), x
within 1e-8 on the f64 paths and 1e-6 through the mixed-precision LDL^T
tier.  One run parts by last bits (HS71 under SDIRK4, ROADMAP Queue C
"Counts that rounding parts, JAX against the port"): it is held to JAX's
run from x0[2] = 5 + 2^-50, which takes the port's steps.
"""

import importlib.util
import os
import re

import numpy as np
import pytest

from .torch_parity import numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOCS = os.path.join(ROOT, "docs")
TORCH_DOCS = os.path.join(DOCS, "torch")

F64_TOL = 1e-8
PALLAS_TOL = 1e-6


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_example(name):
    return _load(os.path.join(TORCH_DOCS, f"{name}.py"), f"torch_example_{name}")


def _jax_example(name):
    return _load(os.path.join(DOCS, f"{name}.py"), f"jax_example_{name}")


def test_api_docs_in_sync(tmp_path):
    gen_api = _load(os.path.join(TORCH_DOCS, "gen_api.py"), "torch_gen_api")
    outdir = str(tmp_path / "api")
    gen_api.generate(outdir)

    checked_in = os.path.join(TORCH_DOCS, "api")
    gen_names = sorted(os.listdir(outdir))
    assert gen_names == sorted(os.listdir(checked_in))
    for name in gen_names:
        with open(os.path.join(outdir, name)) as f:
            generated = f.read()
        with open(os.path.join(checked_in, name)) as f:
            committed = f.read()
        assert generated == committed, (
            f"docs/torch/api/{name} is stale: run `python docs/torch/gen_api.py` and commit the result"
        )
        assert " at 0x" not in generated


def test_index_links_resolve():
    api = os.path.join(TORCH_DOCS, "api")
    with open(os.path.join(api, "index.md")) as f:
        index = f.read()
    targets = re.findall(r"\]\(([^)]+\.md)\)", index)
    assert "../MIGRATING.md" in targets and len(targets) > 10
    for target in targets:
        assert os.path.exists(os.path.join(api, target)), f"index.md links to missing {target}"


def _same(tr, jr, tol):
    assert (tr.status.name, tr.iterations, tr.num_accepted_steps) == (
        jr.status.name, jr.iterations, jr.num_accepted_steps,
    )
    np.testing.assert_allclose(numpy(tr.x), np.asarray(jr.x), rtol=0, atol=tol)


def _same_flow(tr, jr, tol=F64_TOL):
    _same(tr, jr, tol)
    assert tr.num_integration_steps == jr.num_integration_steps
    assert tr.final_rho == jr.final_rho


def test_solve_rosenbrock_matches_jax():
    from pygradflow_tpu import Params, Solver

    tr = _port_example("solve_rosenbrock").main(device="cpu")
    jr = Solver(_jax_example("solve_rosenbrock").Rosenbrock(), Params()).solve(np.array([0.0, 0.0]))
    assert (tr.iterations, tr.num_accepted_steps) == (30, 25)
    _same(tr, jr, F64_TOL)


def test_solve_constrained_matches_jax(tmp_path):
    from pygradflow_tpu import Params, Solver
    from pygradflow_tpu.integration import IntegrationSolver

    tr, tflow = _port_example("solve_constrained").main(device="cpu")
    hs71 = _jax_example("solve_constrained").HS71
    x0 = np.array([1.0, 5.0, 5.0, 1.0])
    jr = Solver(hs71(), Params(display=True)).solve(x0, checkpoint_path=str(tmp_path / "hs71.npz"))
    _same(tr, jr, F64_TOL)
    jflow = IntegrationSolver(hs71(), Params(rho=1e-2)).solve(x0)
    _same_flow(tflow, jflow)


def test_optimal_control_matches_jax():
    from pygradflow_tpu import Solver

    from .torch_parity import params_pair

    N = 16
    tr = _port_example("optimal_control").main(device="cpu", N=N)
    from pygradflow_tpu.runners.control import PendulumControlInterleaved

    jp, _ = params_pair(
        step_solver_type="Schur", schur_block_size=3, schur_dual_block_size=2, matrix_free=True,
        linear_solver_type="PallasLDLT", validate_input=False,
    )
    problem = PendulumControlInterleaved(N=N)
    jr = Solver(problem, jp).solve(problem.x0_trajectory())
    assert tr.status.name == "Optimal"
    _same(tr, jr, PALLAS_TOL)


def test_batched_sweep_matches_jax():
    import jax.numpy as jnp

    from pygradflow_tpu import Params
    from pygradflow_tpu.parallel import BatchedSolver

    B = 8
    tres, sharded = _port_example("batched_sweep").main(device="cpu", B=B)
    assert sharded is None
    rng = np.random.default_rng(0)
    x0s = rng.uniform(-1.0, 1.0, size=(B, 2))
    a = jnp.asarray(rng.uniform(0.5, 2.0, B))
    b = jnp.asarray(rng.uniform(50.0, 150.0, B))
    jres = BatchedSolver(_jax_example("batched_sweep").ParamRosenbrock(), Params()).solve(x0s, data=(a, b))
    for field in ("status", "iterations", "accepted_steps"):
        np.testing.assert_array_equal(numpy(getattr(tres, field)), np.asarray(getattr(jres, field)), err_msg=field)
    assert bool(np.all(numpy(tres.success)))
    np.testing.assert_allclose(numpy(tres.x), np.asarray(jres.x), rtol=0, atol=F64_TOL)


def test_continuous_flow_matches_jax():
    from pygradflow_tpu import IntegrationMethod, Params
    from pygradflow_tpu.integration import BatchedIntegrationSolver, IntegrationSolver

    B = 2
    host, device_loop, batch = _port_example("continuous_flow").main(device="cpu", B=B)
    hs71 = _jax_example("continuous_flow").HS71
    x0, y0 = np.array([1.0, 5.0, 5.0, 1.0, 0.0]), np.zeros(2)

    jhost = IntegrationSolver(hs71(), Params(rho=1e-2, iteration_limit=1000)).solve(x0, y0)
    assert (host.iterations, host.num_integration_steps) == (10, 357)
    _same_flow(host, jhost)

    sdirk4 = Params(rho=1e-2, iteration_limit=1000, integration_method=IntegrationMethod.SDIRK4)
    jdev = IntegrationSolver(
        hs71(),
        Params(rho=1e-2, iteration_limit=1000, integration_method=IntegrationMethod.SDIRK4, integration_device_loop=True),
    )
    # the knife edge of Queue C: JAX's run from x0[2] one step of 2^-50
    # above 5 takes the port's steps (JAX from 5 itself: 10/195)
    nudged = x0.copy()
    nudged[2] = 5.0 + 2.0**-50
    _same_flow(device_loop, jdev.solve(nudged, y0))
    assert (device_loop.iterations, device_loop.num_integration_steps) == (9, 189)

    rng = np.random.default_rng(0)
    x0s = np.clip(
        x0[None, :] + rng.uniform(-0.1, 0.1, size=(B, 5)),
        np.array([1.0, 1.0, 1.0, 1.0, 0.0]),
        np.array([5.0, 5.0, 5.0, 5.0, 2.0]),
    )
    jbatch = BatchedIntegrationSolver(hs71(), sdirk4).solve(x0s, np.tile(y0, (B, 1)))
    for field in ("status", "iterations", "num_integration_steps"):
        np.testing.assert_array_equal(numpy(getattr(batch, field)), np.asarray(getattr(jbatch, field)), err_msg=field)
    np.testing.assert_allclose(numpy(batch.x), np.asarray(jbatch.x), rtol=0, atol=F64_TOL)


def _queue_c_deliberate_headings():
    with open(os.path.join(ROOT, "ROADMAP.md")) as f:
        text = f.read()
    section = text.split("**Deliberate differences.**", 1)[1].split("**Not port faults.**", 1)[0]
    return [h.strip() for h in re.findall(r"^- \*\*(.+?)\*\*", section, flags=re.M)]


def test_migrating_names_every_deliberate_difference():
    headings = _queue_c_deliberate_headings()
    assert len(headings) >= 20
    with open(os.path.join(TORCH_DOCS, "MIGRATING.md")) as f:
        note = f.read()
    names = [re.sub(r" \(PRs? [\d, ]+\)$", "", h.rstrip(".")) for h in headings]
    missing = [h for h in names if f"**{h}.**" not in note]
    assert not missing, f"docs/torch/MIGRATING.md does not name {missing}"


@pytest.mark.parametrize("name", ["solve_rosenbrock", "solve_constrained", "optimal_control", "batched_sweep", "continuous_flow"])
def test_example_defaults_to_the_card(name, monkeypatch):
    """Without ``device`` an example solves on the card, and raises
    without one: the entry points' default."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        _port_example(name).main()
