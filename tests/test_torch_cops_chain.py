"""The COPS hanging chain of the benchmark (``perfbench/configs/
cops-chain.*``) on the CPU: its plain reference against ``torch.func`` on
the port's problem, the port's solves judged by the benchmark's comparison
and the faults that comparison has to catch, the counter of refined KKT
solves and the metrics that read it, at small nh."""

import numpy as np
import pytest
import torch
from torch.func import grad, jacfwd

from pygradflow_torch import LinearSolverType, SolverStatus, Solver, util
from pygradflow_torch.linalg import factor_route
from pygradflow_torch.linalg import ldlt_kernels as lk

from . import cops_chain as cc
from .torch_parity import saddle

NH = 16


def _judge(results, deltas, nh=NH):
    from harness.judge import judge

    status = np.array([int(r.status) for r in results])
    x = np.stack([r.x.numpy() for r in results])
    y = np.stack([r.y.numpy() for r in results])
    return judge(cc.REFERENCE, cc.NUMBERS, {"nh": nh}, status, x, y, {"delta": np.stack(deltas)}, cc.LIMITS)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_equals_torch_func(seed):
    """Constraints, objective gradient and J^T y of the reference equal
    ``torch.func``'s on the configuration's problem at random points,
    multipliers and instances (nh = 8)."""
    nh = 8
    prob = cc.problem(nh)
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal((3, prob.num_vars)))
    y = torch.tensor(rng.standard_normal((3, prob.num_cons)))
    delta = torch.tensor(rng.uniform(-0.5, 0.5, (3, 3)))
    cons = cc.REFERENCE.constraints(x, delta, cc.NUMBERS, nh)
    gradient = cc.REFERENCE.gradient(x, nh)
    jty = cc.REFERENCE.jac_t_y(x, y, nh)
    for i in range(3):
        data = (delta[i],)
        torch.testing.assert_close(cons[i], prob.p_cons(x[i], data), rtol=0, atol=1e-12)
        torch.testing.assert_close(gradient[i], grad(prob.p_obj)(x[i], data), rtol=0, atol=1e-12)
        jac = jacfwd(prob.p_cons)(x[i], data)
        torch.testing.assert_close(jty[i], jac.T @ y[i], rtol=0, atol=1e-12)


def test_sizes_and_route():
    """At the cell's nh = 200: n = 804, m = 605, and the KKT matrix of
    1409 rows goes to the left-looking kernel B3'; the start meets every
    defect."""
    prob = cc.problem(200)
    assert (prob.num_vars, prob.num_cons) == (804, 605)
    assert factor_route(prob.num_vars + prob.num_cons) == "ll"
    cons = prob.cons(torch.tensor(cc.CONFIG.base_start(prob)))
    assert float(cons[:600].abs().max()) < 1e-12


@pytest.mark.parametrize("tier", ["PallasLDLT", "LU"])
def test_port_solves_are_judged_correct(tier):
    """The port's CPU solves of three instances through one solver, each
    posed by overwriting the problem's data in place, are Optimal and the
    benchmark's comparison calls them correct under the cell's limits."""
    prob = cc.problem(NH)
    solver = Solver(prob, cc.params(linear_solver_type=tier), device="cpu")
    inst = cc.instances(prob, 7, 3)
    results = [cc.solve(solver, prob, delta, x0) for delta, x0 in inst]
    assert all(r.status == SolverStatus.Optimal for r in results)
    verdict = _judge(results, [delta for delta, _ in inst])
    assert verdict.correct and verdict.failed == 0, verdict.lines
    assert verdict.gap is None and verdict.checks["f32_grid_share"]["value"] == 0.0


@pytest.fixture(scope="module")
def sound():
    """One sound answer (PallasLDLT, nh = 16) and its instance."""
    prob = cc.problem(NH)
    solver = Solver(prob, cc.params(), device="cpu")
    delta, x0 = cc.instances(prob, 11, 1)[0]
    result = cc.solve(solver, prob, delta, x0)
    assert result.status == SolverStatus.Optimal
    return result, delta


def _moved(result, **fields):
    return type("Answer", (), {"status": result.status, "x": result.x, "y": result.y, **fields})


@pytest.mark.parametrize("fault", ["other_instance", "x_moved", "y_zero"])
def test_faults_are_not_correct(sound, fault):
    """Each fault fails the comparison: the answer judged against another
    instance's delta, one component of x moved by 1e-4, y set to zero."""
    result, delta = sound
    assert _judge([result], [delta]).correct
    if fault == "other_instance":
        verdict = _judge([result], [delta + np.array([0.0, 0.01, 0.0])])
    elif fault == "x_moved":
        x = result.x.clone()
        x[2 * (NH + 1) + NH // 2] += 1e-4
        verdict = _judge([_moved(result, x=x)], [delta])
    else:
        verdict = _judge([_moved(result, y=torch.zeros_like(result.y))], [delta])
    assert not verdict.correct and verdict.failed == 1


@pytest.mark.parametrize("iters", [0, 1, 3])
def test_refined_counter_counts_solves_and_sweeps(iters):
    """``refine_solve`` counts one solve and ``iters`` sweeps a call, in
    ``REFINED`` and not in ``LAUNCHES``, for one system and for a stack."""
    a = torch.tensor(saddle(np.random.default_rng(iters), 40, 20))
    packed = lk.ldlt_factor_rl(a.to(torch.float32))
    b = torch.tensor(np.random.default_rng(5).standard_normal(60))
    launches, before = dict(lk.LAUNCHES), dict(lk.REFINED)
    x = lk.refine_solve(packed, a, b, iters=iters)
    assert lk.REFINED == {"solves": before["solves"] + 1, "sweeps": before["sweeps"] + iters}
    lk.refine_solve(packed.expand(2, 60, 60), a.expand(2, 60, 60), b.expand(2, 60), iters=iters)
    assert lk.REFINED == {"solves": before["solves"] + 2, "sweeps": before["sweeps"] + 2 * iters}
    assert lk.LAUNCHES == launches
    if iters == 3:
        np.testing.assert_allclose((a @ x).numpy(), b.numpy(), atol=1e-10)


def _profiled_solve(tier, jit_chunk):
    from torch.profiler import profile

    prob = cc.problem(NH)
    solver = Solver(prob, cc.params(linear_solver_type=tier, jit_chunk=jit_chunk), device="cpu")
    delta, x0 = cc.instances(prob, 3, 1)[0]
    util.SPANS.clear()
    before = dict(lk.REFINED)
    with profile():
        result = cc.solve(solver, prob, delta, x0)
    waits = [sp for sp in util.SPANS if sp.name == "pgf.wait"]
    return result, {k: lk.REFINED[k] - before[k] for k in before}, waits


@pytest.mark.parametrize("tier", ["PallasLDLT", "LU"])
def test_wait_span_carries_the_chunks_refined_solves(tier):
    """Each chunk's ``pgf.wait`` span carries ``kkt_solves``, the chunk's
    change of ``REFINED["solves"]``; on PallasLDLT they add up to the
    solve's count, two a Newton iteration with three sweeps each, and a
    LU-tier solve counts none."""
    result, counted, waits = _profiled_solve(tier, 8)
    assert result.status == SolverStatus.Optimal
    assert len(waits) == -(-(result.iterations + 1) // 8)
    assert all(set(sp.attrs) == {"kkt_solves"} for sp in waits)
    assert sum(sp.attrs["kkt_solves"] for sp in waits) == counted["solves"]
    if tier == "LU":
        assert counted == {"solves": 0, "sweeps": 0}
    else:
        assert counted == {"solves": 2 * result.iterations, "sweeps": 6 * result.iterations}


def _reader(name):
    return cc.MANIFEST.metric_reader(name).read


def _stretch(kernels=(), window_ns=1000, iterations=10):
    from types import SimpleNamespace

    trace = SimpleNamespace(kernels=list(kernels), window_s=window_ns * 1e-9, start=0, end=window_ns)
    return SimpleNamespace(stretch=SimpleNamespace(trace=trace, iterations=iterations, calls=slice(0, 2)))


def test_trisolve_share_reads_the_triangular_solves():
    """``trisolve_share`` sums the device time of cuBLAS's triangular-solve
    kernels, by the names the card's trace gives them, over the stretch."""
    read = _reader("trisolve_share")
    kernels = [("void trsv_lt_exec_up<float, 32u, 32u, 4u, true, false>(int, float const*, long, float*)", 150),
               ("void trsv_ln_exec_up<float, 32u, 32u, 4u, true>(int, float const*, long, float*)", 100),
               ("void (anonymous namespace)::left_update_kernel<64>(float*, int, int, int)", 300),
               ("void at::native::vectorized_elementwise_kernel<2, at::native::CUDAFunctor_add<double>>", 50)]
    assert read(_stretch(kernels)) == pytest.approx(25.0)
    assert read(_stretch(kernels[2:])) is None
    assert read(type("Ctx", (), {"stretch": None})) is None


def test_kkt_solves_per_iter_reads_the_wait_spans(monkeypatch):
    """``kkt_solves_per_iter`` sums ``kkt_solves`` over the stretch's
    ``pgf.wait`` spans over its iterations; a program whose spans lack the
    attribute gives None."""
    read = _reader("kkt_solves_per_iter")

    def span(name, start, attrs):
        return util.Span(start, name, start, start + 10, 1, -1, attrs)

    ring = [span("pgf.chunk", 100, {"width": 1, "bodies": 12}), span("pgf.wait", 200, {"kkt_solves": 24}),
            span("pgf.wait", 400, {"kkt_solves": 6}), span("pgf.wait", 5000, {"kkt_solves": 99})]
    monkeypatch.setattr(util, "SPANS", ring)
    assert read(_stretch(iterations=12)) == pytest.approx(30 / 12)
    monkeypatch.setattr(util, "SPANS", [span("pgf.wait", 200, {})])
    assert read(_stretch()) is None


@pytest.fixture
def small(tmp_path):
    """A ``Manifest`` of a copy of the benchmark whose chain mix has nh = 16."""
    import json
    import shutil

    from harness.manifest import Manifest

    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(cc.os.path.join(cc.ROOT, "BENCHMARK.json"), root)
    shutil.copytree(cc.BENCH, root / "perfbench", ignore=shutil.ignore_patterns("_cache", "__pycache__", "tests"))
    path = root / "perfbench" / "traffic" / "single-nh200.json"
    mix = json.loads(path.read_text())
    mix["size"]["nh"] = NH
    path.write_text(json.dumps(mix))
    return Manifest(str(root), str(root / "perfbench"))


@pytest.mark.parametrize("precision", ["Double", "Single"])
def test_the_cell_on_the_cpu(small, precision):
    """The cell's run on the CPU at nh = 16: correct as configured, and the
    float32 control not correct (every answer on the float32 grid); traced,
    ``kkt_solves_per_iter`` reads the wait spans and the device metrics
    find no kernel to read."""
    from harness.cell import run

    result, lines = run(cc.CELL, 2**31 + 1901, 0.3, precision == "Double", "cpu", small,
                        overrides={"precision": precision})
    if precision == "Double":
        assert result["correct"] and result["failed"] == 0, lines
        assert set(result["metrics"]) == {"kkt_solves_per_iter"}
        assert result["metrics"]["kkt_solves_per_iter"]["value"] == pytest.approx(2.0)
    else:
        assert not result["correct"]
        assert result["checks"]["f32_grid_share"]["value"] == 1.0
