"""The port's runners against the JAX package's, on the CPU: the HS runner's
CSV rows (every column but ``total_time``), the CSV schema, the QP runner's
instances, the inline MPS and QPLIB samples (the port's C++ MPS reader
against its Python one), the CUTEst adapter on the pycutest test double of
``tests/test_cutest.py``, the watchdogs of ``tests/test_runner_timeout.py``
(``--parallel`` children with ``--device cpu``), ``--debug_nans``, and a
runner without a card that is not told ``--device cpu``.
"""

import csv
import os
import time
import types

import numpy as np
import pytest
import torch

from pygradflow_torch import Params, Solver, SolverStatus
from pygradflow_torch.problem import QuadraticProblem
from pygradflow_torch.runners.instance import FiniteCheckProblem, Instance
from pygradflow_torch.runners.runner import FIELDNAMES, Runner
from tests.test_cutest import fake_pycutest  # noqa: F401 (fixture)
from tests.test_qplib import QPLIB_SAMPLE
from tests.test_runners import MPS_SAMPLE

from .torch_parity import numpy

ROW_RTOL, ROW_ATOL = 1e-8, 1e-12
"""The numeric CSV columns of a port row against the JAX row; the absolute
part serves the residual columns, whose values near 1e-8 come from sums
that cancel, so that their last bits follow the summation order (1e-15
apart on the QP row)."""


def _rows(out_dir):
    with open(os.path.join(out_dir, "output.csv")) as f:
        return {row["instance"]: row for row in csv.DictReader(f)}


def _assert_rows_match(ours, ref):
    assert set(ours) == set(ref)
    for name, row in ours.items():
        for key in FIELDNAMES:
            if key == "total_time":
                continue
            a, b = row[key], ref[name][key]
            try:
                fa, fb = float(a), float(b)
            except ValueError:
                assert a == b, (name, key)
                continue
            np.testing.assert_allclose(fa, fb, rtol=ROW_RTOL, atol=ROW_ATOL, err_msg=f"{name} {key}")


def test_csv_schema_is_the_jax_schema():
    from pygradflow_tpu.runners.runner import FIELDNAMES as JAX_FIELDNAMES

    assert FIELDNAMES == JAX_FIELDNAMES


@pytest.mark.parametrize("name", ["hs14", "hs28", "hs71"])
def test_hs_runner_rows_match_jax(tmp_path, name):
    from pygradflow_torch.runners.hs_runner import HSRunner
    from pygradflow_tpu.runners.hs_runner import HSRunner as JHSRunner

    ours, ref = str(tmp_path / "ours"), str(tmp_path / "ref")
    HSRunner().main(["--output", ours, "--name", name, "--device", "cpu"])
    JHSRunner().main(["--output", ref, "--name", name])
    _assert_rows_match(_rows(ours), _rows(ref))
    for out in (ours, ref):
        assert os.path.exists(os.path.join(out, "params.yml"))
        assert os.path.exists(os.path.join(out, f"{name}.log"))
    assert _rows(ours)[name]["status"] == "optimal"


def test_qp_runner_instances_match_jax():
    from pygradflow_torch.runners.qp_runner import QPRunner, random_eq_qp
    from pygradflow_tpu.runners.qp_runner import QPRunner as JQPRunner

    ours, ref = QPRunner(), JQPRunner()
    args, jargs = ours.parser().parse_args([]), ref.parser().parse_args([])
    pairs = list(zip(ours.get_instances(args), ref.get_instances(jargs)))
    assert len(pairs) == 4
    for mine, theirs in pairs:
        assert (mine.name, mine.num_vars, mine.num_cons) == (theirs.name, theirs.num_vars, theirs.num_cons)
        p, q = mine.problem(), theirs.problem()
        for key in ("Q", "c", "A"):
            a, b = getattr(p, key), getattr(q, key)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(numpy(a), np.asarray(b))
        for key in ("var_lb", "var_ub", "cons_lb", "cons_ub"):
            np.testing.assert_array_equal(getattr(p, key), getattr(q, key))

    # tests/test_runners.py::test_qp_runner_instances: the KKT conditions
    problem = random_eq_qp(16, 4, seed=1)
    result = Solver(problem, Params(), device="cpu").solve()
    assert result.success
    Q, c, A = (numpy(t) for t in (problem.Q, problem.c, problem.A))
    x, y = numpy(result.x), numpy(result.y)
    np.testing.assert_allclose(Q @ x + c + A.T @ y, 0.0, atol=1e-6)
    np.testing.assert_allclose(A @ x, problem.cons_lb, atol=1e-6)


def test_qp_runner_row_matches_jax(tmp_path):
    from pygradflow_torch.runners.qp_runner import QPRunner
    from pygradflow_tpu.runners.qp_runner import QPRunner as JQPRunner

    ours, ref = str(tmp_path / "ours"), str(tmp_path / "ref")
    QPRunner().main(["--output", ours, "--name", "randeq32x8", "--device", "cpu"])
    JQPRunner().main(["--output", ref, "--name", "randeq32x8"])
    _assert_rows_match(_rows(ours), _rows(ref))


def test_mps_native_and_python_readers_and_solve(tmp_path):
    from pygradflow_torch.native import available, library_path, parse_mps_native
    from pygradflow_torch.runners.mps import parse_mps, parse_mps_py
    from pygradflow_torch.runners.mps_runner import MPSProblem
    from pygradflow_tpu.runners.mps import parse_mps_py as jax_parse_mps_py

    path = tmp_path / "sample.mps"
    path.write_text(MPS_SAMPLE)
    assert available()
    assert library_path().parent.parent.name == "_build"
    native, py, ref = parse_mps_native(str(path)), parse_mps_py(str(path)), jax_parse_mps_py(str(path))
    for data in (native, parse_mps(str(path)), ref):
        assert data.name == py.name == "SAMPLE"
        for key in ("c", "A", "cons_lb", "cons_ub", "var_lb", "var_ub"):
            np.testing.assert_array_equal(getattr(data, key), getattr(py, key), err_msg=key)
        assert data.obj_offset == py.obj_offset
    np.testing.assert_allclose(py.cons_lb, [-np.inf, 1.0, 7.0])
    np.testing.assert_allclose(py.var_lb, [0.0, -1.0, 0.0])

    # min x1 + 2 x2 - x3: optimum (1, -1, 8)
    result = Solver(MPSProblem(py), Params(), device="cpu").solve()
    assert result.success
    np.testing.assert_allclose(numpy(result.x), [1.0, -1.0, 8.0], atol=1e-5)


def test_mps_runner_row_matches_jax(tmp_path):
    from pygradflow_torch.runners.mps_runner import MPSRunner
    from pygradflow_tpu.runners.mps_runner import MPSRunner as JMPSRunner

    (tmp_path / "lp").mkdir()
    (tmp_path / "lp" / "sample.mps").write_text(MPS_SAMPLE)
    ours, ref = str(tmp_path / "ours"), str(tmp_path / "ref")
    MPSRunner().main(["--output", ours, "--dir", str(tmp_path / "lp"), "--device", "cpu"])
    JMPSRunner().main(["--output", ref, "--dir", str(tmp_path / "lp")])
    _assert_rows_match(_rows(ours), _rows(ref))


def test_qplib_parse_matches_jax_and_solves(tmp_path):
    from pygradflow_torch.runners.qplib import parse_qplib
    from pygradflow_tpu.runners.qplib import parse_qplib as jax_parse_qplib

    path = tmp_path / "sample.qplib"
    path.write_text(QPLIB_SAMPLE)
    data, ref = parse_qplib(str(path)), jax_parse_qplib(str(path))
    assert data.name == ref.name == "MYQP" and data.sense == ref.sense
    for key in ("Q", "c", "A", "cons_lb", "cons_ub", "var_lb", "var_ub", "x0"):
        np.testing.assert_array_equal(getattr(data, key), getattr(ref, key), err_msg=key)
    problem = QuadraticProblem(
        data.Q, data.c, A=data.A, cons_lb=data.cons_lb, cons_ub=data.cons_ub,
        var_lb=data.var_lb, var_ub=data.var_ub,
    )
    result = Solver(problem, Params(), device="cpu").solve(data.x0)
    assert result.success
    np.testing.assert_allclose(numpy(result.x), [0.0, 1.0], atol=1e-6)


def test_cutest_instances_filtered(fake_pycutest):  # noqa: F811
    from pygradflow_torch.runners.cutest_runner import CUTEstRunner

    runner = CUTEstRunner()
    instances = {i.name: i for i in runner.get_instances(runner.parser().parse_args([]))}
    assert set(instances) == {"CAMEL", "CHAIN", "POWNE"}
    assert instances["CHAIN"].num_cons == 1 and instances["POWNE"].num_cons == 0
    names = {i.name for i in runner.get_instances(runner.parser().parse_args(["--ignore_ne_probs"]))}
    assert names == {"CAMEL", "CHAIN"}


def test_cutest_without_pycutest_lists_nothing(monkeypatch):
    import sys

    from pygradflow_torch.runners.cutest_runner import CUTEstRunner

    monkeypatch.setitem(sys.modules, "pycutest", None)
    runner = CUTEstRunner()
    assert runner.get_instances(runner.parser().parse_args([])) == []


@pytest.mark.parametrize("name, x_opt", [("CAMEL", [1.0, -0.5]), ("CHAIN", [0.5, 0.5]), ("POWNE", [1.0, 1.0])])
def test_cutest_solves_match_jax(fake_pycutest, name, x_opt):  # noqa: F811
    from pygradflow_torch.runners.cutest_runner import CUTEstRunner
    from pygradflow_tpu import Params as JParams
    from pygradflow_tpu.runners.cutest_runner import CUTEstRunner as JCUTEstRunner

    runner, jrunner = CUTEstRunner(), JCUTEstRunner()
    (inst,) = runner.get_instances(runner.parser().parse_args(["--problems", name]))
    (jinst,) = jrunner.get_instances(jrunner.parser().parse_args(["--problems", name]))
    problem = inst.problem()
    assert np.isinf(problem.var_lb).all() == (name != "POWNE")
    ours, ref = inst.solve(Params(), "cpu"), jinst.solve(JParams())
    assert ours.success
    assert (ours.iterations, ours.num_accepted_steps) == (ref.iterations, ref.num_accepted_steps)
    np.testing.assert_allclose(numpy(ours.x), np.asarray(ref.x), rtol=0, atol=1e-8)
    np.testing.assert_allclose(numpy(ours.x), x_opt, atol=1e-5)


def test_cutest_ne_translation(fake_pycutest):  # noqa: F811
    from pygradflow_torch.runners.cutest_runner import CUTEstNEProblem, CUTEstRunner

    runner = CUTEstRunner()
    (inst,) = runner.get_instances(runner.parser().parse_args(["--problems", "POWNE"]))
    problem = inst.problem()
    assert isinstance(problem, CUTEstNEProblem) and problem.num_cons == 0
    x = torch.zeros(2, dtype=torch.float64)
    assert float(problem.obj(x)) == 0.5 * 9.0
    np.testing.assert_allclose(numpy(problem.obj_grad(x)), [-3.0, -6.0])
    np.testing.assert_allclose(numpy(problem.lag_hess(x, None)), [[2.0, 1.0], [1.0, 5.0]])


def test_cutest_runner_csv(fake_pycutest, tmp_path):  # noqa: F811
    from pygradflow_torch.runners.cutest_runner import CUTEstRunner

    out = str(tmp_path / "out")
    CUTEstRunner().main(["--output", out, "--iteration_limit", "200", "--device", "cpu"])
    rows = _rows(out)
    assert set(rows) == {"CAMEL", "CHAIN", "POWNE"}
    for name, row in rows.items():
        assert row["status"] == "optimal", (name, row)
        assert float(row["final_stat_res"]) < 1e-6


def _fake_result():
    return types.SimpleNamespace(
        status=SolverStatus.Optimal,
        total_time=0.01,
        iterations=5,
        num_accepted_steps=4,
        final_scaled_obj=1.0,
        final_stat_res=1e-9,
        final_cons_violation=0.0,
        dist_factor=1.0,
    )


class QuickInstance(Instance):
    def __init__(self, name):
        super().__init__(name, 2, 0)

    def solve(self, params, device=None, debug_nans=False):
        return _fake_result()

    def problem(self):
        raise NotImplementedError()

    def x0(self):
        return np.zeros(2)


class HangingInstance(QuickInstance):
    def __init__(self):
        super().__init__("hang")

    def solve(self, params, device=None, debug_nans=False):
        for _ in range(1000):
            time.sleep(0.25)
        return _fake_result()


class MixedRunner(Runner):
    def __init__(self):
        super().__init__("mixed")

    def get_instances(self, args):
        return [QuickInstance("fast1"), HangingInstance(), QuickInstance("fast2")]


def test_sequential_watchdog_times_out_and_continues(tmp_path):
    out = str(tmp_path / "run")
    MixedRunner().main(["--output", out, "--time_limit", "1.0", "--device", "cpu"])
    rows = _rows(out)
    assert set(rows) == {"fast1", "hang", "fast2"}
    assert rows["hang"]["status"] == "timeout"
    assert float(rows["hang"]["total_time"]) == 1.0
    assert rows["fast1"]["status"] == rows["fast2"]["status"] == "optimal"
    assert rows["fast2"]["iterations"] == "5"


def test_parallel_mode_hard_kills(tmp_path):
    out = str(tmp_path / "runp")
    MixedRunner().main(["--output", out, "--time_limit", "2.0", "--parallel", "2", "--device", "cpu"])
    rows = _rows(out)
    assert set(rows) == {"fast1", "hang", "fast2"}
    assert rows["hang"]["status"] == "timeout"
    assert rows["fast1"]["status"] == rows["fast2"]["status"] == "optimal"


@pytest.mark.parametrize("parallel", ["0", "2"])
def test_runner_without_a_card_exits_before_any_row(tmp_path, parallel):
    from pygradflow_torch.runners.hs_runner import HSRunner

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")

    out = str(tmp_path / "nocard")
    with pytest.raises(SystemExit) as exc:
        HSRunner().main(["--output", out, "--name", "hs71", "--parallel", parallel])
    assert exc.value.code not in (0, None)
    assert not os.path.exists(os.path.join(out, "output.csv"))


def test_debug_nans(tmp_path):
    """A non-finite evaluation raises under ``--debug_nans``; a run that
    meets none gives the row of the run without it."""
    from pygradflow_torch.runners.hs import HS_BY_NAME
    from pygradflow_torch.runners.hs_runner import HSRunner

    problem = FiniteCheckProblem(HS_BY_NAME["hs71"].problem())
    assert problem.num_vars == 4 and problem.num_cons == 2
    with pytest.raises(FloatingPointError, match="obj"):
        problem.obj(torch.tensor([1.0, float("nan"), 1.0, 1.0], dtype=torch.float64))
    plain, checked = str(tmp_path / "plain"), str(tmp_path / "checked")
    HSRunner().main(["--output", plain, "--name", "hs71", "--device", "cpu"])
    HSRunner().main(["--output", checked, "--name", "hs71", "--device", "cpu", "--debug_nans"])
    _assert_rows_match(_rows(checked), _rows(plain))


# Specs whose counts part between the packages on the CPU (ROADMAP Queue C,
# "The HS sweep"): the DistanceRatio control amplifies last-bit differences
# of equal iterates into lambdas 1e-4 apart; JAX's own sweep parts from its
# committed CSV on hs13, hs18, hs44 and hs62.  Held to equal statuses and,
# where Optimal, objectives within 1e-6 relative.
HS_PARTED = {"hs13", "hs18", "hs44", "hs62", "hs104", "hs106", "hs118"}


@pytest.mark.slow
def test_hs_sweep_matches_jax(tmp_path):
    """The whole suite through both packages' runners (``--parallel 4``):
    every row equal to JAX's but the parted specs."""
    from pygradflow_torch.runners.hs_runner import HSRunner
    from pygradflow_tpu.runners.hs_runner import HSRunner as JHSRunner

    ours, ref = str(tmp_path / "ours"), str(tmp_path / "ref")
    HSRunner().main(["--output", ours, "--parallel", "4", "--device", "cpu"])
    JHSRunner().main(["--output", ref, "--parallel", "4"])
    ours, ref = _rows(ours), _rows(ref)
    assert len(ours) == len(ref) == 80
    _assert_rows_match({k: v for k, v in ours.items() if k not in HS_PARTED},
                       {k: v for k, v in ref.items() if k not in HS_PARTED})
    for name in HS_PARTED:
        assert ours[name]["status"] == ref[name]["status"], name
        if ours[name]["status"] == "optimal":
            obj, obj_ref = float(ours[name]["final_scaled_obj"]), float(ref[name]["final_scaled_obj"])
            assert abs(obj - obj_ref) <= 1e-6 * max(1.0, abs(obj_ref)), name
