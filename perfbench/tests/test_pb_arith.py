"""The metric arithmetic: the p90 over all solves, the device's idle share
as a union of intervals, and the copied roofline bound."""

import math
from types import SimpleNamespace

import numpy as np
import pytest
from conftest import BENCH, ROOT

from harness.manifest import Manifest
from harness.roofline import bound, is_ldlt_kernel
from harness.stats import percentile, spread
from harness.trace import STRETCH, Trace, gaps, union

MANIFEST = Manifest(ROOT, BENCH)


def test_p90_is_over_all_solves():
    assert percentile(list(range(1, 101)), 90) == 90
    assert percentile([5.0] * 9 + [1.0], 90) == 5.0
    times = [10.0] * 95 + [float("inf")] * 5
    assert percentile(times, 90) == 10.0
    assert percentile([10.0] * 85 + [float("inf")] * 15, 90) == float("inf")  # a failed solve is over any limit


def test_spread_is_the_quartile_distance_over_the_median():
    assert spread([1, 2, 3, 4, 5, 6]) == pytest.approx((5.25 - 1.75) / 3.5)


def test_union_and_gaps():
    assert union([(5, 7), (0, 2), (1, 3), (7, 8)]) == [[0, 3], [5, 8]]
    assert gaps([[0, 3], [5, 8]], 0, 10) == [(3, 5), (8, 10)]
    assert gaps([[2, 4]], 0, 3) == [(0, 2)]
    assert gaps([], 0, 1) == [(0, 1)]


def _trace():
    ev = [
        ("user_annotation", STRETCH, 100, 200),
        ("user_annotation", "solve", 100, 150),
        ("user_annotation", "sync", 150, 190),
        ("user_annotation", "draw", 190, 200),
        ("kernel", "void diag_block_kernel<64>(float*)", 90, 120),  # clipped to the stretch
        ("kernel", "elementwise", 110, 130),  # overlaps: counted once
        ("gpu_memcpy", "Memcpy DtoH", 140, 145),
        ("gpu_memset", "Memset", 160, 170),
        ("gpu_user_annotation", "solve", 100, 150),  # not device work
        ("kernel", "sync", 150, 190),  # a host span mirrored as a kernel: not device work
        ("cuda_runtime", "cudaGraphLaunch", 101, 102),
        ("kernel", "late", 250, 260),  # outside the stretch
    ]
    return Trace(ev)


def test_idle_is_one_minus_the_union_of_device_intervals():
    t = _trace()
    assert t.window_s == pytest.approx(100e-9)
    assert t.busy_s == pytest.approx((30 + 5 + 10) * 1e-9)
    assert len(t.kernels) == 2
    ctx = SimpleNamespace(stretch=SimpleNamespace(trace=t))
    assert MANIFEST.metric_reader("idle_share").read(ctx) == pytest.approx(55.0)


def test_idle_gaps_go_to_the_host_span_around_them():
    gaps_by_span = dict(_trace().idle_gaps())
    # gaps 130-140 (its middle in solve), 145-160 and 170-200 (middles in sync)
    assert gaps_by_span == pytest.approx({"solve": 10e-9, "sync": 45e-9})
    ops = _trace().device_ops()
    assert ops[0][0].startswith("void diag_block_kernel") and ops[0][1] == pytest.approx(20e-9)


def test_one_stretch_span_is_required():
    with pytest.raises(ValueError):
        Trace([("kernel", "k", 0, 1)])


def test_copied_bound_at_the_pendulum_sizes():
    t, kind = bound((1284, 1284))
    assert kind == "operations" and t * 1e6 == pytest.approx(10.53, abs=0.005)
    t, kind = bound((128, 324, 324))
    assert kind == "bytes" and t * 1e6 == pytest.approx(32.09, abs=0.005)


def test_ldlt_kernel_names():
    for name in ("pad_identity_kernel", "void diag_block_kernel<128>(float const*, int)", "left_update_kernel",
                 "panel_rows_kernel<64>", "trailing_update_kernel<128, 8>"):
        assert is_ldlt_kernel(name)
    assert not is_ldlt_kernel("void at::native::elementwise_kernel<128, 4>()")


def _roofline_ctx(launches, kernel_ns, lanes=1, n=770, m=514):
    t = SimpleNamespace(kernels=[("void left_update_kernel(float*)", kernel_ns), ("other", 10**9)])
    return SimpleNamespace(n=n, m=m, lanes=lanes, stretch=SimpleNamespace(launches=launches, trace=t))


def test_ldlt_roofline_counts_the_unpadded_size_times_the_stack():
    read = MANIFEST.metric_reader("ldlt_roofline").read
    # 64 factors at KKT 1284 in 64 * 441 us of kernel time
    value = read(_roofline_ctx({"rl": 0, "ll": 64, "rl_batched": 0}, 64 * 441_000))
    assert value == pytest.approx(100 * 10.532 / 441, rel=1e-3)
    value = read(_roofline_ctx({"rl": 0, "ll": 0, "rl_batched": 10}, 10 * 412_000, lanes=128, n=194, m=130))
    assert value == pytest.approx(100 * 32.09 / 412, rel=1e-3)
    assert read(_roofline_ctx({"rl": 0, "ll": 0, "rl_batched": 0}, 0)) is None
    assert read(SimpleNamespace(stretch=None)) is None


def test_counter_readers():
    s = SimpleNamespace(solves=4, iterations=72, chunk_reads=4, trace=SimpleNamespace(kernels=[("k", 1)] * 400))
    ctx = SimpleNamespace(kind="single", jit_chunk=64, stretch=s)
    assert MANIFEST.metric_reader("iters_per_solve").read(ctx) == 18.0
    assert MANIFEST.metric_reader("body_use").read(ctx) == pytest.approx(100 * 72 / 256)
    assert MANIFEST.metric_reader("kernels_per_solve").read(ctx) == 100.0
    ctx.kind = "batched"
    assert MANIFEST.metric_reader("body_use").read(ctx) is None
    none = SimpleNamespace(kind="single", stretch=None)
    for name in ("iters_per_solve", "body_use", "kernels_per_solve", "idle_share", "ldlt_roofline"):
        assert MANIFEST.metric_reader(name).read(none) is None
    assert not math.isinf(MANIFEST.metric_reader("solves_per_s").read(SimpleNamespace(solves=10, window_s=2.0)))


def test_result_lines_are_strict_json():
    import json

    from harness.cell import json_safe

    line = json_safe({"a": float("inf"), "b": [1.5, float("nan")], "c": {"d": 2}})
    assert json.dumps(line, allow_nan=False) == '{"a": null, "b": [1.5, null], "c": {"d": 2}}'


def test_the_judge_holds_each_answer_to_cons_viol_max_where_the_limits_name_it():
    from harness.judge import judge
    from pygradflow_torch import SolverStatus

    def residuals(x, y, data, numbers, size, active_tol):
        cons = np.asarray(data["c"], dtype=np.float64)[:, 0]
        return {"stat": np.zeros(len(cons)), "cons": cons, "bound": np.zeros(len(cons))}

    ref = SimpleNamespace(residuals=residuals)
    numbers = {"params": {"active_tol": 1e-8}}
    status = np.full(3, int(SolverStatus.Optimal))
    x, y, data = np.full((3, 2), 0.1), np.zeros((3, 1)), {"c": np.array([[1e-9], [5e-8], [2e-9]])}
    limits = {"not_optimal": 0, "kkt_res_max": 1e-6, "cons_viol_max": 3e-8}
    verdict = judge(ref, numbers, {}, status, x, y, data, limits)
    assert not verdict.correct and verdict.failed == 1 and verdict.checks["cons_viol_max"]["value"] == 5e-8
    del limits["cons_viol_max"]
    verdict = judge(ref, numbers, {}, status, x, y, data, limits)
    assert verdict.correct and "cons_viol_max" not in verdict.checks
