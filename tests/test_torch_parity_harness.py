"""The port-against-JAX parity harness (``tools/torch_parity_check.py`` and
``tools/torch_parity_cases.py``).

The committed JAX rows (``tools/torch_parity_jax.json``) cover every case
and equal a live JAX run on a few fast cases (counts exactly, x, y and the
objective to 1e-12).  The port's side runs live on the same cases:
Rosenbrock, HS71 and Tame at ``Params()``, the continuous engine on Tame
(host loop) and one expected parting (hs44), each with the harness's own
verdict.  The whole sweep on the CPU (about 15 min with 6 workers: HS71
under Globalized Newton runs 10,000 iterations) is marked slow.
"""

import json
import os
import re

import numpy as np
import pytest

from tools import torch_parity_cases as pc
from tools import torch_parity_check as check

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAST = ["rosenbrock", "hs71", "tame", "integration:tame:host", "hs44"]


@pytest.fixture(scope="module")
def rows():
    return check.load_jax_rows()


def test_cases_are_parity_checks(rows):
    kinds = [c.kind for c in pc.cases()]
    assert [kinds.count(k) for k in ("hs", "option", "integration", "pendulum")] == [49, 39, 8, 2]
    assert list(rows) == list(pc.CASES)
    assert pc.CASES["hs104"].kwargs == {"iteration_limit": 2000}


@pytest.mark.parametrize("name", FAST)
def test_committed_rows_equal_a_live_jax_run(name, rows):
    live = check.run_jax(name)
    ref = rows[name]
    assert set(live) == set(ref)
    for key in ("status", "iterations", "accepted", "segments", "steps"):
        assert live.get(key) == ref.get(key), key
    for key in ("x", "y"):
        np.testing.assert_allclose(live[key], ref[key], rtol=1e-12, atol=1e-12)
    assert live["obj"] == pytest.approx(ref["obj"], rel=1e-12, abs=1e-12)


@pytest.mark.parametrize("name", FAST)
def test_port_matches_jax_rows(name, rows):
    verdict, details = pc.compare(pc.run_torch(name, "cpu"), rows[name], "cpu")
    expected = "parted as expected" if name in pc.EXPECTED_PARTINGS else "equal"
    assert verdict == expected, details


def test_expected_partings_cite_queue_c():
    with open(os.path.join(ROOT, "ROADMAP.md")) as f:
        roadmap = f.read()
    queue_c = roadmap.split("### Queue C", 1)[1]
    for name, reason in {**pc.EXPECTED_PARTINGS, **pc.CARD_PARTINGS}.items():
        assert name in pc.CASES
        heading = re.match(r"ROADMAP Queue C, '([^']+)'", reason)
        assert heading, reason
        assert re.search(rf"\*\*{re.escape(heading.group(1))}( \(PR \d+\))?\.\*\*", queue_c), reason
        assert name in queue_c


def test_a_new_parting_fails(rows):
    ours = dict(rows["hs71"], iterations=rows["hs71"]["iterations"] + 1)
    assert pc.compare(ours, rows["hs71"], "cpu")[0] == "FAILED"
    moved = dict(rows["rosenbrock"], x=[v + 1e-7 for v in rows["rosenbrock"]["x"]])
    assert pc.compare(moved, rows["rosenbrock"], "cpu")[0] == "FAILED"
    assert pc.compare(moved, rows["rosenbrock"], "cuda")[0] == "equal"
    # an expected parting keeps its status and its objective
    other = dict(rows["hs44"], status="IterationLimit")
    assert pc.compare(other, rows["hs44"], "cpu")[0] == "FAILED"
    off = dict(rows["hs44"], obj=rows["hs44"]["obj"] * (1 + 1e-5))
    assert pc.compare(off, rows["hs44"], "cpu")[0] == "FAILED"


def test_command_line_exits_nonzero_on_a_failure(tmp_path, capsys):
    bad = {"rows": [dict(r, iterations=r["iterations"] + 1) for r in check.load_jax_rows().values()]}
    path = tmp_path / "rows.json"
    path.write_text(json.dumps(bad))
    assert check.main(["--side", "torch", "--device", "cpu", "--rows", str(path), "--cases", "tame"]) == 1
    assert "1 failed (tame)" in capsys.readouterr().out
    assert check.main(["--side", "torch", "--device", "cpu", "--cases", "tame", "hs44"]) == 0
    assert "1 equal, 1 parted as expected (hs44), 0 failed" in capsys.readouterr().out


@pytest.mark.slow
def test_every_case_on_the_cpu(rows):
    names = check.select()
    results = check.check(names, "cpu", workers=min(6, os.cpu_count() or 1), rows=rows, out=lambda *a, **k: None)
    failed = [(name, details) for name, verdict, details, _ in results if verdict == "FAILED"]
    assert not failed
    parted = sorted(name for name, verdict, _, _ in results if verdict == "parted as expected")
    assert parted == sorted(pc.EXPECTED_PARTINGS)
