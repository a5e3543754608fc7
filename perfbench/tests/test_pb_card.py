"""The measuring path refuses to run without the card it needs, and
without the program beside it."""

import json
import os
import shutil
import subprocess
import sys

import pytest
from conftest import BENCH, ROOT

RUN = ["perfbench/run.py", "--workload", "rosenbrock.single", "--seed", "2147483901", "--seconds", "2", "--trace", "0"]


def _run(cwd, env=None):
    return subprocess.run([sys.executable, *RUN], cwd=cwd, env=env, capture_output=True, text=True, timeout=600)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")  # hides a card where there is one
    out = _run(ROOT, env)
    assert out.returncode == 2
    assert out.stdout == ""
    assert "no CUDA device" in out.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "perfbench", ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    env = dict(os.environ, PYTHONPATH="")
    out = _run(str(tmp_path), env)
    assert out.returncode != 0
    assert not out.stdout.strip()


@pytest.mark.cuda
def test_a_cell_on_the_card():
    """A short run on the card: a result line, correct, every end-to-end
    metric of the cell."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark measures the port on the card")
    out = _run(ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    from harness.manifest import Manifest

    assert set(result["metrics"]) == {m["name"] for m in Manifest(ROOT, BENCH).end_to_end("rosenbrock.single")}
    assert list(result)[-1] == "checks"
