"""Helpers of the benchmark's CPU tests: the harness on ``sys.path`` and a
copy of the benchmark with its traffic cut to sizes a CPU runs in
seconds."""

import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for path in (ROOT, BENCH):
    if path not in sys.path:
        sys.path.insert(0, path)

# (lanes, horizon) of each mix in the small copy
SMALL = {"sweep-b16384": (512, None), "single-box": (1, None)}


def copy_bench(dest):
    """A checkout-like tree at ``dest``: BENCHMARK.json and perfbench/
    (without caches), with every traffic mix cut to ``SMALL``."""
    os.makedirs(dest, exist_ok=True)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dest)
    bench = os.path.join(dest, "perfbench")
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("_cache", "__pycache__", "tests"))
    for mix, (lanes, horizon) in SMALL.items():
        path = os.path.join(bench, "traffic", f"{mix}.json")
        with open(path) as f:
            data = json.load(f)
        data["lanes"] = lanes
        if horizon is not None:
            data["size"]["horizon"] = horizon
        with open(path, "w") as f:
            json.dump(data, f)
    return dest, bench


@pytest.fixture
def small(tmp_path):
    """A ``Manifest`` of the small copy."""
    from harness.manifest import Manifest

    root, bench = copy_bench(str(tmp_path / "checkout"))
    return Manifest(root, bench)
