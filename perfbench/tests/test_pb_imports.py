"""What the benchmark may load: no JAX and no JAX package, compared by the
whole top-level name; nothing of the JAX package's benchmarks or the
repo's smoke script, tools or tests."""

import ast
import os
import subprocess
import sys

import pytest
from conftest import BENCH, ROOT

from harness.imports import FORBIDDEN, forbidden_loaded

# top-level names the harness may not import: JAX's, and the repo's own
# benchmarks, smoke script, tools and tests
NOT_READ = FORBIDDEN | {"benchmarks", "bench", "chip_smoke", "tools", "tests", "__graft_entry__"}


def _sources(sub=""):
    out = []
    for dirpath, dirnames, filenames in os.walk(os.path.join(BENCH, sub)):
        dirnames[:] = [d for d in dirnames if d not in ("_cache", "__pycache__", "tests")]
        out += [os.path.join(dirpath, f) for f in filenames if f.endswith(".py")]
    return sorted(out)


def _top_level_imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_forbidden_names_compare_whole():
    assert forbidden_loaded(["pygradflow_torch", "pygradflow_torch.linalg", "jaxtyping", "flaxen"]) == []
    assert forbidden_loaded(["jax.numpy", "pygradflow_tpu.solver", "numpy"]) == ["jax", "pygradflow_tpu"]
    assert forbidden_loaded(["jaxlib", "flax.linen"]) == ["flax", "jaxlib"]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, BENCH))
def test_harness_imports(path):
    names = set(_top_level_imports(path))
    assert not names & NOT_READ, names & NOT_READ
    if os.path.relpath(path, BENCH).startswith("reference"):
        assert "pygradflow_torch" not in names


def test_a_run_loads_no_jax():
    """A whole (small, CPU) run in a fresh process leaves no forbidden
    module in ``sys.modules``."""
    code = (
        "import sys, time; sys.path[:0] = [%r, %r, %r];"
        "from conftest import copy_bench; from harness.manifest import Manifest; from harness.cell import run;"
        "from harness.imports import forbidden_loaded; import tempfile;"
        "root, bench = copy_bench(tempfile.mkdtemp());"
        "run('rosenbrock.single', 3, 0.2, False, 'cpu', Manifest(root, bench));"
        "print('LOADED', forbidden_loaded())"
    ) % (ROOT, BENCH, os.path.join(BENCH, "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout
