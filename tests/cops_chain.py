"""The benchmark's ``cops-chain`` configuration for the tests: its problem,
its plain reference and the limits of its cell, loaded from ``perfbench/``
(put on ``sys.path`` as ``perfbench/tests/conftest.py`` puts it), and
seeded instances drawn as its traffic draws them."""

import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "perfbench")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from harness.cell import make_params  # noqa: E402
from harness.manifest import Manifest  # noqa: E402

MANIFEST = Manifest(ROOT, BENCH)
CELL = "cops-chain.single-nh200"
NUMBERS = MANIFEST.config_numbers("cops-chain")
CONFIG = MANIFEST.config_module("cops-chain")
REFERENCE = MANIFEST.reference("cops-chain")
LIMITS = MANIFEST.limits(CELL)["limits"]


def problem(nh, device="cpu", dtype=torch.float64):
    return CONFIG.make_problem(NUMBERS, {"nh": nh}, device, dtype)


def params(**overrides):
    """The configuration's ``Params``, with ``overrides`` by field name."""
    return make_params(NUMBERS, overrides)


def instances(prob, seed, count):
    """``count`` instances ``(delta, x0)`` as numpy arrays: delta from
    U(-0.5, 0.5)^3 and the start COPS's guess plus 0.02 N(0, 1), as the
    cell's traffic draws them."""
    rng = np.random.default_rng(seed)
    base = CONFIG.base_start(prob)
    return [(rng.uniform(-0.5, 0.5, 3), base + 0.02 * rng.standard_normal(base.shape)) for _ in range(count)]


def solve(solver, prob, delta, x0):
    """One solve of the instance ``delta``, posed as the benchmark poses it:
    the problem's data tensor overwritten in place."""
    prob.example_data[0].copy_(torch.as_tensor(delta, dtype=prob.example_data[0].dtype))
    return solver.solve(torch.as_tensor(x0, device=prob.example_data[0].device, dtype=prob.example_data[0].dtype))
