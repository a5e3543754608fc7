"""The port alone on the Hock-Schittkowski specs that converge to their book
optimum: ``tests/test_runners.py``'s ``HS_QUICK`` list with that test's
tolerances (``test_hs_known_optimum``)."""

import numpy as np
import pytest

from pygradflow_torch import Params, Solver
from pygradflow_torch.runners.hs import HS_BY_NAME
from tests.test_runners import HS_QUICK

from .torch_parity import numpy

# hs3 is nearly flat in x1; hs26/46/47/49/50 have degenerate optima, where
# the 1e-6 KKT tolerance admits points ~1e-2 from the minimizer
DEGENERATE = ("hs3", "hs26", "hs46", "hs47", "hs49", "hs50")


@pytest.mark.parametrize("name", HS_QUICK)
def test_hs_known_optimum(name):
    spec = HS_BY_NAME[name]
    result = Solver(spec.problem(), Params(), device="cpu").solve(spec.x0)
    assert result.success, f"{name}: {result.status}"
    if spec.x_opt is not None:
        atol = 1e-1 if name in DEGENERATE else 1e-4
        np.testing.assert_allclose(numpy(result.x), spec.x_opt, atol=atol)
    if spec.f_opt is not None:
        assert abs(float(spec.problem().obj(result.x)) - spec.f_opt) < 1e-5
