"""Hock-Schittkowski benchmark runner (counterpart of
``pygradflow_tpu/runners/hs_runner.py``): the suite of ``runners/hs.py``.

Run: ``python -m pygradflow_torch.runners.hs_runner --no_output`` (on the
card; ``--device cpu`` on the CPU)
"""

import numpy as np

from .hs import HS_SPECS
from .instance import Instance
from .runner import Runner


class HSInstance(Instance):
    def __init__(self, spec):
        self.spec = spec
        prob = spec.problem()
        super().__init__(spec.name, prob.num_vars, prob.num_cons)

    def problem(self):
        return self.spec.problem()

    def x0(self):
        return np.asarray(self.spec.x0)

    def y0(self):
        return 0.0


class HSRunner(Runner):
    def __init__(self):
        super().__init__(name="hs")

    def get_instances(self, args):
        return [HSInstance(spec) for spec in HS_SPECS]


if __name__ == "__main__":
    HSRunner().main()
