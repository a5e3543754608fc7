"""MPS LP benchmark runner (counterpart of
``pygradflow_tpu/runners/mps_runner.py``): linear programs read from MPS
files, solved as QPs with zero Hessian.

Run: ``python -m pygradflow_torch.runners.mps_runner --dir <dir-of-mps-files>``
"""

import glob
import os

import numpy as np

from ..problem import QuadraticProblem
from .instance import Instance
from .mps import parse_mps
from .runner import Runner


class MPSProblem(QuadraticProblem):
    def __init__(self, data):
        n = data.c.shape[0]
        super().__init__(
            Q=np.zeros((n, n)),
            c=data.c,
            A=data.A,
            cons_lb=data.cons_lb,
            cons_ub=data.cons_ub,
            var_lb=data.var_lb,
            var_ub=data.var_ub,
        )
        self.obj_offset = data.obj_offset


class MPSInstance(Instance):
    def __init__(self, path):
        self.path = path
        self.data = parse_mps(path)
        name = self.data.name or os.path.splitext(os.path.basename(path))[0]
        (m, n) = self.data.A.shape
        super().__init__(name, n, m)

    def problem(self):
        return MPSProblem(self.data)

    def x0(self):
        return 0.0


class MPSRunner(Runner):
    def __init__(self):
        super().__init__(name="mps")

    def parser(self):
        parser = super().parser()
        parser.add_argument("--dir", type=str, required=True)
        return parser

    def get_instances(self, args):
        files = sorted(glob.glob(os.path.join(args.dir, "*.mps")))
        return [MPSInstance(f) for f in files]


if __name__ == "__main__":
    MPSRunner().main()
