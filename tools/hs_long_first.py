"""The Hock-Schittkowski sweep of ``pygradflow_torch.runners.hs_runner``
with the two specs that run to the iteration limit, hs104 and hs106
(10,000 iterations each), dispatched first.  Under ``--parallel N`` an
instance starts when a child is free; in the suite's order these two come
last, and the sweep then waits for them alone.  Every row is the runner's
own; only the order in which the instances start differs.

    python3 -c "from tools.hs_long_first import LongFirstHSRunner; LongFirstHSRunner().main()" \\
        --device cuda --parallel 4 --output DIR

(run from the root of the repository; ``chip_smoke.py`` phase 12 (e)).
"""

from pygradflow_torch.runners.hs_runner import HSRunner

LONG = ("hs104", "hs106")


class LongFirstHSRunner(HSRunner):
    def get_instances(self, args):
        return sorted(super().get_instances(args), key=lambda instance: instance.name not in LONG)
