#!/usr/bin/env python3
"""The control of the comparison that decides ``correct``: a cell's traffic
solved by the program's own lower-precision path (``Params.precision =
Single``: float32 where the configuration states float64), judged as the
benchmark judges a run.  The benchmark's runs never run it.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 --seconds <s> [--precision Single|Double]

prints one JSON line per seed: the seed, ``correct`` (false is what the
control has to give) and each compared number beside its limit.  With
``--precision Double`` it reads the program as configured, over many seeds
in one process, to give a limit its lower reading.  Needs a card, as the
benchmark does.
"""

import argparse
import json
import sys
import time

from run import HERE, ROOT, card_missing


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--precision", default="Single", choices=("Single", "Double"))
    args = ap.parse_args(argv)

    from harness.cell import json_safe, run
    from harness.manifest import Manifest

    manifest = Manifest(ROOT, HERE)
    why = card_missing(manifest.cell(args.workload)["chips"])
    if why is not None:
        print(f"control: {why}", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        result, _ = run(args.workload, seed, args.seconds, False, "cuda", manifest, time.perf_counter(),
                        overrides={"precision": args.precision})
        line = {"workload": args.workload, "seed": seed, "precision": args.precision,
                "correct": result["correct"], "failed": result["failed"], "attempted": result["attempted"],
                "notes": result["notes"], "checks": result["checks"]}
        print(json.dumps(json_safe(line), allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
