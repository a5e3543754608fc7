#!/usr/bin/env python3
"""Medians and spreads of the end-to-end metrics of two sets of runs of
one cell, from the files their standard output went to (the last line of
each is the result).

    python3 perfbench/spreads.py set_a/*.out -- set_b/*.out

prints, for each metric, each set's median and spread (the distance
between the first and third quartile over the median, by
``statistics.quantiles(values, n=4)``), the wider spread, five times it
(a bound's size by the benchmark's rule) and the change of the second
set's median against the first's.
"""

import json
import statistics
import sys

from harness.stats import spread


def load(paths):
    out = []
    for path in paths:
        with open(path) as f:
            out.append(json.loads(f.read().strip().splitlines()[-1]))
    return out


def main(argv):
    if "--" not in argv:
        sys.exit(__doc__)
    cut = argv.index("--")
    sets = load(argv[:cut]), load(argv[cut + 1 :])
    for metric in sets[0][0]["metrics"]:
        values = [[r["metrics"][metric]["value"] for r in runs] for runs in sets]
        medians = [statistics.median(v) for v in values]
        spreads = [spread(v) for v in values]
        print(
            f"{metric}: median {medians[0]!r} / {medians[1]!r}, spread {spreads[0]:.4f} / {spreads[1]:.4f}, "
            f"widest {max(spreads):.4f}, 5x {5 * max(spreads):.4f}, second median {medians[1] / medians[0] - 1:+.4f}"
        )
    print(f"correct: {[r['correct'] for runs in sets for r in runs]}")


if __name__ == "__main__":
    main(sys.argv[1:])
