#!/usr/bin/env python3
"""Benchmark of pygradflow_torch on CUDA cards.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs the cell named in BENCHMARK.json (from the root of a checkout) and
prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` and, last, ``checks``:
each number that decided ``correct`` beside its limit, which also end
standard error.  Without a card, or with fewer cards than the cell asks
for, it exits 2 and prints no result; if the JAX package or JAX was
loaded, it exits 3 and prints no result.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, "_cache")
# build and kernel caches at fixed paths inside the checkout; the port
# builds its own kernels into pygradflow_torch/_build/
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["USE_FLAX"] = "0"
# one process with few threads: the solves run on the card, and idle host
# thread pools only take cores from the thread that launches them
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
for path in (ROOT, HERE):
    if path not in sys.path:
        sys.path.insert(0, path)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def card_missing(chips):
    """Why the cards the cell needs are not there, or None."""
    import torch

    if not torch.cuda.is_available():
        return "no CUDA device: the benchmark measures pygradflow_torch on the card and has no CPU fallback"
    if torch.cuda.device_count() < chips:
        return f"the cell needs {chips} CUDA devices, {torch.cuda.device_count()} visible"
    return None


def main(argv=None):
    args = parse(argv)
    from harness.cell import json_safe, run
    from harness.imports import forbidden_loaded
    from harness.manifest import Manifest

    manifest = Manifest(ROOT, HERE)
    spec = manifest.cell(args.workload)
    why = card_missing(spec["chips"])
    if why is not None:
        print(f"perfbench: {why}", file=sys.stderr)
        return 2
    result, lines = run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", manifest, T_PROCESS)
    loaded = forbidden_loaded()
    if loaded:
        print(f"perfbench: the run loaded {', '.join(loaded)}; no result", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(json_safe(result), allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
