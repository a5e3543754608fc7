#!/usr/bin/env python3
"""Time the LDL^T kernels of two or more checkouts of this repository on
one CUDA card, in turns, so that two versions are compared within one run.

    python3 tools/ldlt_ab.py PARENT_ROOT . . PARENT_ROOT

Each ROOT is timed in its own process (each builds its kernels from its
own sources into its own ``pygradflow_torch/_build``), in the order given.
For every kernel entry point at the main path's shapes (seeded saddle
matrices, f32) the script prints the median of 20 CUDA-event times after a
warm-up and the sha256 of the bytes of ``tril`` of the packed factor, one
JSON object per root, with the card's name and power limit.  Equal digests
of two roots mean the same bits; a kernel whose digest differs between two
runs of one root is not deterministic.
"""

import json
import os
import subprocess
import sys

SHAPES = [
    ("ldlt_factor_rl", (644,)),
    ("ldlt_factor_rl", (514,)),
    ("ldlt_factor_rl", (512,)),
    ("ldlt_factor_rl", (1025,)),
    ("ldlt_factor_ll", (1284,)),
    ("ldlt_factor_ll", (1538,)),
    ("ldlt_factor_rl_batched", (128, 324)),
    ("ldlt_factor_rl_batched", (128, 256)),
]

CHILD = r"""
import hashlib, json, sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
from pygradflow_torch.linalg import ldlt_kernels as lk

def saddle(rng, n):
    m = n * 2 // 5
    k = n - m
    h = rng.standard_normal((k, k))
    j = rng.standard_normal((m, k))
    return np.block([[h @ h.T + k * np.eye(k), j.T], [j, -0.1 * np.eye(m)]])

def ms(fn, runs=20):
    fn()
    times = []
    for _ in range(runs):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record(); fn(); e.record(); e.synchronize()
        times.append(s.elapsed_time(e))
    return sorted(times)[runs // 2]

rng = np.random.default_rng(7)
out, sha = {}, {}
for name, shape in json.loads(sys.argv[2]):
    *lead, n = shape
    a = np.stack([saddle(rng, n) for _ in range(lead[0])]) if lead else saddle(rng, n)
    a32 = torch.tensor(a, dtype=torch.float32, device="cuda")
    fn = getattr(lk, name)
    key = f"{name} {tuple(shape)}"
    out[key] = ms(lambda: fn(a32))
    sha[key] = hashlib.sha256(torch.tril(fn(a32)).cpu().numpy().tobytes()).hexdigest()[:16]
print(json.dumps({"ms": out, "sha256": sha}))
"""


def main(roots):
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    for root in roots:
        root = os.path.abspath(root)
        proc = subprocess.run(
            [sys.executable, "-c", CHILD, root, json.dumps(SHAPES)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            print(proc.stderr, file=sys.stderr)
            return proc.returncode
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"root": root, "card": card, **result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
