"""The traffic generator: the same seed gives the same instances."""

import pytest
import torch
from conftest import BENCH, ROOT

from harness.manifest import Manifest
from harness.traffic import Traffic, validate

MANIFEST = Manifest(ROOT, BENCH)
BASE = torch.linspace(0.0, 3.0, 11, dtype=torch.float64)
SHIFT = {"shift": {"uniform": [-1.0, 1.0], "shape": [11]}}


def _mix(**kw):
    return {"kind": "batched", "lanes": 4096, "size": {}, "start": {"uniform": [-1.5, 1.5]}, **kw}


@pytest.mark.parametrize("mix", ["sweep-b16384", "single-box"])
def test_same_seed_same_instances(mix):
    data = MANIFEST.traffic(mix)
    names = MANIFEST.config_module("rosenbrock").DATA
    base = torch.zeros(2, dtype=torch.float64)
    seed = 2**31 + 12345  # a run's seed may pass 32 signed bits
    a, b = Traffic(data, base, names, seed, "cpu"), Traffic(data, base, names, seed, "cpu")
    c = Traffic(data, base, names, seed + 1, "cpu")
    lead = (data["lanes"],) if data["kind"] == "batched" else ()
    for _ in range(3):
        (xa, da), (xb, db), (xc, dc) = a.draw(), b.draw(), c.draw()
        assert torch.equal(xa, xb) and not torch.equal(xa, xc)
        assert all(torch.equal(p, q) for p, q in zip(da, db)) and not torch.equal(da[0], dc[0])
        assert tuple(xa.shape) == lead + (2,) and xa.dtype == torch.float64
        assert len(da) == len(names) and tuple(da[0].shape) == lead + (2,)


def test_each_call_draws_anew():
    s = Traffic(MANIFEST.traffic("sweep-b16384"), torch.zeros(2), ("shift",), 7, "cpu")
    (x1, d1), (x2, d2) = s.draw(), s.draw()
    assert not torch.equal(x1, x2) and not torch.equal(d1[0], d2[0])


def test_every_lane_its_own_instance():
    _, (shift,) = Traffic(MANIFEST.traffic("sweep-b16384"), torch.zeros(2), ("shift",), 11, "cpu").draw()
    assert torch.unique(shift, dim=0).shape[0] == shift.shape[0]


def test_uniform_around_base_and_offset():
    box, _ = Traffic(_mix(), BASE, (), 3, "cpu").draw()
    assert box.min() >= -1.5 and box.max() <= 1.5 and abs(float(box.mean())) < 0.05
    near, _ = Traffic(_mix(start={"around_base": 0.02}), BASE, (), 3, "cpu").draw()
    assert abs(float((near - BASE).std()) - 0.02) < 1e-3
    x0, (shift,) = Traffic(_mix(data=SHIFT, start={"uniform": [-1.5, 1.5], "offset": "shift"}), BASE, ("shift",), 3,
                           "cpu").draw()
    rel = x0 - shift
    assert shift.min() >= -1.0 and shift.max() <= 1.0
    assert rel.min() >= -1.5 - 1e-12 and rel.max() <= 1.5 + 1e-12 and abs(float(rel.mean())) < 0.05


@pytest.mark.parametrize(
    "mix, names",
    [
        ({"kind": "open", "lanes": 1, "start": {"uniform": [0, 1]}}, None),
        ({"kind": "single", "lanes": 2, "start": {"uniform": [0, 1]}}, None),
        ({"kind": "batched", "lanes": 0, "start": {"uniform": [0, 1]}}, None),
        ({"kind": "batched", "lanes": 8, "start": {"gaussian": 1.0}}, None),
        (_mix(start={"uniform": [0, 1], "offset": "shift"}), None),
        (_mix(data={"shift": {"uniform": [1, 0], "shape": [2]}}), None),
        (_mix(data={"shift": {"uniform": [0, 1]}}), None),
        (_mix(data=SHIFT), ()),
        (_mix(), ("shift",)),
    ],
)
def test_bad_mixes_are_refused(mix, names):
    with pytest.raises(ValueError):
        validate(mix, names)
