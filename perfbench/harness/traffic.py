"""The one generator of traffic: a closed loop of solve calls, each on
problem data and start points drawn on the device from the seed.

A mix is a data file (``traffic/<mix>.json``) with the keys

- ``kind``: ``"single"`` (``Solver.solve`` on one instance) or
  ``"batched"`` (``BatchedSolver.solve`` on ``lanes`` instances);
- ``lanes``: instances per call (1 for ``single``);
- ``size``: the sizes the configuration's ``make_problem`` takes (the
  horizon of an optimal-control problem, say), ``{}`` for none;
- ``data``: for each data leaf that the configuration's problem takes
  (its ``DATA``), ``{"uniform": [low, high], "shape": [...]}``: every
  instance's leaf of that shape, drawn uniformly; ``{}`` for a problem
  without data;
- ``start``: ``{"uniform": [low, high]}``, every variable drawn uniformly
  from the interval, or ``{"around_base": sigma}``, the configuration's
  ``base_start`` plus ``sigma`` times a standard normal draw; with
  ``"offset": <leaf>`` the instance's data leaf of that name (of the
  variables' shape) is added, so that starts keep their place against
  each instance's own optimum.

Each call draws its data leaves in the configuration's order, then its
starts.  The i-th call of a run with a given seed gets the same instances
whatever the card; every call has the same sizes, so a seed changes only
the instances and where their solves start.
"""

import torch

KINDS = ("single", "batched")
STARTS = ("uniform", "around_base")


def _interval(spec, what):
    pair = spec.get("uniform")
    if not (isinstance(pair, list) and len(pair) == 2 and pair[0] <= pair[1]):
        raise ValueError(f"{what} needs uniform: [low, high], got {spec!r}")


def validate(mix, data_names=None):
    """``mix`` if it is a valid mix (for a problem whose data leaves are
    ``data_names``, when given); raises ValueError otherwise."""
    if mix.get("kind") not in KINDS:
        raise ValueError(f"traffic kind must be one of {KINDS}, got {mix.get('kind')!r}")
    lanes = mix.get("lanes")
    if not isinstance(lanes, int) or lanes < 1 or (mix["kind"] == "single" and lanes != 1):
        raise ValueError(f"bad lanes {lanes!r} for a {mix['kind']} mix")
    data = mix.get("data", {})
    for name, spec in data.items():
        _interval(spec, f"data leaf {name!r}")
        shape = spec.get("shape")
        if not (isinstance(shape, list) and all(isinstance(k, int) and k >= 1 for k in shape)):
            raise ValueError(f"data leaf {name!r} needs a shape, a list of positive whole numbers")
    if data_names is not None and set(data) != set(data_names):
        raise ValueError(f"the mix draws data {sorted(data)}, the problem takes {sorted(data_names)}")
    start = dict(mix.get("start", {}))
    offset = start.pop("offset", None)
    if len(start) != 1 or next(iter(start)) not in STARTS:
        raise ValueError(f"start must be one of {STARTS}, got {mix.get('start')!r}")
    if "uniform" in start:
        _interval(start, "start")
    if offset is not None and offset not in data:
        raise ValueError(f"start offset {offset!r} is no data leaf of the mix")
    return mix


class Traffic:
    """The instances of the calls of one run, drawn on ``device`` from
    ``seed`` by a generator of its own.  ``base`` is the configuration's
    base start, ``data_names`` its data leaves in order."""

    def __init__(self, mix, base, data_names, seed: int, device, dtype=torch.float64):
        validate(mix, data_names)
        self.mix = mix
        self.names = tuple(data_names)
        self.base = torch.as_tensor(base, dtype=dtype, device=device)
        self.lead = (mix["lanes"],) if mix["kind"] == "batched" else ()
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(int(seed) % (1 << 64))
        self.device, self.dtype = device, dtype

    def _uniform(self, pair, shape):
        low, high = pair
        u = torch.rand(self.lead + tuple(shape), generator=self.gen, dtype=self.dtype, device=self.device)
        return low + (high - low) * u

    def draw(self):
        """The next call: ``(x0, data)``, ``x0`` (lanes, n) for a batched mix
        and (n,) for a single one, ``data`` a tuple of the leaves in the
        configuration's order, each with the same leading shape."""
        specs = self.mix.get("data", {})
        data = tuple(self._uniform(specs[name]["uniform"], specs[name]["shape"]) for name in self.names)
        start = dict(self.mix["start"])
        offset = start.pop("offset", None)
        (how, arg), = start.items()
        if how == "uniform":
            x0 = self._uniform(arg, self.base.shape)
        else:
            noise = torch.randn(self.lead + tuple(self.base.shape), generator=self.gen, dtype=self.dtype,
                                device=self.device)
            x0 = self.base + arg * noise
        if offset is not None:
            x0 = x0 + data[self.names.index(offset)]
        return x0, data
