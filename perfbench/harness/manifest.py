"""``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, one traffic mix, one
per-layer metric or one cell sits in a file of its own, found by the name
that ``BENCHMARK.json`` gives:

- ``configs/<config>.json``: the numbers of the deployment (problem
  constants, the solver's ``Params``, ``assumed``, ``reduced``), and
  ``configs/<config>.py`` beside it: its problem as a
  ``pygradflow_torch.Problem`` subclass (``make_problem``, ``base_start``);
- ``reference/<config>.py``: the plain reference (``residuals``);
- ``traffic/<mix>.json``: the parameters that ``harness.traffic`` reads;
- ``metrics/<metric>.py``: the reader of a per-layer metric (``read``);
- ``limits/<cell>.json``: the limits of the numbers that decide ``correct``.
"""

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # perfbench/
ROOT = os.path.dirname(HERE)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path, name):
    """The Python file ``path`` as a module called ``name`` (file names may
    hold ``-`` and ``.``, which ``import`` cannot)."""
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Manifest:
    """``BENCHMARK.json`` of the checkout at ``root``, with the files of
    ``bench`` (the harness's folder, ``perfbench/`` by default)."""

    def __init__(self, root=ROOT, bench=HERE):
        self.root, self.bench = root, bench
        self.data = load_json(os.path.join(root, "BENCHMARK.json"))

    def cell(self, name):
        for cell in self.data["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name):
        for config in self.data["configs"]:
            if config["name"] == name:
                return config
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def path(self, *parts):
        return os.path.join(self.bench, *parts)

    def config_numbers(self, name):
        return load_json(os.path.join(self.root, self.config(name)["file"]))

    def config_module(self, name):
        return load_module(self.path("configs", f"{name}.py"), f"perfbench_config_{name}")

    def reference(self, name):
        return load_module(self.path("reference", f"{name}.py"), f"perfbench_reference_{name}")

    def traffic(self, name):
        return load_json(self.path("traffic", f"{name}.json"))

    def limits(self, cell):
        return load_json(self.path("limits", f"{cell}.json"))

    def metric_reader(self, name):
        return load_module(self.path("metrics", f"{name}.py"), f"perfbench_metric_{name}")

    def reports(self, cell, metric):
        """Whether ``cell`` reports the end-to-end ``metric``: one without
        a ``workloads`` key is reported everywhere."""
        return "workloads" not in metric or cell in metric["workloads"]

    def end_to_end(self, cell):
        return [m for m in self.data["end_to_end"] if self.reports(cell, m)]

    def per_layer(self, cell):
        """The per-layer metrics of ``cell``: those that list it, and those
        without a list whose ``moves`` metric the cell reports."""
        e2e = {m["name"] for m in self.end_to_end(cell)}
        out = []
        for m in self.data["per_layer"]:
            if "workloads" in m:
                if cell in m["workloads"]:
                    out.append(m)
            elif m["moves"] in e2e:
                out.append(m)
        return out
