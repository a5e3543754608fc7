"""BENCHMARK.json keeps to the benchmark's contract, and every name in it
finds its files."""

import json
import os
import re

import pytest
from conftest import BENCH, ROOT

from harness.manifest import Manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    DATA = json.load(f)


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(DATA) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert isinstance(DATA["run_seconds"], int) and 1 <= DATA["run_seconds"] <= 51


def test_command_and_paths():
    assert 1 <= len(DATA["command"]) <= 32 and all(_line(w) for w in DATA["command"])
    assert 1 <= len(DATA["paths"]) <= 16
    for p in DATA["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    for word in DATA["command"]:
        if word.endswith(".py"):
            assert any(word.startswith(p + "/") for p in DATA["paths"]), word


def test_every_file_under_paths_is_named_from_name_characters():
    for p in DATA["paths"]:
        for dirpath, dirnames, filenames in os.walk(os.path.join(ROOT, p)):
            dirnames[:] = [d for d in dirnames if d not in ("_cache", "__pycache__")]
            for f in filenames:
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
                assert PATH.match(rel), rel


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_keep_to_their_characters(section):
    names = [entry["name"] for entry in DATA[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names), names


def test_configs():
    used = {c["config"] for c in DATA["workloads"]}
    files = set()
    assert 1 <= len(DATA["configs"]) <= 24
    for c in DATA["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in DATA["paths"])
        assert os.path.isfile(os.path.join(ROOT, c["file"])) and c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        with open(os.path.join(ROOT, c["file"])) as f:
            numbers = json.load(f)
        assert numbers["name"] == c["name"] and numbers["reduced"] == c["reduced"] and numbers["source"] == c["source"]


def test_workloads():
    cells = DATA["workloads"]
    assert 1 <= len(cells) <= 24
    pairs = [(c["config"], c["traffic"]) for c in cells]
    assert len(pairs) == len(set(pairs))
    four = sum(c["chips"] == 4 for c in cells)
    assert four <= max(1, len(cells) // 4)
    for c in cells:
        assert set(c) == {"name", "config", "traffic", "chips", "why"}
        assert c["chips"] in (1, 4) and _line(c["why"])
        assert NAME.match(c["config"]) and NAME.match(c["traffic"])


def test_metrics():
    e2e, layers = DATA["end_to_end"], DATA["per_layer"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(layers) <= 128
    assert "setup_s" in {m["name"] for m in e2e}
    cells = {c["name"] for c in DATA["workloads"]}
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in layers:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and _line(m["layer"])
        assert m["moves"] in {e["name"] for e in e2e}
    for m in e2e + layers:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        if m["unit"] == "%" and m["name"].endswith("_roofline"):
            assert m["better"] == "higher"


def test_every_cell_reports_what_its_metrics_move():
    manifest = Manifest(ROOT, BENCH)
    for cell in DATA["workloads"]:
        name = cell["name"]
        e2e = {m["name"] for m in manifest.end_to_end(name)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = manifest.per_layer(name)
        assert layers, name
        for m in layers:
            assert m["moves"] in e2e, (name, m["name"])


def test_every_name_finds_its_files():
    manifest = Manifest(ROOT, BENCH)
    for cell in DATA["workloads"]:
        manifest.traffic(cell["traffic"])
        manifest.limits(cell["name"])
        manifest.config_numbers(cell["config"])
        assert os.path.isfile(manifest.path("configs", cell["config"] + ".py"))
        assert os.path.isfile(manifest.path("reference", cell["config"] + ".py"))
    for m in DATA["end_to_end"] + DATA["per_layer"]:
        assert callable(manifest.metric_reader(m["name"]).read)


def test_check_budget_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (DATA["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
