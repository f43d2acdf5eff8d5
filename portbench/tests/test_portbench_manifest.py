"""BENCHMARK.json against the benchmark's rules: names, units and text
fields in their alphabets and lengths, every cell's files present, every
per-layer metric's cells reporting the end-to-end metric it moves, and
each reader found."""

import importlib
import json
import re

import pytest

from portbench import harness

MANIFEST = harness.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len(json.dumps(MANIFEST)) < 64 * 1024


def test_command_and_paths():
    assert 1 <= len(MANIFEST["command"]) <= 32
    assert all(_line(w) for w in MANIFEST["command"])
    for p in MANIFEST["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (harness.ROOT / p).is_dir()
    script = MANIFEST["command"][1]
    assert any(script.startswith(p + "/") for p in MANIFEST["paths"])


def test_names_and_units():
    names = [m["name"] for m in METRICS]
    for group in ("configs", "workloads"):
        names += [e["name"] for e in MANIFEST[group]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in METRICS:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for w in MANIFEST["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert _line(w["why"]) and w["chips"] in (1, 4)
    for c in MANIFEST["configs"]:
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


def test_entry_keys():
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])


@pytest.mark.parametrize("cell", MANIFEST["workloads"],
                         ids=lambda w: w["name"])
def test_cell_files(cell):
    conf = next(c for c in MANIFEST["configs"] if c["name"] == cell["config"])
    assert (harness.ROOT / conf["file"]).is_file()
    assert any(conf["file"].startswith(p + "/") for p in MANIFEST["paths"])
    traffic = harness.load_json(harness.BENCH / "traffic"
                                / f"{cell['traffic']}.json")
    importlib.import_module(f"portbench.jobs.{traffic['job']}")
    importlib.import_module(f"portbench.reference.{cell['config']}")
    limits = harness.load_json(harness.BENCH / "limits"
                               / f"{cell['name']}.json")
    assert limits and all(v > 0 for v in limits.values())


@pytest.mark.parametrize("cell", MANIFEST["workloads"],
                         ids=lambda w: w["name"])
def test_every_cell_reports_setup_another_and_a_layer(cell):
    e2e = [m["name"] for m in harness.reported(MANIFEST["end_to_end"],
                                                cell["name"])]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.reported(MANIFEST["per_layer"], cell["name"])


@pytest.mark.parametrize("metric", MANIFEST["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer_cells_report_what_they_move(metric):
    moves = next(m for m in MANIFEST["end_to_end"]
                 if m["name"] == metric["moves"])
    for cell in metric.get("workloads", [w["name"] for w in
                                         MANIFEST["workloads"]]):
        assert cell in moves.get("workloads", [cell])


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_every_metric_has_a_reader(metric):
    reader = importlib.import_module(
        f"portbench.metrics.{metric['name'].split('.')[0]}")
    assert callable(reader.read)


def test_layers_of_one_name():
    layers = {m["layer"] for m in MANIFEST["per_layer"]}
    assert layers == {"solver loop", "outer step", "KKT and QN", "models",
                      "kernels", "device"}


def test_four_chip_cells_within_the_share():
    four = sum(w["chips"] == 4 for w in MANIFEST["workloads"])
    assert four <= max(1, len(MANIFEST["workloads"]) // 4)
