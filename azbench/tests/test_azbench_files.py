"""BENCHMARK.json and the files it names: present, well formed, and each
configuration the program's own at the published widths."""

import dataclasses
import json
import re

import pytest

from alpha_zero_tpu_torch import config as config_lib
from azbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["azbench"]
    assert BENCH["command"] == ["python3", "azbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    # A full check at 24 cells must fit its time.
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert cells <= 24 and len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_valid(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_fields(metric):
    allowed = {"name", "unit", "better", "source", "workloads"}
    if metric in BENCH["end_to_end"]:
        allowed |= {"bound"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        allowed |= {"layer", "moves"}
        assert 0 < len(metric["layer"]) <= 200 and "\n" not in metric["layer"]
    assert set(metric) <= allowed
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    assert metric["source"] in SOURCES


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_moves_one_reported_metric(metric):
    """Each per-layer metric names one end-to-end metric that every cell
    it lists reports, and has a reader under ``metrics/``."""
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert metric["moves"] in e2e and metric["moves"] != "setup_s"
    cells = {w["name"] for w in BENCH["workloads"]}
    reporting = set(e2e[metric["moves"]].get("workloads", cells))
    assert metric["workloads"] and set(metric["workloads"]) <= reporting & cells
    reader = harness.load_module(harness.HERE / "metrics" / f"{metric['name']}.py")
    assert reader.read(None) is None and reader.read({}) is None


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for cell in BENCH["workloads"]:
        e2e = [m["name"] for m in BENCH["end_to_end"] if cell["name"] in m.get("workloads", [cell["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(cell["name"] in m["workloads"] for m in BENCH["per_layer"])
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].split(" ")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1 and 0 < len(cell["why"]) <= 200
    assert NAME.match(cell["config"]) and NAME.match(cell["traffic"])
    run = harness.open_run(cell["name"], 1, 1.0, False, None, 0.0)
    assert (harness.HERE / "entries" / f"{run.traffic['entry']}.py").exists()
    assert set(run.cell["limits"]) == {"search_pi_gap", "policy_tv", "value_mae"}
    assert run.cell["check"]["lanes"] >= 2
    assert [w for w in BENCH["workloads"] if (w["config"], w["traffic"])
            == (cell["config"], cell["traffic"])] == [cell]


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_is_the_programs_at_published_widths(entry):
    """The file's env, network and search settings are the program's own
    config of that name; only the batch of games may differ, and where it
    does from the program's, it is listed as reduced or assumed."""
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert entry["file"] == f"azbench/configs/{entry['name']}.json"
    data = harness.load_json(harness.ROOT / entry["file"])
    assert data["source"] == entry["source"]
    program = config_lib.get_config(data["program_config"])
    for group in ("env", "network", "search"):
        want = dataclasses.asdict(getattr(program, group))
        if group == "env":
            want["max_steps"] = program.env.resolved_max_steps()
        assert {k: want[k] for k in data[group]} == data[group], group
    assert set(entry["reduced"]) == set(data["reduced"])
    if data["selfplay_batch_size"] != program.parallel.selfplay_batch_size:
        assert "selfplay_batch_size" in {**data["reduced"], **data["assumed"]}
    if "selfplay_batch_size" in data["reduced"]:
        assert data["selfplay_batch_size"] < program.parallel.selfplay_batch_size
