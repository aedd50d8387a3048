"""BENCHMARK.json against the benchmark's contract, and every file it names
found by name."""
import json
import os
import re

import pytest

from portbench import correctness
from portbench.manifest import Manifest, reader
from portbench.tests.tiny import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
CELLS_MAX, RUNS_PER_CELL, BUDGET_S = 24, 14, 43200


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys_and_command(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert bench["paths"] == ["portbench"]
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) <= 64 * 1024


def test_run_seconds_fits_the_full_check_with_24_cells(bench):
    s = bench["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    total = (2 + RUNS_PER_CELL * CELLS_MAX) * (s + 60) + CELLS_MAX * 2 * 90 + 1200
    assert total <= BUDGET_S


def test_names_units_and_texts(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("portbench/") and os.path.exists(os.path.join(REPO, c["file"]))
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert TEXT.match(w["why"]) and w["chips"] in (1, 4)
        names.append(w["name"])
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                      "higher")
            names.append(m["name"])
    assert len(names) == len(set(names))
    assert len({(w["config"], w["traffic"]) for w in bench["workloads"]}) == len(bench["workloads"])


def test_end_to_end_bounds(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["name"] in ("frames_per_s", "setup_s")  # what the harness measures
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


def test_every_moves_names_an_end_to_end_metric_reported_in_the_same_cells(bench):
    cells = [w["name"] for w in bench["workloads"]]
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and TEXT.match(m["layer"])
        assert set(m.get("workloads", cells)) <= e2e[m["moves"]]
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for cell in cells:  # setup_s, one other end-to-end and one per-layer metric
        reported = [n for n, ws in e2e.items() if cell in ws]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(cell in m.get("workloads", cells) for m in bench["per_layer"])


def test_every_configuration_has_a_cell_and_every_file_is_found(bench):
    man = Manifest.load(REPO)
    assert {c["name"] for c in bench["configs"]} == {w["config"] for w in bench["workloads"]}
    for w in bench["workloads"]:
        config = man.config(w["config"])
        assert config["name"] == w["config"]
        assert man.traffic(w["traffic"])["name"] == w["traffic"]
        assert set(man.limits(w["name"])) == set(correctness.NUMBERS)
    for m in bench["per_layer"]:
        assert callable(reader(m["name"]))


def test_reduced_lists_exactly_the_keys_changed_from_the_source(bench):
    man = Manifest.load(REPO)
    for c in bench["configs"]:
        config = man.config(c["name"])
        assert sorted(config["reduced"]) == sorted(c["reduced"])
        for key in c["reduced"]:  # a depth cut, never a width
            assert key.endswith("num_iters")
