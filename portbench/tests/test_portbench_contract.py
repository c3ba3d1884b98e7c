"""BENCHMARK.json and the files it names, against the benchmark's rules."""

import json
import os
import re

import pytest

from portbench import common, drivers
from portbench.metrics import reader

BENCH = common.load_json("BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"] and BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names), names


def test_configs_files_and_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and os.path.exists(os.path.join(common.ROOT, c["file"]))
        assert c["source"].startswith("https://") and "\n" not in c["source"] and len(c["source"]) <= 200
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["why"]) <= 200


def test_workloads_name_their_files_and_one_chip():
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["traffic"]) and (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        traffic = common.load_json(f"portbench/traffic/{w['traffic']}.json")
        drivers.load(traffic["kind"])
        assert os.path.exists(os.path.join(common.HERE, "limits", f"{w['name']}.json"))
    assert {c for c, _ in pairs} == configs


def test_metrics_fields_units_and_sources():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in {"host_clock", "device_trace"} and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in SOURCES and m["moves"] in e2e and "\n" not in m["layer"]
        reader(m["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in BENCH["workloads"]:
        cell = w["name"]
        e2e = [m for m in BENCH["end_to_end"] if cell in m.get("workloads", [cell])]
        layer = [m for m in BENCH["per_layer"] if cell in m.get("workloads", [cell])]
        assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2 and layer
        for m in layer:  # each reports the end-to-end metric it moves
            assert m["moves"] in [e["name"] for e in e2e]


def test_files_under_paths_are_named_from_name_characters():
    for dirpath, _, files in os.walk(common.HERE):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), common.ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
