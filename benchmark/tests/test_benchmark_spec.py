"""BENCHMARK.json against the benchmark's contract, and every cell's files
found by name."""

import os
import re

import pytest

from benchmark import harness
from benchmark.tests import tiny

SPEC = harness.load_json(os.path.join(harness.REPO_DIR, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]
PENDING = tiny.PENDING
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer",
                      "moves"}}


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert all(re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p)
               for p in SPEC["paths"])


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_have_the_contract_keys(section):
    for entry in SPEC[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") \
            else set()
        assert KEYS[section] <= set(entry) <= KEYS[section] | extra, entry


def test_names_and_units_use_the_allowed_characters():
    names = [e["name"] for s in KEYS for e in SPEC[s]]
    names += [w[k] for w in SPEC["workloads"] for k in ("config", "traffic")]
    names += [k for c in SPEC["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    units = [m["unit"] for s in ("end_to_end", "per_layer") for m in SPEC[s]]
    assert all(UNIT.match(u) for u in units), units
    for s in KEYS:
        assert len({e["name"] for e in SPEC[s]}) == len(SPEC[s])
    metrics = [m["name"] for s in ("end_to_end", "per_layer")
               for m in SPEC[s]]
    assert len(set(metrics)) == len(metrics)


def test_bounds_and_sources():
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in SPEC["end_to_end"])
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["better"] in ("lower", "higher")


@pytest.mark.parametrize("cell", CELLS + PENDING)
def test_cell_files_are_found_by_name(cell):
    c = tiny.full(cell)
    assert os.path.exists(os.path.join(harness.BENCH_DIR, "drivers",
                                       c.traffic["driver"] + ".py"))
    assert c.limits
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert callable(harness.layer_reader(m["name"]))
        assert m["moves"] in names, (cell, m["name"])


def test_every_config_is_used_and_one_chip_cells_dominate():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)


@pytest.mark.parametrize("cell", PENDING)
def test_a_pending_cell_is_not_in_the_benchmark(cell):
    assert cell not in CELLS
    pending = harness.load_json(os.path.join(harness.BENCH_DIR, "pending",
                                             cell + ".json"))
    assert KEYS["workloads"] == set(pending["workload"])
    names = {m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]}
    assert not names & {m["name"] for m in pending["end_to_end"]
                        + pending["per_layer"]}
    assert set(pending["extends"]) <= names
