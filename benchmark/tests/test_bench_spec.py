"""BENCHMARK.json against the benchmark's contract, and each part of a
cell found by its name."""

import json
import re

import pytest

from benchmark.harness import spec

from .conftest import with_fast_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"][:2] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_units_and_keys():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for group in (BENCH["configs"], BENCH["workloads"], metrics):
        names = [e["name"] for e in group]
        assert len(set(names)) == len(names)
        assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert set(m["workloads"]) <= set(CELLS)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_setup_s_in_every_cell():
    names = {m["name"] for m in BENCH["end_to_end"] if "workloads" not in m}
    assert {"setup_s", "target_frames_per_s"} <= names


def test_check_budget():
    """A full check of 24 cells fits its time."""
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_parts_found_by_name(cell):
    c = spec.Cell(cell)
    assert c.config["name"] == c.workload["config"]
    assert callable(c.entry.build) and callable(c.entry.compare)
    assert set(c.limits["check"]["limits"]) >= {"h_gap_median_px", "failed"}
    e2e = [m["name"] for m, _ in c.metrics(False)]
    assert e2e == [m["name"] for m in BENCH["end_to_end"]]
    layer = [m["name"] for m, reader in c.metrics(True)
             if callable(reader.read)]
    assert layer == [m["name"] for m in BENCH["per_layer"]
                     if cell in m["workloads"]]


def test_pending_cell_parts_found_by_name():
    """The speed tier's files, kept for a later PR to list: its
    configuration, limits and its metrics' readers load."""
    c = spec.Cell("woft_fast-720p-online", bench=with_fast_cell(BENCH))
    assert c.config["flow"]["corr_impl"] == "local"
    assert c.config["control"] == "reference:int8"
    assert {"h_gap_px", "h_gap_median_px"} <= set(c.limits["check"]["limits"])
    reader = spec.load_module(spec.HERE / "metrics" / "local_corr_roofline.py",
                              "local_corr_roofline")
    assert callable(reader.read)


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_states_what_runs(config):
    cfg = spec.load_json(spec.ROOT / config["file"])
    assert cfg["name"] == config["name"]
    assert cfg["reduced"] == config["reduced"] == []
    assert cfg["number_format"] in ("float32", "bf16")
    assert (spec.ROOT / cfg["program_config"]).exists()
    assert (spec.ROOT / cfg["weights"]).exists()
