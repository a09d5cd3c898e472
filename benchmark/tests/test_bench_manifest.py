"""BENCHMARK.json against the benchmark's contract: names, units, keys and
counts, and every cell, configuration, mix, limit and per-layer metric found
by name in its own file."""

from __future__ import annotations

import importlib.util
import json
import os
import re

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(manifest["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in manifest["paths"])
    assert not any(p.endswith("_torch") for p in manifest["paths"])
    assert 1 <= len(manifest["command"]) <= 32 and all(_line(w) for w in manifest["command"])
    assert not any(w.startswith("/") or ".." in w for w in manifest["command"])
    assert isinstance(manifest["run_seconds"], int) and 1 <= manifest["run_seconds"] <= 51


def test_full_check_fits_with_24_cells(manifest):
    runs = 2 + 14 * 24
    assert runs * (manifest["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_entry_keys(manifest):
    names = set()
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith(tuple(p + "/" for p in manifest["paths"]))
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4) and _line(w["why"])
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock") and _line(m["layer"])
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.add(m["name"])
    assert len(names) == len(manifest["end_to_end"]) + len(manifest["per_layer"])
    for key in ("configs", "workloads"):
        assert len({e["name"] for e in manifest[key]}) == len(manifest[key])
    assert len({(w["config"], w["traffic"]) for w in manifest["workloads"]}) == len(manifest["workloads"])
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in manifest["end_to_end"])
    assert 1 <= len(manifest["workloads"]) <= 24 and 1 <= len(manifest["configs"]) <= 24


def test_every_cell_reports_what_it_must(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    four = sum(w["chips"] == 4 for w in manifest["workloads"])
    assert four <= max(1, len(manifest["workloads"]) // 4)
    used = set()
    for w in manifest["workloads"]:
        used.add(w["config"])
        mine = [m for m in manifest["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        layer = [m for m in manifest["per_layer"] if w["name"] in m.get("workloads", [w["name"]])]
        assert layer
        for m in layer:
            assert w["name"] in e2e[m["moves"]].get("workloads", [w["name"]])
    assert used == {c["name"] for c in manifest["configs"]}
    layers = {}
    for m in manifest["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for m in manifest["per_layer"]:
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"


def test_each_piece_found_by_name(manifest):
    for c in manifest["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and set(cfg["reduced"]) == set(c["reduced"])
        assert os.path.exists(os.path.join(os.path.dirname(os.path.join(ROOT, c["file"])), cfg["settings"]))
    for w in manifest["workloads"]:
        with open(os.path.join(BENCH, "traffic", w["traffic"] + ".json")) as f:
            driver = json.load(f)["driver"]
        assert NAME.match(driver) and os.path.exists(os.path.join(BENCH, "drivers", driver + ".py"))
        from benchmark.drivers import Driver, load

        assert issubclass(load(driver), Driver)
        with open(os.path.join(BENCH, "limits", w["name"] + ".json")) as f:
            limits = json.load(f)["limits"]
        assert limits and all(v > 0 for v in limits.values())
    for m in manifest["per_layer"]:
        path = os.path.join(BENCH, "metrics", m["name"] + ".py")
        spec = importlib.util.spec_from_file_location("metric_" + m["name"], path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert callable(mod.read)


def test_cells_load(manifest):
    from benchmark.run import Cell

    for w in manifest["workloads"]:
        cell = Cell(w["name"])
        assert cell.config["GIFT"]["maxFeatures"] == 40
        assert [m["name"] for m in cell.metrics("end_to_end")][-1] == "setup_s"
