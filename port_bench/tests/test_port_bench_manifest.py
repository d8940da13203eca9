"""The manifest parses, keeps to the benchmark's contract, and every
configuration, traffic mix, limits file and per-layer reader it names is
found by name."""
from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from port_bench import harness

ROOT = harness.ROOT
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def test_keys_and_limits():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for p in MANIFEST["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and ".." not in p
        assert (ROOT / p).is_dir()
    assert len(MANIFEST["command"]) <= 32
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_names_and_units():
    names = ([c["name"] for c in MANIFEST["configs"]] + CELLS
             + [m["name"] for m in MANIFEST["end_to_end"]]
             + [m["name"] for m in MANIFEST["per_layer"]])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in MANIFEST["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for c in MANIFEST["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["source"]) <= 200 and "\n" not in c["source"]
        assert 1 <= len(c["why"]) <= 200
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name(cell):
    c = harness.load_cell(cell)
    assert harness.driver(c.traffic["kind"]).Job
    assert (harness.PKG / "limits" / f"{cell}.json").exists()
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e


@pytest.mark.parametrize("metric", [m["name"] for m in MANIFEST["per_layer"]])
def test_reader_found_by_name_and_silent_elsewhere(metric):
    read = harness.reader(metric)
    other = harness.Record("no such kind", 1.0, {}, {}, None)
    assert read(other) is None


def test_configs_are_files_of_their_own():
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))
    for f in files:
        assert f.startswith(MANIFEST["paths"][0] + "/")
        assert Path(ROOT / f).exists()


def test_serve_tail_reads_the_requests_95th_percentile_in_ms():
    read = harness.reader("serve.p95_ms")
    spans = {"request": [0.001 * (i + 1) for i in range(100)]}
    record = harness.Record("serve", 1.0, {}, spans, None)
    assert abs(read(record) - 95.05) < 1e-9
    assert read(harness.Record("serve", 1.0, {}, {"request": []}, None)) \
        is None
