"""BENCHMARK.json against the contract's shape, and the harness's loader
finding every cell, configuration, mix and metric by name, a new cell
added as files alone included."""

import json
import os
import re
import shutil
import time

import pytest

from benchmark.harness import cell as cell_run
from benchmark.harness import manifest as mf

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def _line(text: str) -> bool:
    """1 to 200 characters on one line, with no tab."""
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.fixture(scope="module")
def manifest():
    return mf.load()


def test_top_level(manifest):
    assert set(manifest) == KEYS
    assert manifest["command"] == ["python3", "benchmark/run.py"]
    assert manifest["paths"] == ["benchmark"]
    assert 1 <= manifest["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(mf.ROOT, "BENCHMARK.json")) <= 64 * 1024
    cells = len(manifest["workloads"])
    # A full check at 24 cells fits the driver's 43,200 s.
    per_run = manifest["run_seconds"] + 60
    assert (2 + 14 * 24) * per_run + 24 * 2 * 90 + 1200 <= 43200
    assert 1 <= cells <= 24


def test_names_units_and_entries(manifest):
    names = set()
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert all(_line(c[k]) for k in ("source", "why"))
        names.add(c["name"])
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in names
        assert w["chips"] == 1 and _line(w["why"])
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(pairs) == len(set(pairs))
    metrics = manifest["end_to_end"] + manifest["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in manifest["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in SOURCES and _line(m["layer"])
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                   "higher")
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in manifest["end_to_end"])


def test_every_cell_reports_what_its_metrics_move(manifest):
    for w in manifest["workloads"]:
        e2e = {m["name"] for m in mf.end_to_end(manifest, w["name"])}
        layer = mf.per_layer(manifest, w["name"])
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        assert all(m["moves"] in e2e for m in layer), w["name"]


def test_files_found_by_name(manifest):
    for c in manifest["configs"]:
        assert mf.config(manifest, c["name"])["render"]
    for w in manifest["workloads"]:
        assert mf.traffic(w["traffic"])["kind"]
        assert mf.limits(w["name"])
    for m in manifest["per_layer"]:
        assert mf.reader(m["name"]).read({"kind": "none"}) is None


def test_a_cell_added_as_files_runs(tmp_path):
    """A throwaway cell: a mix file, a limits file, a metric file and
    entries in a copy of BENCHMARK.json; the loader and one run on the
    CPU find it all by name, and no existing file is edited."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(mf.ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__", "tests"))
    (root / "meshes").symlink_to(os.path.join(mf.ROOT, "meshes"))
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    manifest = json.loads(open(os.path.join(mf.ROOT, "BENCHMARK.json")).read())
    frames = json.loads((root / "benchmark" / "traffic" / "frames.json").read_text())
    (root / "benchmark" / "traffic" / "tiny.json").write_text(json.dumps(
        dict(frames, size=[12, 12], check_frames=1, check_pixels=16)))
    (root / "benchmark" / "limits" / "carpet.tiny.json").write_text(
        (root / "benchmark" / "limits" / "carpet.frames.json").read_text())
    (root / "benchmark" / "metrics" / "units.tiny.py").write_text(
        "def read(trace):\n    return trace['part1']['units'] if trace else None\n")
    manifest["workloads"].append({"name": "carpet.tiny", "config": "carpet", "traffic": "tiny",
                                  "chips": 1, "why": "a test"})
    manifest["end_to_end"][0]["workloads"].append("carpet.tiny")
    manifest["per_layer"].append({"name": "units.tiny", "unit": "frames", "better": "higher",
                                  "source": "host_clock", "layer": "test", "moves":
                                  manifest["end_to_end"][0]["name"],
                                  "workloads": ["carpet.tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    got = cell_run.run("carpet.tiny", 5, 0.05, False, "cpu", time.perf_counter(),
                       root=str(root))
    assert got["correct"], got["checks"]
    assert set(got["metrics"]) == {manifest["end_to_end"][0]["name"], "setup_s"}
    assert list(got)[-1] == "checks"
    assert mf.reader("units.tiny", str(root)).read({"part1": {"units": 3}}) == 3
    assert all(p.read_bytes() == b for p, b in before.items())
