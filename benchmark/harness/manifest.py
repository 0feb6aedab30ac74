"""BENCHMARK.json and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix.  The configuration is the JSON file that its ``configs`` entry
names; the traffic mix is ``benchmark/traffic/<traffic>.json``; the limits
of the comparison that decides ``correct`` are
``benchmark/limits/<cell>.json``; each per-layer metric's reader is
``benchmark/metrics/<metric>.py``.  So a new cell, configuration, mix or
metric is new files and new entries, and no edit.
"""

import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _read(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(manifest: dict, name: str, root: str = ROOT) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            return _read(os.path.join(root, c["file"]))
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, root: str = ROOT) -> dict:
    return _read(os.path.join(root, "benchmark", "traffic", f"{name}.json"))


def limits(cell_name: str, root: str = ROOT) -> dict:
    return _read(os.path.join(root, "benchmark", "limits", f"{cell_name}.json"))


def reader(metric: str, root: str = ROOT):
    """The module benchmark/metrics/<metric>.py (its ``read(trace)``)."""
    path = os.path.join(root, "benchmark", "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _applies(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def end_to_end(manifest: dict, cell_name: str) -> list:
    """The end-to-end metrics that the cell reports."""
    return [m for m in manifest["end_to_end"] if _applies(m, cell_name)]


def per_layer(manifest: dict, cell_name: str) -> list:
    """The per-layer metrics that the cell reports: those that list it, and
    those without a list whose ``moves`` metric the cell reports."""
    reported = {m["name"] for m in end_to_end(manifest, cell_name)}
    return [m for m in manifest["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
