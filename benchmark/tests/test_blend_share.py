"""benchmark/metrics/blend_share.frame.py on made-up snapshots: the share of
the valid samples whose blended pick weighed two or more active instances,
0 where the count reads 0, and nothing where no sample was valid, where the
program does not count the blended picks (the count absent), for another
kind of cell, or without the tracer."""

import pytest

from benchmark.harness import manifest as mf
from benchmark.harness import spans

FRAMES = {"kind": "session", "part2": {"units": 2}}


def _snapshot(valid, blend):
    """Two frames (roots 1 and 20), each with the given counts of valid
    samples (under renderer.shade) and blended picks (under
    instancer.per_sample)."""
    s = [{"name": "session.render", "id": root, "parent": None, "unit": root, "start_ns": 0,
          "end_ns": 1, "self_ns": 0, "thread": 1} for root in (1, 20)]
    counts = []
    for unit, v, b in zip((1, 20), valid, blend):
        counts += [{"name": "mlp.valid", "span": "renderer.shade", "unit": unit, "n": v},
                   {"name": "pick.blend", "span": "instancer.per_sample", "unit": unit, "n": b}]
    counts = [c for c in counts if c["n"] is not None]
    return lambda: {"spans": s, "counts": counts, "dropped": 0}


@pytest.mark.parametrize("valid,blend,want", [
    ((4000, 6000), (1000, 1500), 25.0),
    ((4000, 6000), (4000, 6000), 100.0),
    ((4000, 6000), (0, 0), 0.0),
    ((4000, 6000), (None, None), None),
    ((0, 0), (0, 0), None),
])
def test_share_of_the_valid_samples_that_the_blend_decides(valid, blend, want, monkeypatch):
    monkeypatch.setattr(spans, "snapshot", _snapshot(valid, blend))
    got = mf.reader("blend_share.frame").read(FRAMES)
    assert got == (None if want is None else pytest.approx(want))


def test_nothing_for_another_kind_or_without_the_tracer(monkeypatch):
    monkeypatch.setattr(spans, "snapshot", _snapshot((10, 10), (3, 3)))
    reader = mf.reader("blend_share.frame")
    assert reader.read({"kind": "train", "part2": {"units": 2}}) is None
    assert reader.read(dict(FRAMES, part2={"units": 3})) is None
    monkeypatch.setattr(spans, "snapshot", lambda: None)
    assert reader.read(FRAMES) is None


def test_the_plush_cell_alone_reports_it():
    manifest = mf.load()
    for cell in manifest["workloads"]:
        names = {m["name"] for m in mf.per_layer(manifest, cell["name"])}
        assert ("blend_share.frame" in names) == (cell["name"] == "plush.frames"), cell
