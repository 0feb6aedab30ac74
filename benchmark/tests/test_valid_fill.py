"""benchmark/metrics/valid_fill.frame.py on made-up snapshots: the share of
the sorted grid's slots that hold a valid sample, 100 for a full grid, 0
where the count reads 0, and nothing where no block was shaded, where the
program does not count valid samples (the count absent), for another kind
of cell, or without the tracer."""

import pytest

from benchmark.harness import manifest as mf
from benchmark.harness import spans

FRAMES = {"kind": "session", "part2": {"units": 2}}


def _snapshot(samples, valid):
    """Two frames (roots 1 and 20), each with the given counts of grid
    slots (under instancer.block) and valid samples (under renderer.shade)."""
    s = [{"name": "session.render", "id": root, "parent": None, "unit": root, "start_ns": 0,
          "end_ns": 1, "self_ns": 0, "thread": 1} for root in (1, 20)]
    counts = []
    for unit, g, v in zip((1, 20), samples, valid):
        counts += [{"name": "grid.samples", "span": "instancer.block", "unit": unit, "n": g},
                   {"name": "mlp.valid", "span": "renderer.shade", "unit": unit, "n": v}]
    counts = [c for c in counts if c["n"] is not None]
    return lambda: {"spans": s, "counts": counts, "dropped": 0}


@pytest.mark.parametrize("samples,valid,want", [
    ((1024 * 320, 1024 * 200), (1024 * 320, 1024 * 200), 100.0),
    ((4000, 6000), (3000, 5000), 80.0),
    ((4000, 6000), (0, 0), 0.0),
    ((4000, 6000), (None, None), None),
    ((0, 0), (0, 0), None),
])
def test_share_of_the_grid_slots_that_are_valid(samples, valid, want, monkeypatch):
    monkeypatch.setattr(spans, "snapshot", _snapshot(samples, valid))
    got = mf.reader("valid_fill.frame").read(FRAMES)
    assert got == (None if want is None else pytest.approx(want))


def test_nothing_for_another_kind_or_without_the_tracer(monkeypatch):
    monkeypatch.setattr(spans, "snapshot", _snapshot((10, 10), (9, 9)))
    reader = mf.reader("valid_fill.frame")
    assert reader.read({"kind": "train", "part2": {"units": 2}}) is None
    assert reader.read(dict(FRAMES, part2={"units": 3})) is None
    monkeypatch.setattr(spans, "snapshot", lambda: None)
    assert reader.read(FRAMES) is None


def test_the_frame_cells_alone_report_it():
    manifest = mf.load()
    for cell in ("grass.frames", "carpet.frames", "carpet.preview", "carpet.train"):
        names = {m["name"] for m in mf.per_layer(manifest, cell)}
        assert ("valid_fill.frame" in names) == cell.endswith(".frames"), cell
