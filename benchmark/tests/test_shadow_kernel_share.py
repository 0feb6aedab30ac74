"""benchmark/metrics/shadow_kernel_share.frame.py on made-up snapshots:
100 where the kernel answered every point that entered the shadow query,
the share where it answered some, and nothing where no point entered the
query (a carpet frame), for another kind of cell, or without the tracer."""

import pytest

from benchmark.harness import manifest as mf
from benchmark.harness import spans

FRAMES = {"kind": "session", "part2": {"units": 2}}


def _snapshot(points, kernel):
    """Two frames (roots 1 and 20), each with the given counts of points
    entering the query and answered by the kernel, under instancer.shadow."""
    s = [{"name": "session.render", "id": root, "parent": None, "unit": root, "start_ns": 0,
          "end_ns": 1, "self_ns": 0, "thread": 1} for root in (1, 20)]
    counts = []
    for unit, p, k in zip((1, 20), points, kernel):
        counts += [{"name": "shadow.points", "span": "instancer.shadow", "unit": unit, "n": p},
                   {"name": "shadow.kernel", "span": "instancer.shadow", "unit": unit, "n": k}]
    counts = [c for c in counts if c["n"]]
    return lambda: {"spans": s, "counts": counts, "dropped": 0}


@pytest.mark.parametrize("points,kernel,want", [
    ((65536 * 72, 65536 * 70), (65536 * 72, 65536 * 70), 100.0),
    ((1000, 3000), (1000, 0), 25.0),
    ((0, 0), (0, 0), None),
])
def test_share_of_the_points_the_kernel_answered(points, kernel, want, monkeypatch):
    monkeypatch.setattr(spans, "snapshot", _snapshot(points, kernel))
    got = mf.reader("shadow_kernel_share.frame").read(FRAMES)
    assert got == (None if want is None else pytest.approx(want))


def test_nothing_for_another_kind_or_without_the_tracer(monkeypatch):
    monkeypatch.setattr(spans, "snapshot", _snapshot((10, 10), (10, 10)))
    reader = mf.reader("shadow_kernel_share.frame")
    assert reader.read({"kind": "train", "part2": {"units": 2}}) is None
    assert reader.read(dict(FRAMES, part2={"units": 3})) is None
    monkeypatch.setattr(spans, "snapshot", lambda: None)
    assert reader.read(FRAMES) is None


def test_the_grass_cell_alone_reports_it():
    manifest = mf.load()
    for cell in ("grass.frames", "carpet.frames", "carpet.preview", "carpet.train"):
        names = {m["name"] for m in mf.per_layer(manifest, cell)}
        assert ("shadow_kernel_share.frame" in names) == (cell == "grass.frames"), cell
