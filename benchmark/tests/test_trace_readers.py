"""The readers of the program's own spans and counts (benchmark/metrics/
host_syncs.*, sync_wait_ms.frame, per_ray_issue_ms.frame,
empty_blocks.frame, sample_fill.frame, cull_full.frame, dropped_*.frame,
step_host_ms.train, decode_ms.train, decode_miss.train) on made-up
snapshots: each divides by the root spans it finds, and gives nothing when
their number differs from the profiled units, for another kind of cell,
or for a program without the tracer."""

import pytest

from benchmark.harness import manifest as mf
from benchmark.harness import spans

MS = 1_000_000      # nanoseconds


def _span(sid, name, parent, unit, start_ms, end_ms):
    return {"name": name, "id": sid, "parent": parent, "unit": unit, "start_ns": start_ms * MS,
            "end_ns": end_ms * MS, "self_ns": 0, "thread": 1}


def _frames():
    """Two frames (roots 1 and 20); frame 1: a per-ray span of 10 ms with
    a 2 ms cull read two levels down and a 1 ms read-back outside it;
    frame 2: a per-ray span of 6 ms with a 3 ms shadow read."""
    s = [_span(1, "session.render", None, 1, 0, 40),
         _span(2, "instancer.per_ray", 1, 1, 1, 11),
         _span(3, "per_ray.mesh_hit", 2, 1, 2, 6),
         _span(4, "sync.cull", 3, 1, 3, 5),
         _span(5, "sync.readback", 1, 1, 30, 31),
         _span(20, "session.render", None, 20, 50, 80),
         _span(21, "instancer.per_ray", 20, 20, 51, 57),
         _span(22, "instancer.shadow", 21, 20, 52, 56),
         _span(23, "sync.shadow_branch", 22, 20, 53, 56),
         _span(30, "data.batch", None, ("batch", 0), 0, 5)]
    counts = [{"name": "sync", "span": "per_ray.mesh_hit", "unit": 1, "n": 1},
              {"name": "sync", "span": "session.render", "unit": 1, "n": 1},
              {"name": "sync", "span": "instancer.shadow", "unit": 20, "n": 1},
              {"name": "sync", "span": "data.batch", "unit": ("batch", 0), "n": 5},
              {"name": "blocks", "span": "instancer.block", "unit": 1, "n": 4},
              {"name": "blocks", "span": "instancer.block", "unit": 20, "n": 9},
              {"name": "blocks.empty", "span": "instancer.block", "unit": 20, "n": 3},
              {"name": "blocks.empty", "span": "instancer.block", "unit": 99, "n": 50},
              {"name": "grid.samples", "span": "instancer.block", "unit": 1, "n": 1000},
              {"name": "grid.samples", "span": "instancer.block", "unit": 20, "n": 3000},
              {"name": "mlp.rows", "span": "mlp.infer", "unit": 1, "n": 600},
              {"name": "mlp.rows", "span": "mlp.infer", "unit": 20, "n": 1400},
              {"name": "cull.fit", "span": "per_ray.slabs", "unit": 1, "n": 7},
              {"name": "cull.full", "span": "per_ray.mesh_hit", "unit": 20, "n": 1},
              {"name": "dropped.hits", "span": "renderer.diagnostics", "unit": 1, "n": 0},
              {"name": "dropped.hits", "span": "renderer.diagnostics", "unit": 20, "n": 4},
              {"name": "dropped.steps", "span": "renderer.diagnostics", "unit": 1, "n": 3}]
    return {"spans": s, "counts": counts, "dropped": 0}


def _steps():
    """Two training steps (roots 1 and 10, 12 and 8 ms), one host read in
    the second; the prefetch thread's two batches decode three images (5, 7
    and 6 ms) and hit the cache once."""
    s = [_span(1, "train.step", None, 1, 0, 12),
         _span(2, "step.forward", 1, 1, 0, 4),
         _span(10, "train.step", None, 10, 20, 28),
         _span(11, "sync.update_count", 10, 10, 21, 22),
         _span(40, "data.batch", None, ("batch", 0), 0, 12),
         _span(41, "data.decode", 40, ("batch", 0), 0, 5),
         _span(42, "data.decode", 40, ("batch", 0), 5, 12),
         _span(50, "data.batch", None, ("batch", 1), 12, 19),
         _span(51, "data.decode", 50, ("batch", 1), 12, 18),
         _span(60, "data.wait", None, 60, 0, 3)]
    counts = [{"name": "sync", "span": "train.step", "unit": 10, "n": 1},
              {"name": "decode.miss", "span": "data.batch", "unit": ("batch", 0), "n": 2},
              {"name": "decode.miss", "span": "data.batch", "unit": ("batch", 1), "n": 1},
              {"name": "decode.hit", "span": "data.batch", "unit": ("batch", 1), "n": 1}]
    return {"spans": s, "counts": counts, "dropped": 0}


FRAMES = {"kind": "session", "part2": {"units": 2}}
STEPS = {"kind": "train", "part2": {"units": 2}}

EXPECTED = {
    "host_syncs.frame": (FRAMES, _frames, 1.5),
    "host_syncs.request": (FRAMES, _frames, 1.5),
    "sync_wait_ms.frame": (FRAMES, _frames, (2 + 1 + 3) / 2),
    "per_ray_issue_ms.frame": (FRAMES, _frames, ((10 - 2) + (6 - 3)) / 2),
    "empty_blocks.frame": (FRAMES, _frames, 100 * 3 / (4 + 9)),
    "sample_fill.frame": (FRAMES, _frames, 100 * (600 + 1400) / (1000 + 3000)),
    "cull_full.frame": (FRAMES, _frames, 100 * 1 / (7 + 1)),
    "dropped_hits.frame": (FRAMES, _frames, (0 + 4) / 2),
    "dropped_steps.frame": (FRAMES, _frames, 3 / 2),
    "host_syncs.train": (STEPS, _steps, 0.5),
    "step_host_ms.train": (STEPS, _steps, (12 + 8) / 2),
    "decode_ms.train": (STEPS, _steps, (5 + 7 + 6) / 2),
    "decode_miss.train": (STEPS, _steps, 75.0),
}


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_on_a_made_up_snapshot(metric, monkeypatch):
    trace, snap, want = EXPECTED[metric]
    monkeypatch.setattr(spans, "snapshot", snap)
    assert mf.reader(metric).read(trace) == pytest.approx(want)


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_gives_nothing_when_the_roots_are_not_the_units(metric, monkeypatch):
    trace, snap, _ = EXPECTED[metric]
    monkeypatch.setattr(spans, "snapshot", snap)
    for units in (1, 3):
        assert mf.reader(metric).read(dict(trace, part2={"units": units})) is None


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_gives_nothing_for_another_kind_or_without_the_tracer(metric, monkeypatch):
    trace, snap, _ = EXPECTED[metric]
    other = STEPS if trace is FRAMES else FRAMES
    monkeypatch.setattr(spans, "snapshot", snap)
    assert mf.reader(metric).read(other) is None
    monkeypatch.setattr(spans, "snapshot", lambda: None)
    assert mf.reader(metric).read(trace) is None


@pytest.mark.parametrize("metric", ["empty_blocks.frame", "sample_fill.frame", "cull_full.frame",
                                    "decode_miss.train"])
def test_a_share_of_nothing_is_nothing(metric, monkeypatch):
    """A share whose whole was never counted in the stretch gives nothing."""
    trace, snap, _ = EXPECTED[metric]
    def bare():
        got = snap()
        return dict(got, counts=[c for c in got["counts"] if c["name"] == "sync"])

    monkeypatch.setattr(spans, "snapshot", bare)
    assert mf.reader(metric).read(trace) is None


def test_snapshot_is_none_without_the_tracer(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_tracer(name, *a, **k):
        if name == "nerftex_torch.utils" and a and a[2] and "trace" in a[2]:
            raise ImportError("no tracer")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_tracer)
    assert spans.snapshot() is None


def test_the_program_tracer_feeds_the_readers():
    """The snapshot the readers take is the program's own."""
    from nerftex_torch.utils import trace

    trace.reset()
    with trace.recording():
        with trace.span("session.render"):
            with trace.host_read("readback"):
                pass
    try:
        assert mf.reader("host_syncs.request").read(
            {"kind": "session", "part2": {"units": 1}}) == 1
    finally:
        trace.reset()
