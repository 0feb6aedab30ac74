"""The readers of the carpet_full.train_device cell (benchmark/metrics/
*.train_device.py) on a made-up traced run: their values, and nothing for
a run of another kind, for a program without the tracer or without the
step counts, or where the dispatches found are not the part's units."""

import pytest

from benchmark.harness import manifest as mf
from benchmark.harness import peaks, spans
from benchmark.reference.mlp import flops_per_row

MS = 1_000_000      # nanoseconds
SPEC = {"n_geo": 1, "n_app": 6, "n_pos": 3, "pos_bands": 10, "dir_bands": 4, "param_bands": 4,
        "param_depth": 0, "param_width": 128, "depth": 8, "width": 256, "skips": (4,),
        "color_depth": 1}


def _span(sid, name, parent, unit, start_ms, end_ms):
    return {"name": name, "id": sid, "parent": parent, "unit": unit, "start_ns": start_ms * MS,
            "end_ns": end_ms * MS, "self_ns": 0, "thread": 1}


def _snapshot():
    """Set-up's first dispatch (root 1, with the capture) before the traced
    parts; two whole dispatches in part 1 (roots 10 and 20, whose first
    replays' launches take 1 and 3 ms and whose second wait 29 and 27 ms
    for room in the queue); one profiled dispatch of five steps in part 2
    (root 30)."""
    s = [_span(1, "train.replay", None, 1, 0, 100),
         _span(2, "train.capture", 1, 1, 0, 90),
         _span(3, "sync.losses", 1, 1, 95, 100),
         _span(10, "train.replay", None, 10, 200, 260),
         _span(12, "train.launch", 10, 10, 201, 230),
         _span(13, "train.launch", 10, 10, 200, 201),
         _span(11, "sync.losses", 10, 10, 230, 260),
         _span(20, "train.replay", None, 20, 300, 350),
         _span(22, "train.launch", 20, 20, 300, 303),
         _span(23, "train.launch", 20, 20, 303, 330),
         _span(21, "sync.losses", 20, 20, 330, 350),
         _span(30, "train.replay", None, 30, 400, 420),
         _span(31, "sync.losses", 30, 30, 410, 420)]
    counts = [{"name": "train.replays", "span": "train.replay", "unit": 1, "n": 1},
              {"name": "train.replays", "span": "train.replay", "unit": 10, "n": 100},
              {"name": "train.replays", "span": "train.replay", "unit": 20, "n": 100},
              {"name": "train.replays", "span": "train.replay", "unit": 30, "n": 5},
              {"name": "sync", "span": "train.replay", "unit": 30, "n": 1}]
    return {"spans": s, "counts": counts, "dropped": 0}


RUN = {"kind": "train_device", "spec": SPEC,
       "part1": {"wall_s": 0.2, "units": 2, "steps": 200, "samples": 200 * 262144,
                 "start_ns": 150 * MS, "end_ns": 360 * MS},
       "part2": {"wall_s": 0.05, "busy_s": 0.04, "launches": 38735, "units": 1, "steps": 5,
                 "start_ns": 360 * MS, "end_ns": 430 * MS}}

EXPECTED = {
    "mfu.train_device": 100 * 3 * flops_per_row(SPEC) * 200 * 262144 / 0.2 / peaks.BF16_FLOPS,
    "launches.train_device": 38735 / 5,
    "device_idle.train_device": 20.0,
    "replay_issue_ms.train_device": (1 + 3) / 2,
}
FROM_SPANS = ("launches.train_device", "replay_issue_ms.train_device")


@pytest.fixture(autouse=True)
def _made_up_tracer(monkeypatch):
    monkeypatch.setattr(spans, "snapshot", _snapshot)


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_on_a_made_up_run(metric):
    assert mf.reader(metric).read(RUN) == pytest.approx(EXPECTED[metric])


@pytest.mark.parametrize("metric", sorted(EXPECTED))
@pytest.mark.parametrize("kind", ["train", "session", "none"])
def test_reader_gives_nothing_for_another_kind(metric, kind):
    assert mf.reader(metric).read(dict(RUN, kind=kind)) is None


@pytest.mark.parametrize("metric", FROM_SPANS)
def test_reader_gives_nothing_without_the_tracer(metric, monkeypatch):
    monkeypatch.setattr(spans, "snapshot", lambda: None)
    assert mf.reader(metric).read(RUN) is None


@pytest.mark.parametrize("metric", FROM_SPANS)
@pytest.mark.parametrize("units", [1, 3])
def test_reader_gives_nothing_when_the_dispatches_are_not_the_units(metric, units):
    part = "part2" if metric.startswith("launches") else "part1"
    if part == "part2":
        units += 1
    run = dict(RUN, **{part: dict(RUN[part], units=units)})
    assert mf.reader(metric).read(run) is None


def test_launches_need_the_programs_step_counts(monkeypatch):
    """A program that counts no steps (as before the counts were added)
    gives no launches a step."""
    def uncounted():
        snap = _snapshot()
        return dict(snap, counts=[c for c in snap["counts"] if c["name"] == "sync"])

    monkeypatch.setattr(spans, "snapshot", uncounted)
    assert mf.reader("launches.train_device").read(RUN) is None
    assert mf.reader("replay_issue_ms.train_device").read(RUN) == pytest.approx(2.0)


def test_replay_issue_needs_the_programs_launch_spans(monkeypatch):
    """A program that records no ``train.launch`` span (as before the span
    was added) gives no time to issue a replay."""
    def unlaunched():
        snap = _snapshot()
        return dict(snap, spans=[s for s in snap["spans"] if s["name"] != "train.launch"])

    monkeypatch.setattr(spans, "snapshot", unlaunched)
    assert mf.reader("replay_issue_ms.train_device").read(RUN) is None
    assert mf.reader("launches.train_device").read(RUN) == pytest.approx(38735 / 5)
