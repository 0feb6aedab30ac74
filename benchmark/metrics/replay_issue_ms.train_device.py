"""Host milliseconds to issue one step's graph replay with the launch queue
empty: the program's first ``train.launch`` span (FusedStep.run's
``graph.replay()``) of each of the traced run's whole dispatches, whose
previous dispatch's losses were read back, so the card has drained; the
median over the dispatches.  Later replays of a dispatch wait in
``graph.replay()`` for room in the full queue, which is the card's time,
not the host's.  The host holds the card back once this reaches the
card's time a step."""

import statistics

from benchmark.harness import spans
from benchmark.harness.train_device import dispatch_roots


def read(trace):
    got = dispatch_roots(trace, "part1")
    if got is None:
        return None
    snap, ids = got
    first = {}
    for s in spans.spans(snap, ids, spans.named("train.launch")):
        if s["unit"] not in first or s["start_ns"] < first[s["unit"]]["start_ns"]:
            first[s["unit"]] = s
    if len(first) != len(ids):
        return None
    return statistics.median(spans.seconds(s) for s in first.values()) * 1e3
