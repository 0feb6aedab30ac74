"""Kernel launches a step in the traced run's profiled dispatches (the
sampler, forward, autograd backward and Adam, replayed from the captured
graph), over the steps the program counted there (``train.replays`` and
``train.eager`` under those dispatches' ``train.replay`` spans)."""

from benchmark.harness import spans
from benchmark.harness.train_device import dispatch_roots


def read(trace):
    got = dispatch_roots(trace, "part2")
    if got is None:
        return None
    snap, ids = got
    steps = spans.count(snap, ids, "train.replays") + spans.count(snap, ids, "train.eager")
    return trace["part2"]["launches"] / steps if steps else None
