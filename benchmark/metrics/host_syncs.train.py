"""Host reads per step inside the program's training step (``sync``
counted under its ``train.step`` spans), over the traced run's profiled
steps."""

from benchmark.harness import spans


def read(trace):
    return spans.per_unit_count(trace, "train", "train.step", "sync")
