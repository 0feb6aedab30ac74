"""Host milliseconds per step in the program's training step (its
``train.step`` spans: forward, loss, autograd backward and Adam issued, no
synchronisation added), over the traced run's profiled steps."""

from benchmark.harness import spans


def read(trace):
    return spans.per_unit_ms(trace, "train", "train.step", spans.named("train.step"))
