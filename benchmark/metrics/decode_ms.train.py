"""Milliseconds per step that the dataset's prefetch thread spends
decoding images (the program's ``data.decode`` spans: a PNG decoded and
premultiplied on a miss of the decode cache), over the traced run's
profiled steps."""

from benchmark.harness import spans


def read(trace):
    return spans.per_unit_ms(trace, "train", "train.step", spans.named("data.decode"), own=False)
