"""The share of image reads that miss the dataset's decode cache (the
program's ``decode.miss`` over ``decode.hit`` plus ``decode.miss``, counted
on the prefetch thread) in the traced run's profiled steps."""

from benchmark.harness import spans


def read(trace):
    return spans.share(trace, "train", "train.step", "decode.miss", ("decode.hit", "decode.miss"),
                       own=False)
