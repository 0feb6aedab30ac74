"""The share of the sorted ray blocks in the traced run's profiled frames
that hold no sample and skip the per-sample stage and the MLP (the
program's ``blocks.empty`` over ``blocks``, counted in the block loop)."""

from benchmark.harness import spans


def read(trace):
    return spans.share(trace, "session", "session.render", "blocks.empty", ("blocks",))
