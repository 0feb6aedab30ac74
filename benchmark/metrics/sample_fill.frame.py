"""The share of the sorted blocks' sample slots (block rays x the block's
step count, the program's ``grid.samples``) that hold a valid sample and
enter the MLP (``mlp.rows``, the rows entering ``ParamNerf.infer``), over
the traced run's profiled frames: the rest is padding that the per-sample
stage pays for."""

from benchmark.harness import spans


def read(trace):
    return spans.share(trace, "session", "session.render", "mlp.rows", ("grid.samples",))
