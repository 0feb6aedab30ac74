"""Samples dropped a frame because a ray needed more steps than its cap
(the program's ``dropped.steps``, taken at the renderer's existing overflow
read), over the traced run's profiled frames."""

from benchmark.harness import spans


def read(trace):
    return spans.per_unit_count(trace, "session", "session.render", "dropped.steps")
