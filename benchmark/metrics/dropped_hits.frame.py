"""Ray-instance intervals dropped a frame because a ray met more than
``max_hits`` instances (the program's ``dropped.hits``, taken at the
renderer's existing overflow read), over the traced run's profiled
frames."""

from benchmark.harness import spans


def read(trace):
    return spans.per_unit_count(trace, "session", "session.render", "dropped.hits")
