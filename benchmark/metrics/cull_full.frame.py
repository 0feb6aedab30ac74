"""The share of the per-ray stage's culls (the instance and triangle cull
of every ray block) whose kept count overran its budget and took the full,
unculled branch (the program's ``cull.full`` over ``cull.fit`` plus
``cull.full``), over the traced run's profiled frames."""

from benchmark.harness import spans


def read(trace):
    return spans.share(trace, "session", "session.render", "cull.full", ("cull.fit", "cull.full"))
