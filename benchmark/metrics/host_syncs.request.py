"""Host reads per request in the traced run's profiled requests: the
program's ``sync`` count (see host_syncs.frame) under its ``session.render``
roots."""

from benchmark.harness import spans


def read(trace):
    return spans.per_unit_count(trace, "session", "session.render", "sync")
