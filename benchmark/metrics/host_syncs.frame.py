"""Host reads per frame in the traced run's profiled frames: statements
where the host waits for the device (a read of its answer or a blocking
copy), each counted once by the program's tracer as ``sync`` (the culls'
counts, the sorted blocks' table, the masked gathers and scatters of the
MLP rows, the shadow branch, the drop counts, the read-back)."""

from benchmark.harness import spans


def read(trace):
    return spans.per_unit_count(trace, "session", "session.render", "sync")
