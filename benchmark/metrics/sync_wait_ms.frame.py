"""Host milliseconds per frame spent in the program's host reads (its
``sync.*`` spans: the wait for the device's answer or for a blocking copy,
and the read itself), over the traced run's profiled frames."""

from benchmark.harness import spans


def read(trace):
    return spans.per_unit_ms(trace, "session", "session.render", spans.is_sync)
