"""The share of the points entering the shadow query (the program's
``shadow.points``) that the shadow query kernel answered
(``shadow.kernel``), over the traced run's profiled frames; nothing where no
point entered the query (no shadows) or for a program without the counts."""

from benchmark.harness import spans


def read(trace):
    return spans.share(trace, "session", "session.render", "shadow.kernel", ("shadow.points",))
