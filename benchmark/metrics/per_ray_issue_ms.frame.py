"""Host milliseconds per frame that DeviceInstancer._per_ray takes outside
its host reads: the program's ``instancer.per_ray`` spans less the
``sync.*`` spans below them (the culls' counts, the shadow branch), so the
host's own time to issue the per-ray stage's launches, over the traced
run's profiled frames (no synchronisation added)."""

from benchmark.harness import spans


def read(trace):
    got = spans.units(trace, "session", "session.render")
    if got is None:
        return None
    snap, ids = got
    per_ray = spans.spans(snap, ids, lambda s: s["name"] == "instancer.per_ray")
    if not per_ray:
        return None
    waits = spans.below(snap, {s["id"] for s in per_ray}, spans.is_sync)
    issue = sum(spans.seconds(s) for s in per_ray) - sum(spans.seconds(s) for s in waits)
    return issue / len(ids) * 1e3
