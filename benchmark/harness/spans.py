"""The program's own spans and counts in a traced run's profiled stretch.

The port's tracer (nerftex_torch/utils/trace.py) records while a torch
profiler runs in the process, and only the profiled stretch runs under
one, so the tracer's snapshot after the run holds that stretch alone.  A
unit is one request, frame or step: the spans and counts that share the
id of its root span.  Every reader divides by the number of roots it finds
and gives nothing unless that number is the stretch's count of units; a
program without the tracer gives nothing either.
"""


def snapshot():
    """The tracer's snapshot, or None for a program without the tracer."""
    try:
        from nerftex_torch.utils import trace
    except ImportError:
        return None
    return trace.snapshot()


def units(trace, kind: str, root: str):
    """(snapshot, ids of the ``root`` spans that began no span) of a traced
    run of ``kind``; None unless there are as many as profiled units."""
    if trace.get("kind") != kind:
        return None
    snap = snapshot()
    if snap is None:
        return None
    ids = {s["id"] for s in snap["spans"] if s["name"] == root and s["parent"] is None}
    if not ids or len(ids) != trace["part2"]["units"]:
        return None
    return snap, ids


def count(snap, ids, name: str) -> int:
    """The count ``name`` summed over the units ``ids`` (over every unit in
    the stretch where ``ids`` is None)."""
    return sum(c["n"] for c in snap["counts"]
               if c["name"] == name and (ids is None or c["unit"] in ids))


def per_unit_count(trace, kind: str, root: str, name: str):
    """The count ``name`` a unit, over the units whose roots are ``root``
    spans; None as ``units`` gives it."""
    got = units(trace, kind, root)
    if got is None:
        return None
    snap, ids = got
    return count(snap, ids, name) / len(ids)


def per_unit_ms(trace, kind: str, root: str, pick, own: bool = True):
    """Milliseconds a unit in the spans for which pick(span) holds: the
    units' own spans, or (``own`` False) every such span of the stretch,
    as the prefetch thread's, which belong to no request or step."""
    got = units(trace, kind, root)
    if got is None:
        return None
    snap, ids = got
    picked = spans(snap, ids if own else None, pick)
    return sum(seconds(s) for s in picked) / len(ids) * 1e3


def share(trace, kind: str, root: str, part: str, whole: tuple, own: bool = True):
    """100 x the count ``part`` over the counts ``whole`` summed, in the
    units (or, ``own`` False, the whole stretch); None where ``whole`` sums
    to nothing."""
    got = units(trace, kind, root)
    if got is None:
        return None
    snap, ids = got
    ids = ids if own else None
    total = sum(count(snap, ids, name) for name in whole)
    return 100.0 * count(snap, ids, part) / total if total else None


def seconds(span) -> float:
    return (span["end_ns"] - span["start_ns"]) * 1e-9


def is_sync(span) -> bool:
    return span["name"].startswith("sync.")


def named(name: str):
    """A pick of the spans named ``name``."""
    return lambda s: s["name"] == name


def spans(snap, ids, pick):
    """The spans of the units ``ids`` (of every unit where ``ids`` is None)
    for which pick(span) holds."""
    return [s for s in snap["spans"] if (ids is None or s["unit"] in ids) and pick(s)]


def below(snap, tops, pick):
    """The spans for which pick(span) holds that lie below (at any depth)
    one of the spans whose ids are ``tops``."""
    parent = {s["id"]: s["parent"] for s in snap["spans"]}
    out = []
    for s in snap["spans"]:
        if pick(s):
            p = s["parent"]
            while p is not None and p not in tops:
                p = parent.get(p)
            if p is not None:
                out.append(s)
    return out
