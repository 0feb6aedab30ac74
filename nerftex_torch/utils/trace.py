"""One tracer for the port: spans and counts at the layers' boundaries,
kept in memory and written nowhere.

    from nerftex_torch.utils import trace

    with trace.span("renderer.chunk"):        # or @trace.span("mlp.infer")
        ...
    trace.count("mlp.rows", n)
    with trace.host_read("readback"):         # the host waits for the device
        img = out.cpu()

Recording is on inside ``trace.recording()`` and whenever a torch profiler
runs in the process (``torch.autograd.profiler._is_profiler_enabled``,
which the profiler sets for every thread), so a profiled stretch records
the program's spans with no set-up of its own.  While recording, each
span also opens ``torch.profiler.record_function("nerftex.<name>")``, so
it shows on the profiler's timeline beside the device's kernels.  Off,
which is the default, a span, count or host read costs a flag test: no
``record_function``, no list append, no lock; a host read still reads.

A span holds its name, its start and end on ``time.perf_counter_ns()``,
its id, its parent's id (the innermost span open on the same thread when
it began, else None), its unit and its self time (its duration less the
durations of its recorded children).  A root span's unit is its own id, or
the ``unit`` it is given; every other span takes its parent's, so the
spans of one request or step share the unit of its root.  A count is kept
per (name, the innermost open span's name, that span's unit).
``host_read(site)`` marks a statement where the host waits for the
device's answer: a span ``sync.<site>`` that also counts one ``sync``
where it is opened.

A count may be a device tensor of one integer (a flag the card computed,
such as whether a ray block's cull fit): it is added on its device to a
running sum under its key, and the sums are read when the counts are next
read, all of a device at once, so that counting it makes no host read of
its own.  ``snapshot()`` and ``totals()`` therefore wait for the device
where such sums are pending: a wait that no ``sync`` counts, so read the
counts after the stretch they measure.

``snapshot()`` returns what was recorded, ``reset()`` clears it.  At most
``MAX_SPANS`` spans and as many keys of counts are kept; a later span, or a
count under a key that is not kept, is counted in ``dropped``.
"""

import contextlib
import functools
import itertools
import threading
import time

import torch
from torch.autograd import profiler as _profiler

MAX_SPANS = 1 << 20
SPAN_FIELDS = ("name", "id", "parent", "unit", "start_ns", "end_ns", "self_ns", "thread")

_recording = 0          # open trace.recording() blocks, over all threads
_spans = []             # finished spans as SPAN_FIELDS tuples, in the order they ended
_counts = {}            # (name, span name, unit) -> total
_pending = {}           # (key of _counts, device) -> running int64 sum there, not read yet
_dropped = 0
_ids = itertools.count(1)
_lock = threading.Lock()
_local = threading.local()


def is_recording() -> bool:
    return bool(_recording) or _profiler._is_profiler_enabled


class _Open:
    __slots__ = ("name", "id", "parent", "unit", "start", "child_ns", "rf")


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _open(name: str, unit) -> _Open:
    stack = _stack()
    parent = stack[-1] if stack else None
    rec = _Open()
    rec.name, rec.id, rec.child_ns = name, next(_ids), 0
    rec.parent = parent.id if parent is not None else None
    rec.unit = unit if unit is not None else (parent.unit if parent is not None else rec.id)
    rec.rf = _profiler.record_function("nerftex." + name)
    rec.rf.__enter__()
    stack.append(rec)
    rec.start = time.perf_counter_ns()
    return rec


def _close(rec: _Open) -> None:
    global _dropped
    end = time.perf_counter_ns()
    rec.rf.__exit__(None, None, None)
    stack = _stack()
    if rec in stack:
        del stack[stack.index(rec):]
    duration = end - rec.start
    if stack and stack[-1].id == rec.parent:
        stack[-1].child_ns += duration
    row = (rec.name, rec.id, rec.parent, rec.unit, rec.start, end, duration - rec.child_ns,
           threading.get_ident())
    with _lock:
        if len(_spans) < MAX_SPANS:
            _spans.append(row)
        else:
            _dropped += 1


class span:
    """A span named ``name``, as a context manager or a decorator; ``unit``
    names the unit of a root span (a root takes its own id otherwise)."""

    __slots__ = ("name", "unit", "_rec")

    def __init__(self, name: str, unit=None):
        self.name, self.unit, self._rec = name, unit, None

    def __enter__(self):
        if _recording or _profiler._is_profiler_enabled:
            self._rec = _open(self.name, self.unit)
        return self

    def __exit__(self, *exc):
        if self._rec is not None:
            _close(self._rec)
            self._rec = None
        return False

    def __call__(self, fn):
        name, unit = self.name, self.unit

        @functools.wraps(fn)
        def traced(*args, **kwargs):
            if not (_recording or _profiler._is_profiler_enabled):
                return fn(*args, **kwargs)
            with span(name, unit):
                return fn(*args, **kwargs)

        return traced


class host_read(span):
    """A statement where the host waits for the device's answer: one
    ``sync`` counted where it is opened, and the wait as a span named
    ``sync.<site>``."""

    __slots__ = ()

    def __init__(self, site: str):
        span.__init__(self, site)

    def __enter__(self):
        if _recording or _profiler._is_profiler_enabled:
            count("sync")
            self._rec = _open("sync." + self.name, None)
        return self

    def __call__(self, fn):
        raise TypeError("host_read marks a statement: use it in a with block")


def count(name: str, n=1) -> None:
    """Add ``n`` (a host int, or a 0-d integer tensor read later) to the
    count ``name`` of the innermost open span and its unit."""
    if not (_recording or _profiler._is_profiler_enabled):
        return
    stack = _stack()
    top = stack[-1] if stack else None
    key = (name, None, None) if top is None else (name, top.name, top.unit)
    with _lock:
        if isinstance(n, torch.Tensor):
            acc = _pending.get((key, n.device))
            if acc is None:
                _pending[(key, n.device)] = n.reshape(()).to(torch.int64, copy=True)
            else:
                acc.add_(n.reshape(()))
        else:
            _add(key, n)


def _add(key, n) -> None:
    """Add n to the count under ``key`` (the lock held)."""
    global _dropped
    if key in _counts:
        _counts[key] += n
    elif len(_counts) < MAX_SPANS:
        _counts[key] = n
    else:
        _dropped += 1


def _settle() -> None:
    """Read the pending device sums into the counts, one read a device."""
    with _lock:
        by_device = {}
        for (key, device), n in _pending.items():
            by_device.setdefault(device, []).append((key, n))
        _pending.clear()
        for rows in by_device.values():
            for (key, _), n in zip(rows, torch.stack([n for _, n in rows]).tolist()):
                _add(key, n)


@contextlib.contextmanager
def recording():
    """Record inside the block (on every thread)."""
    global _recording
    with _lock:
        _recording += 1
    try:
        yield
    finally:
        with _lock:
            _recording -= 1


def open_spans() -> list:
    """The names of the spans open on this thread, outermost first."""
    return [rec.name for rec in _stack()]


def snapshot() -> dict:
    """{"spans": [{field: value} for SPAN_FIELDS], "counts": [{"name",
    "span", "unit", "n"}], "dropped": spans and counts not kept}.  Waits for
    each device that holds pending count sums (module docstring)."""
    _settle()
    with _lock:
        spans, counts, dropped = list(_spans), dict(_counts), _dropped
    return {"spans": [dict(zip(SPAN_FIELDS, row)) for row in spans],
            "counts": [{"name": k[0], "span": k[1], "unit": k[2], "n": n}
                       for k, n in counts.items()],
            "dropped": dropped}


def totals(snap: dict = None) -> dict:
    """{name: total} of each count over its spans and units, in ``snap``
    (a snapshot; the recorded counts without one, which waits as
    ``snapshot()`` does)."""
    if snap is None:
        _settle()
        with _lock:
            counts = [{"name": k[0], "n": n} for k, n in _counts.items()]
    else:
        counts = snap["counts"]
    out = {}
    for c in counts:
        out[c["name"]] = out.get(c["name"], 0) + c["n"]
    return out


def reset() -> None:
    """Forget every recorded span and count (open spans stay open)."""
    global _dropped
    with _lock:
        _spans.clear()
        _counts.clear()
        _pending.clear()
        _dropped = 0
