"""A profiled stretch of work, reduced from torch.profiler's trace.

``profiled(fn)`` runs fn under the profiler (host and device activity),
synchronises, and returns what the per-layer readers and the result's
``device`` and ``breakdown`` need: the stretch's wall time; each device
operation's count and summed time by name; the kernel launches (device
operations other than copies and fills); the busy time (the union of all
device operations' intervals); the ten operations that took the most
time; and the idle gaps between device operations, each put down to the
innermost ``bench:<layer>`` range (probes.labels) that was open on the
host when the gap began, summed per range, the ten largest.
"""

import time

import torch

NOT_LAUNCHES = ("Memcpy", "Memset")
TOP = 10


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def profiled(fn, sync) -> dict:
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    device, ranges = [], []
    for e in prof.events():
        # A host range also shows on the device's timeline as an annotation,
        # which is no operation.
        note = e.name.startswith("bench:") or getattr(e, "is_user_annotation", False)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not note:
                device.append((e.time_range.start, e.time_range.end, e.name))
        elif e.name.startswith("bench:"):
            ranges.append((e.time_range.start, e.time_range.end, e.name[len("bench:"):]))
    ops = {}
    for s, e, name in device:
        count, us = ops.get(name, (0, 0.0))
        ops[name] = (count + 1, us + (e - s))
    busy = _merge([(s, e) for s, e, _ in device])
    # The host's ranges nest: a stack of the open ones, swept in time order.
    gaps, stack, i = {}, [], 0
    ranges.sort()
    for (_, end), (start, _) in zip(busy, busy[1:]):
        while i < len(ranges) and ranges[i][0] <= end:
            while stack and stack[-1][1] < ranges[i][0]:
                stack.pop()
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][1] < end:
            stack.pop()
        label = stack[-1][2] if stack else "other host work"
        gaps[label] = gaps.get(label, 0.0) + (start - end)
    return {
        "wall_s": wall,
        "ops": {k: [c, us * 1e-6] for k, (c, us) in ops.items()},
        "launches": sum(c for k, (c, _) in ops.items() if not k.startswith(NOT_LAUNCHES)),
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "device_ops": [[k, us * 1e-6] for k, (_, us) in
                       sorted(ops.items(), key=lambda kv: -kv[1][1])[:TOP]],
        "idle_gaps": [[k, us * 1e-6] for k, us in
                      sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]],
    }
