"""Kernel launches per request in the traced run's profiled requests (the
chunk loop and the instancer's block loop launch most of them)."""


def read(trace):
    if trace.get("kind") != "session":
        return None
    p = trace["part2"]
    return p["launches"] / p["units"]
