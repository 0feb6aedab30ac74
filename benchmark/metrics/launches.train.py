"""Kernel launches per step in the traced run's profiled steps (forward,
autograd backward, Adam)."""


def read(trace):
    if trace.get("kind") != "train":
        return None
    p = trace["part2"]
    return p["launches"] / p["units"]
