"""The share of the traced run's profiled dispatch (a whole dispatch of the
configuration's steps, as the window runs them) in which no operation ran
on the device: 1 - busy / wall."""


def read(trace):
    if trace.get("kind") != "train_device":
        return None
    p = trace["part2"]
    return 100.0 * (1.0 - p["busy_s"] / p["wall_s"])
