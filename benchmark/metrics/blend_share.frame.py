"""The share of the frame's shading that the blended overlap pick decides:
the valid samples (under the MLP's mask) whose ``nearest_blend`` pick
weighed two or more active instances (the program's ``pick.blend``, summed
on the card) over every valid sample (``mlp.valid``), over the traced
run's profiled frames.  Nothing for a program that does not count
``pick.blend``."""

from benchmark.harness import spans


def read(trace):
    got = spans.units(trace, "session", "session.render")
    if got is None:
        return None
    snap, ids = got
    if not any(c["name"] == "pick.blend" and c["unit"] in ids for c in snap["counts"]):
        return None
    return spans.share(trace, "session", "session.render", "pick.blend", ("mlp.valid",))
