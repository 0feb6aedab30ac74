"""The share of the sorted blocks' sample slots (block rays x the block's
step count, the program's ``grid.samples``) that hold a valid sample
(``mlp.valid``, counted on the card where the block's MLP runs over every
slot and masks the rest), over the traced run's profiled frames: the rest
is padding that the per-sample stage and the MLP pay for.  Nothing for a
program that does not count ``mlp.valid``."""

from benchmark.harness import spans


def read(trace):
    got = spans.units(trace, "session", "session.render")
    if got is None:
        return None
    snap, ids = got
    if not any(c["name"] == "mlp.valid" and c["unit"] in ids for c in snap["counts"]):
        return None
    return spans.share(trace, "session", "session.render", "mlp.valid", ("grid.samples",))
