"""The model's FLOP rate as a share of the H100's dense TF32 peak (the
ceiling of any float32 product on the card): 2 x the multiply-adds of the
configured layer widths per sample, times the samples that entered
ParamNerf.infer, over the wall time of the traced run's unprofiled,
unsynchronised requests."""

from benchmark.harness import peaks
from benchmark.reference.mlp import flops_per_row


def read(trace):
    if trace.get("kind") != "session" or not trace["part1"]["rows"]:
        return None
    p = trace["part1"]
    return 100.0 * flops_per_row(trace["spec"]) * p["rows"] / p["wall_s"] / peaks.TF32_FLOPS
