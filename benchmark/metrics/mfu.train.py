"""The training step's model-FLOP rate as a share of the H100's dense TF32
peak: 3 x the forward FLOPs (2 x the multiply-adds of the configured layer
widths) of every sample of the steps (forward, and a backward of twice
its work), over the wall time of the traced run's unprofiled,
free-running steps, which closes with the last loss read back."""

from benchmark.harness import peaks
from benchmark.reference.mlp import flops_per_row


def read(trace):
    if trace.get("kind") != "train":
        return None
    p = trace["part1"]
    return 100.0 * 3 * flops_per_row(trace["spec"]) * p["samples"] / p["wall_s"] / peaks.TF32_FLOPS
