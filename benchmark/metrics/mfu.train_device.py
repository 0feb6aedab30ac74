"""The device-resident training step's model-FLOP rate as a share of the
H100's dense bf16 peak (the configuration's products are bf16): 3 x the
forward FLOPs (2 x the multiply-adds of the configured layer widths) of
every sample of the steps (forward, and a backward of twice its work),
over the wall time of the traced run's whole dispatches, each closed by
its losses read back.  The step launches no kernel of its own (its GEMMs
are cuBLAS's; the fused MLP kernel serves the renderers only), so this
share of the whole step's peak stands in for a kernel's roofline."""

from benchmark.harness import peaks
from benchmark.reference.mlp import flops_per_row


def read(trace):
    if trace.get("kind") != "train_device":
        return None
    p = trace["part1"]
    return 100.0 * 3 * flops_per_row(trace["spec"]) * p["samples"] / p["wall_s"] / peaks.BF16_FLOPS
