"""mlp_fused's share of its roofline over the traced run's profiled
frames: the least time its launches could take, summed, over their summed
device time.  A launch's least time is the larger of its operations (2 x
the multiply-adds of the configured layer widths per row, without
padding) over the dense TF32 peak, and its bytes (each row's float32
inputs read once and its [4] float32 output written once, the weights and
biases once per launch) over the memory rate.  The count is of the
function, not of the kernel's 3 x TF32 design."""

from benchmark.harness import peaks
from benchmark.reference.mlp import flops_per_row, layer_shapes

KERNEL = "mlp_"     # mlp_tf32_kernel, mlp_wgmma_kernel: the kernels of mlp_fused.cu


def least_seconds(spec, rows):
    shapes = dict((n, (i, o)) for n, i, o in layer_shapes(spec))
    chain = [(i, o) for n, (i, o) in shapes.items() if not n.startswith("param_")]
    pos_dim = shapes["trunk/0"][0]
    dir_dim = (shapes["color_layers/0"][0] if spec["color_depth"] else shapes["pre_color"][0]) \
        - spec["width"]
    weight_bytes = 4 * sum(i * o + o for i, o in chain)
    ops = flops_per_row(spec) * rows
    nbytes = rows * (pos_dim + dir_dim) * 4 + rows * 16 + weight_bytes
    return max(ops / peaks.TF32_FLOPS, nbytes / peaks.BYTES_PER_S)


def read(trace):
    if trace.get("kind") != "session":
        return None
    p = trace["part2"]
    device = sum(s for name, (_, s) in p["ops"].items() if KERNEL in name)
    if not device or not p["mlp_launch_rows"]:
        return None
    least = sum(least_seconds(trace["spec"], r) for r in p["mlp_launch_rows"] if r)
    return 100.0 * least / device
