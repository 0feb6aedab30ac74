"""The model's weights, made from the run's seed on its device.

One uniform draw of every weight and bias at once from a torch.Generator
on the device, then scaled per layer: each weight matrix to the Glorot
range of its fan-in and fan-out, each bias to +-BIAS, so that the biases,
which the upstream initialiser leaves at zero, take part in what the
check compares.  The trunk's relu features share a structure that
otherwise pushes most samples' densities to one sign for a given seed (an
empty frame for about a third of the seeds).  So the density head is then
set from PROBE random samples (local positions in [-1.5, 1.5]^3, unit
directions, parameters in [0, 1)): its weights scaled so that the probe
densities spread by 1, its bias so that their median is 0.  Every seed
then draws patches about half of whose samples carry a density of order
one.  The same float32 table goes to the program (as the checkpoint it
restores) and to the reference.
"""

import os
import pickle

import torch

from benchmark.reference.mlp import ReferenceMLP, layer_shapes

BIAS = 0.1
PROBE = 4096


def make_weights(spec: dict, seed: int, device) -> dict:
    """{"trunk/0/w": [in, out], "trunk/0/b": [out], ...} as float32 numpy."""
    shapes = layer_shapes(spec)
    total = sum(i * o + o for _, i, o in shapes)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    u = torch.rand(total, generator=gen, device=device) * 2 - 1
    out, off = {}, 0
    for name, i, o in shapes:
        w = u[off:off + i * o].view(i, o) * (6.0 / (i + o)) ** 0.5
        off += i * o
        b = u[off:off + o] * BIAS
        off += o
        out[f"{name}/w"], out[f"{name}/b"] = w, b
    n_prm = spec["n_geo"] + spec["n_app"]
    probe = torch.rand(PROBE, 6 + n_prm, generator=gen, device=device)
    out["alpha/b"] = torch.zeros_like(out["alpha/b"])
    _, density = ReferenceMLP(spec, out, device)(
        probe[:, :3] * 3 - 1.5, torch.nn.functional.normalize(probe[:, 3:6] - 0.5, dim=-1),
        probe[:, 6:])
    scale = 1.0 / density.std()
    out["alpha/w"] = out["alpha/w"] * scale
    out["alpha/b"] = -(density.median() * scale).reshape(1)
    return {k: v.cpu().numpy() for k, v in out.items()}


def write_checkpoint(weights: dict, directory: str, model_name: str = "model") -> str:
    """A restorable checkpoint of one model, <directory>/checkpoints/ckpt-0.pkl
    (a pickle of {"models": {name: flat weight mapping}})."""
    path = os.path.join(directory, "checkpoints")
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "ckpt-0.pkl"), "wb") as f:
        pickle.dump({"models": {model_name: weights}}, f, protocol=pickle.HIGHEST_PROTOCOL)
    return directory
