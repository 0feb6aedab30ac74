"""Weight transplant from the JAX package's parameter pytrees.

A JAX ParamNerf keeps its parameters as a pytree of numpy arrays (as
nerftex_tpu/render/checkpoint.py saves them): dense layers are
``{"w": [in, out], "b": [out]}`` under the keys ``trunk``, ``param_geo``,
``param_app`` and ``color_layers`` (lists) and ``alpha``, ``bottleneck``,
``pre_color`` and ``color``.  A flat mapping with ``/``-joined keys
(``"trunk/0/w"``, as ``flatten_params`` writes) is accepted too.
"""

import numpy as np
import torch

_LISTS = ("trunk", "param_geo", "param_app", "color_layers")
_SINGLE = ("alpha", "bottleneck", "pre_color", "color")


def flatten_params(tree: dict) -> dict:
    """{"trunk/0/w": array, ...} from a nested parameter pytree."""
    flat = {}
    for key in _LISTS:
        for i, layer in enumerate(tree.get(key, [])):
            for name in ("w", "b"):
                flat[f"{key}/{i}/{name}"] = np.asarray(layer[name])
    for key in _SINGLE:
        for name in ("w", "b"):
            flat[f"{key}/{name}"] = np.asarray(tree[key][name])
    return flat


@torch.no_grad()
def load_jax_params(model, tree) -> None:
    """Copy a JAX ParamNerf parameter tree into ``model`` (a
    nerftex_torch ParamNerf), transposing each ``w`` to nn.Linear's
    [out, in].  Shapes must match exactly; nothing is re-initialised."""
    flat = tree if any("/" in k for k in tree) else flatten_params(tree)
    targets = {}
    for key in _LISTS:
        for i, layer in enumerate(getattr(model, key)):
            targets[f"{key}/{i}"] = layer
    for key in _SINGLE:
        targets[key] = getattr(model, key)
    expected = {f"{k}/{n}" for k in targets for n in ("w", "b")}
    if set(flat) != expected:
        raise KeyError(f"parameter keys differ: missing {sorted(expected - set(flat))}, "
                       f"unexpected {sorted(set(flat) - expected)}")
    for key, layer in targets.items():
        w = torch.tensor(np.asarray(flat[f"{key}/w"], np.float32)).T
        b = torch.tensor(np.asarray(flat[f"{key}/b"], np.float32))
        if w.shape != layer.weight.shape or b.shape != layer.bias.shape:
            raise ValueError(f"{key}: got w {tuple(w.shape)} b {tuple(b.shape)}, model has "
                             f"{tuple(layer.weight.shape)} {tuple(layer.bias.shape)}")
        layer.weight.copy_(w)
        layer.bias.copy_(b)
