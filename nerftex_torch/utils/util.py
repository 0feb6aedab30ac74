"""Config runtime: reflection-based instantiation, attribute dicts, devices.

Configs are nested ``{'module': 'pkg.mod.Attr', **kwargs}`` dicts written
against the reference's module paths (``network.model.ParamNerf``, ...).
Those paths resolve to nerftex_tpu through the repo's shim packages, so
this runtime first maps them to the port's classes through ``REMAP``;
any other path is imported as written.
"""

import importlib
from typing import Any

import torch

# Reference config paths -> port classes.
REMAP = {
    "network.model.ParamNerf": "nerftex_torch.models.mlp.ParamNerf",
    "network.model.Nerf": "nerftex_torch.models.mlp.Nerf",
    "network.model.FourierFeatures": "nerftex_torch.models.encodings.FourierFeatures",
    "network.layer.FourierFeatures": "nerftex_torch.models.encodings.FourierFeatures",
    "network.renderer.InstanceRenderer": "nerftex_torch.render.instance_renderer.InstanceRenderer",
    "instancer.instancer.Instancer": "nerftex_torch.instancing.instancer.Instancer",
    "network.proxy.AABB": "nerftex_torch.ops.proxy.AABB",
    # GenerateData's default pose distribution names data.dist.
    "data.dist.Hemisphere": "nerftex_torch.data.distribution.Hemisphere",
}
REMAP.update({f"data.sampler.{name}": f"nerftex_torch.data.sampler.{name}"
              for name in ("Sampler", "Independent", "Constant", "Grid", "Stratified", "Concat")})
REMAP.update({f"data.distribution.{name}": f"nerftex_torch.data.distribution.{name}"
              for name in ("Distribution", "Sphere", "Hemisphere", "AABB", "Constant", "Range",
                           "Concat")})


def get_attr_from_module(module_name: str, attr_name: str) -> Any:
    module = importlib.import_module(module_name)
    return getattr(module, attr_name)


def get_attr_from_path(path: str) -> Any:
    """Resolve a dotted ``pkg.mod.Attr`` path (after ``REMAP``)."""
    path = REMAP.get(path, path)
    module_name, _, attr_name = path.rpartition(".")
    return get_attr_from_module(module_name, attr_name)


def instantiate(config: "dict | None", **extra) -> Any:
    """Call the target named by ``config['module']`` with the remaining keys
    (and ``extra``) as keyword arguments."""
    if config is None:
        return None
    args = EasyDict(config)
    target = args.pop("module")
    args.update(extra)
    return get_attr_from_path(target)(**args)


class EasyDict(dict):
    """dict subclass with attribute access; recursively wraps nested dicts."""

    def __init__(self, other: dict = ()) -> None:
        super().__init__()
        for key in other:
            value = other[key]
            if isinstance(value, dict) and not isinstance(value, EasyDict):
                value = EasyDict(value)
            self[key] = value

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError:
            raise AttributeError(key)

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __delattr__(self, key: str) -> None:
        del self[key]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else CUDA.
    Raises when no device is given and CUDA is absent, so nothing silently
    runs on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")
