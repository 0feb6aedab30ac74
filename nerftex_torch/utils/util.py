"""Config runtime: reflection-based instantiation, attribute dicts, devices.

Configs are nested ``{'module': 'pkg.mod.Attr', **kwargs}`` dicts written
against the reference's module paths (``network.model.ParamNerf``, ...).
Those paths resolve to nerftex_tpu through the repo's shim packages, so
this runtime maps them to the port's classes through ``REMAP``.  A path
under a reference namespace (``network.``, ``data.``, ``instancer.``,
``util.``) that ``REMAP`` does not hold raises ``UnportedPathError``
rather than reach the JAX package through a shim; any other path is
imported as written.
"""

import importlib
import math
import subprocess
from typing import Any

import torch

from nerftex_torch.utils import trace

# Reference config paths -> port classes.
REMAP = {
    "network.model.ParamNerf": "nerftex_torch.models.mlp.ParamNerf",
    "network.model.Nerf": "nerftex_torch.models.mlp.Nerf",
    "network.model.CoarseFine": "nerftex_torch.models.mlp.CoarseFine",
    "network.model.FourierFeatures": "nerftex_torch.models.encodings.FourierFeatures",
    "network.layer.FourierFeatures": "nerftex_torch.models.encodings.FourierFeatures",
    "network.model.IntegratedPositionalEncoding":
        "nerftex_torch.models.encodings.IntegratedPositionalEncoding",
    "network.layer.IntegratedPositionalEncoding":
        "nerftex_torch.models.encodings.IntegratedPositionalEncoding",
    "network.renderer.Renderer": "nerftex_torch.render.renderer.Renderer",
    "network.renderer.InstanceRenderer": "nerftex_torch.render.instance_renderer.InstanceRenderer",
    "network.renderer.MipRenderer": "nerftex_torch.render.renderer.MipRenderer",
    "network.renderer.MipInstanceRenderer":
        "nerftex_torch.render.instance_renderer.MipInstanceRenderer",
    "instancer.instancer.Instancer": "nerftex_torch.instancing.instancer.Instancer",
    "network.proxy.AABB": "nerftex_torch.ops.proxy.AABB",
    # GenerateData's default pose distribution names data.dist.
    "data.dist.Hemisphere": "nerftex_torch.data.distribution.Hemisphere",
    "network.render.Render": "nerftex_torch.render.render.Render",
    "network.logger.Logger": "nerftex_torch.render.logger.Logger",
    "network.train.Train": "nerftex_torch.render.train.Train",
}
REMAP.update({f"network.loss.{name}": f"nerftex_torch.render.loss.{name}"
              for name in ("NerfLoss", "AlphaLoss", "mse", "smape")})
REMAP.update({f"network.dataset.{name}": f"nerftex_torch.data.dataset.{name}"
              for name in ("Dataset", "GenerateData", "FileFolder", "TFRecord")})
REMAP.update({f"network.pixel_sampler.{name}": f"nerftex_torch.data.pixel_sampler.{name}"
              for name in ("Full", "Independent", "Proxy")})
REMAP.update({f"network.ray_sampler.{name}": f"nerftex_torch.data.ray_sampler.{name}"
              for name in ("Frustum", "Proxy")})
REMAP.update({f"data.sampler.{name}": f"nerftex_torch.data.sampler.{name}"
              for name in ("Sampler", "Independent", "Constant", "Grid", "Stratified", "Concat")})
REMAP.update({f"data.distribution.{name}": f"nerftex_torch.data.distribution.{name}"
              for name in ("Distribution", "Sphere", "Hemisphere", "AABB", "Constant", "Range",
                           "Concat")})
# The offline dataset tools.
REMAP.update({f"data.blur.{name}": f"nerftex_torch.tools.blur.{name}"
              for name in ("process", "blur_png", "inv_cdf")})
REMAP["data.nerf2tfr.convert"] = "nerftex_torch.tools.nerf2tfr.convert"
REMAP["data.create_dataset.render_views"] = "nerftex_torch.tools.create_dataset.render_views"


def get_attr_from_module(module_name: str, attr_name: str) -> Any:
    module = importlib.import_module(module_name)
    return getattr(module, attr_name)


# The shim packages' namespaces: their paths resolve into nerftex_tpu.
REFERENCE_NAMESPACES = ("network", "data", "instancer", "util")


class UnportedPathError(NotImplementedError):
    """A reference module path that the port does not map (REMAP)."""


def get_attr_from_path(path: str) -> Any:
    """Resolve a dotted ``pkg.mod.Attr`` path (after ``REMAP``)."""
    if path in REMAP:
        path = REMAP[path]
    elif path.split(".")[0] in REFERENCE_NAMESPACES:
        raise UnportedPathError(
            f"{path!r} is a reference module path that nerftex_torch does not port yet "
            f"(nerftex_torch.utils.util.REMAP has no entry for it)")
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


def as_f32(x, device: torch.device) -> torch.Tensor:
    """``x`` (array-like or tensor) as a float32 tensor on ``device``.  A
    tensor already there is not copied; anything else is copied, a host
    read (utils/trace.py): a card waits for the stream to drain."""
    if isinstance(x, torch.Tensor) and x.device.type == device.type and (
            device.index is None or x.device.index == device.index):
        return x.to(torch.float32)
    with trace.host_read("copy"):
        return torch.as_tensor(x, dtype=torch.float32, device=device)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else the
    current CUDA device (the card a torch.distributed process is pinned
    to, parallel.init_distributed).  Raises when no device is given and
    CUDA is absent, so nothing silently runs on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


def format_name(prefix: str, idx: int, max_idx: int, suffix: str) -> str:
    """Zero-pad ``idx`` wide enough to fit ``max_idx``."""
    n_chars = max(1, math.ceil(math.log10(max_idx + 1)))
    return prefix + ("{:0" + str(n_chars) + "d}").format(idx) + suffix


def get_git_hash() -> str:
    """The short hash of the checkout's HEAD, or "unknown"."""
    try:
        return (
            subprocess.check_output(["git", "rev-parse", "--short", "HEAD"],
                                    stderr=subprocess.DEVNULL)
            .strip()
            .decode("utf-8")
        )
    except (OSError, subprocess.CalledProcessError):
        return "unknown"
