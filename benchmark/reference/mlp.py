"""The conditioned patch MLP (ParamNerf) in plain PyTorch, from its layer
widths and a weight table.

The model (NeRF-Tex, after NeRF): Fourier features [x, sin(2^k x),
cos(2^k x)] of the sample's local position (``pos_bands``), direction
(``dir_bands``) and parameters (``param_bands``, geometry and appearance
apart, each optionally through ``param_depth`` relu layers); a relu trunk
of ``depth`` layers of ``width`` with the position features joined again
after each layer in ``skips``; a density head and a linear bottleneck on
the trunk; then ``color_depth`` relu layers over [direction and
appearance features, bottleneck], a relu layer of width / 2 and the color
logits.  Weights are a flat mapping ``"trunk/0/w"`` ([in, out]) and
``"trunk/0/b"``, the layout the checkpoint holds.
"""

import torch

LISTS = ("param_geo", "param_app", "trunk", "color_layers")


def spec_of(model_config: dict) -> dict:
    """The widths of a ParamNerf model configuration, its defaults filled."""
    n = model_config["n_parameters"]
    n_geo, n_app = (n, 0) if isinstance(n, int) else (int(n[0]), int(n[1]))
    return {
        "n_geo": n_geo, "n_app": n_app, "n_pos": int(model_config.get("n_pos", 3)),
        "pos_bands": int(model_config["pos_embedding"]["n_freq_bands"]),
        "dir_bands": int(model_config["dir_embedding"]["n_freq_bands"]),
        "param_bands": int(model_config["param_embedding"]["n_freq_bands"]),
        "param_depth": int(model_config.get("param_depth", 0)),
        "param_width": int(model_config.get("param_width", 128)),
        "depth": int(model_config.get("depth", 8)),
        "width": int(model_config.get("width", 256)),
        "skips": tuple(model_config.get("skips", (4,))),
        "color_depth": int(model_config.get("color_depth", 1)),
    }


def layer_shapes(spec: dict) -> list:
    """[(name, fan_in, fan_out)] of every dense layer, in a fixed order."""
    layers = []
    pb, width = spec["param_bands"], spec["width"]

    def param_mlp(key, n):
        dim = n * (2 * pb + 1)
        for i in range(spec["param_depth"]):
            layers.append((f"{key}/{i}", dim, spec["param_width"]))
            dim = spec["param_width"]
        return dim if n > 0 else 0

    geo_dim = param_mlp("param_geo", spec["n_geo"])
    app_dim = param_mlp("param_app", spec["n_app"])
    pos_dim = spec["n_pos"] * (2 * spec["pos_bands"] + 1) + geo_dim
    dir_dim = 3 * (2 * spec["dir_bands"] + 1) + app_dim
    in_dim = pos_dim
    for i in range(spec["depth"]):
        layers.append((f"trunk/{i}", in_dim, width))
        in_dim = width + (pos_dim if i in spec["skips"] else 0)
    layers.append(("alpha", in_dim, 1))
    layers.append(("bottleneck", in_dim, width))
    in_dim = width + dir_dim
    for i in range(spec["color_depth"]):
        layers.append((f"color_layers/{i}", in_dim, width))
        in_dim = width
    layers.append(("pre_color", in_dim, width // 2))
    layers.append(("color", width // 2, 3))
    return layers


def flops_per_row(spec: dict) -> int:
    """Multiply-adds times two over every dense layer: the model's work for
    one sample, without padding."""
    return 2 * sum(i * o for _, i, o in layer_shapes(spec))


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, to nearest even), as float32."""
    bits = x.float().contiguous().view(torch.int32).to(torch.int64)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)
    return bits.to(torch.int32).view(torch.float32)


def fourier(x: torch.Tensor, n_bands: int) -> torch.Tensor:
    """[x, sin(2^k x), cos(2^k x)] with the bands of one component adjacent
    per band: column k * d + j holds 2^k x_j."""
    if n_bands == 0:
        return x
    scales = 2.0 ** torch.arange(n_bands, dtype=x.dtype, device=x.device)
    xs = (x[..., None, :] * scales[:, None]).reshape(*x.shape[:-1], n_bands * x.shape[-1])
    return torch.cat([x, torch.sin(xs), torch.cos(xs)], -1)


class ReferenceMLP:
    """ParamNerf's forward over float32 weights on one device.  ``tf32``
    rounds both operands of every product to TF32 (the lower-precision
    control)."""

    def __init__(self, spec: dict, weights: dict, device, tf32: bool = False):
        self.spec = spec
        self.tf32 = tf32
        self.w = {k: torch.as_tensor(v, dtype=torch.float32, device=device)
                  for k, v in weights.items()}

    def dense(self, name, parts, relu=True):
        x = torch.cat(parts, -1)
        w = self.w[f"{name}/w"]
        if self.tf32:
            x, w = round_tf32(x), round_tf32(w)
        y = x @ w + self.w[f"{name}/b"]
        return torch.relu(y) if relu else y

    def __call__(self, pos, dirs, prms):
        """(color logits [N, 3], density [N]) of N samples."""
        s = self.spec
        pos_parts = [fourier(pos, s["pos_bands"])]
        dir_parts = [fourier(dirs, s["dir_bands"])]
        for key, sl, parts in (("param_geo", slice(0, s["n_geo"]), pos_parts),
                               ("param_app", slice(s["n_geo"], s["n_geo"] + s["n_app"]),
                                dir_parts)):
            if sl.stop > sl.start:
                g = fourier(prms[:, sl], s["param_bands"])
                for i in range(s["param_depth"]):
                    g = self.dense(f"{key}/{i}", [g])
                parts.append(g)
        parts = list(pos_parts)
        for i in range(s["depth"]):
            h = self.dense(f"trunk/{i}", parts)
            parts = pos_parts + [h] if i in s["skips"] else [h]
        density = self.dense("alpha", parts, relu=False)[:, 0]
        h = self.dense("bottleneck", parts, relu=False)
        parts = dir_parts + [h]
        for i in range(s["color_depth"]):
            parts = [self.dense(f"color_layers/{i}", parts)]
        h = self.dense("pre_color", parts)
        return self.dense("color", [h], relu=False), density
