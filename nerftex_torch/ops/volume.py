"""Volume-rendering primitives (counterpart of nerftex_tpu/ops/volume.py)."""

import torch


def map_color(color_logits: torch.Tensor, map_exr: bool) -> torch.Tensor:
    """Color head mapping: sigmoid to [0, 1], or elu + 1 for HDR/EXR."""
    if map_exr:
        return torch.nn.functional.elu(color_logits) + 1.0
    return torch.sigmoid(color_logits)


def exclusive_cumprod(x: torch.Tensor) -> torch.Tensor:
    """cumprod shifted right with a leading 1 (tf exclusive=True)."""
    return torch.cat([torch.ones_like(x[..., :1]), torch.cumprod(x[..., :-1], -1)], -1)


def mean_distance(mu, hw):
    """Mean distance of a cone segment (use_mean_distance)."""
    return mu + 2 * mu * hw**2 / (3 * mu**2 + hw**2)


def composite_precomputed_alpha(
    color_logits: torch.Tensor,
    density: torch.Tensor,
    dists: torch.Tensor,
    color_last: torch.Tensor,
    alpha_last: torch.Tensor,
    patch_scale: float,
    composite_bkgd: bool = False,
    bkgd_color=(1.0, 1.0, 1.0),
    map_exr: bool = False,
):
    """Instance-renderer compositing: per-sample world-space dists, a
    terminator sample appended, density divided by patch_scale.

    color_logits [R,S,3], density [R,S], dists [R,S], color_last [R,1,3],
    alpha_last [R,1] -> (color_map [R,3], alpha_map [R])."""
    color_map = torch.cat([map_color(color_logits, map_exr), color_last], 1)
    alpha = 1.0 - torch.exp(-torch.relu(density) * dists / patch_scale)
    alpha_map = torch.cat([alpha, alpha_last], 1)
    # The +1e-10 guard keeps the transmittance of an opaque sample nonzero;
    # for alpha == 0 it rounds to exactly 1.0 in float32.
    weights = alpha_map * exclusive_cumprod(1.0 - alpha_map + 1e-10)
    color_out = torch.sum(weights[..., None] * color_map, -2)
    alpha_out = torch.sum(weights, -1)
    if composite_bkgd:
        bkgd = torch.as_tensor(bkgd_color, dtype=torch.float32, device=color_out.device)
        color_out = color_out + (1.0 - alpha_out[..., None]) * bkgd
    return color_out, alpha_out
