"""Volume-rendering primitives (counterpart of nerftex_tpu/ops/volume.py):
stratified sampling, alpha compositing, inverse-CDF importance sampling,
and mip-NeRF's cone Gaussians.
Random draws come from utils.jax_rng keys, so they are the JAX package's
for the same key.  Each drawing function takes ``rows``: the rays' rows in
a larger batch (a data-parallel shard's global rows), whose draws they
then take; None is rows 0 .. R - 1."""

import torch

from nerftex_torch.utils import jax_rng
from nerftex_torch.utils.util import as_f32


def stratified_z_vals(t: torch.Tensor, n_samples: int, perturb: bool, key=None,
                      rows=None) -> torch.Tensor:
    """Evenly spaced samples in [t0, t1] per ray, with perturb jittered
    uniformly within their bins by ``uniform(key, [R, n_samples])``.  t
    [R, 2] (misses sanitized by the caller) -> z_vals [R, n_samples]."""
    t_vals = torch.linspace(0.0, 1.0, n_samples, dtype=torch.float32, device=t.device)
    z_vals = t[:, None, 0] * (1 - t_vals) + t[:, None, 1] * t_vals
    if perturb:
        mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        upper = torch.cat([mids, z_vals[..., -1:]], -1)
        lower = torch.cat([z_vals[..., :1], mids], -1)
        z_rand = jax_rng.uniform(key, z_vals.shape, device=t.device, rows=rows)
        z_vals = lower + (upper - lower) * z_rand
    return z_vals


def map_color(color_logits: torch.Tensor, map_exr: bool) -> torch.Tensor:
    """Color head mapping: sigmoid to [0, 1], or elu + 1 for HDR/EXR."""
    if map_exr:
        return torch.nn.functional.elu(color_logits) + 1.0
    return torch.sigmoid(color_logits)


class _CumprodNonzero(torch.autograd.Function):
    """torch.cumprod over the last axis of a tensor with no zero element,
    with the gradient torch.cumprod takes for such input (the reversed
    cumulative sum of grad * output, divided by the input).  torch's own
    backward first tests the input for zeros and reads the answer back to
    the host, which a CUDA graph cannot capture."""

    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, -1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        return torch.flip(torch.cumsum(torch.flip(out * grad, [-1]), -1), [-1]).div(x)


def exclusive_cumprod(x: torch.Tensor) -> torch.Tensor:
    """cumprod shifted right with a leading 1 (tf exclusive=True) of a
    tensor with no zero element (the transmittances 1 - alpha + 1e-10)."""
    return torch.cat([torch.ones_like(x[..., :1]), _CumprodNonzero.apply(x[..., :-1])], -1)


def composite(color_logits, density_logits, z_vals, rays_d, composite_bkgd: bool = False,
              bkgd_color=(1.0, 1.0, 1.0), raw_noise_std: float = 0.0, noise_key=None,
              map_exr: bool = False, repeat_last_dist: bool = True, rows=None):
    """Alpha-composite per-sample model outputs along rays.

    color_logits [R,S,3], density_logits [R,S], z_vals [R,S] (or S + 1 fence
    posts without repeat_last_dist), rays_d [R,3].  The last step repeats
    the one before it; density noise is ``normal(noise_key, [R,S]) *
    raw_noise_std``.  Returns (color [R,3], alpha [R], weights [R,S],
    depth [R])."""
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    if repeat_last_dist:
        dists = torch.cat([dists, dists[..., -1:]], -1)
        z_mid = z_vals
    else:
        z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    dists = dists * torch.linalg.norm(rays_d[..., None, :], dim=-1)
    color_map = map_color(color_logits, map_exr)
    if raw_noise_std > 0:
        noise = jax_rng.normal(noise_key, density_logits.shape, density_logits.device, rows=rows)
        density_logits = density_logits + noise * raw_noise_std
    alpha = 1.0 - torch.exp(-torch.relu(density_logits) * dists)
    weights = alpha * exclusive_cumprod(1.0 - alpha + 1e-10)
    color_out = torch.sum(weights[..., None] * color_map, -2)
    depth_out = torch.sum(weights * z_mid, -1)
    alpha_out = torch.sum(weights, -1)
    if composite_bkgd:
        bkgd = as_f32(bkgd_color, color_out.device)
        color_out = color_out + (1.0 - alpha_out[..., None]) * bkgd
    return color_out, alpha_out, weights, depth_out


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int, det: bool = False,
               key=None, rows=None) -> torch.Tensor:
    """Inverse-CDF samples of the piecewise-constant pdf ``weights`` [R,B-1]
    over ``bins`` [R,B] -> [R, n_samples]: evenly spaced quantiles with
    ``det``, else ``uniform(key, [R, n_samples])``."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, -1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)
    shape = cdf.shape[:-1] + (n_samples,)
    if det:
        u = torch.linspace(0.0, 1.0, n_samples, dtype=torch.float32, device=cdf.device)
        u = u.expand(shape).contiguous()
    else:
        u = jax_rng.uniform(key, shape, device=cdf.device, rows=rows)
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(bins, -1, below)
    bins_above = torch.gather(bins, -1, above)
    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    frac = (u - cdf_below) / denom
    return bins_below + frac * (bins_above - bins_below)


def _cone_moments(mu, hw):
    """(t_var, r_var / radius^2) of conical frustums at distance mu with
    half-width hw.  A degenerate segment (mu = hw = 0: a proxy-missing ray
    whose t was zeroed) makes every term 0/0; den_raw is 0 exactly there
    (both its terms are non-negative), and den = 1 in its place makes each
    term, and its gradient, exactly 0 instead of NaN, while every other
    segment, however small, keeps the formula bit for bit."""
    den_raw = 3 * mu**2 + hw**2
    den = torch.where(den_raw == 0.0, torch.ones_like(den_raw), den_raw)
    t_var = (hw**2) / 3 - (4 / 15) * ((hw**4 * (12 * mu**2 - hw**2)) / den**2)
    r_var = (mu**2) / 4 + (5 / 12) * hw**2 - 4 / 15 * (hw**4) / den
    return den, t_var, r_var


def _null_outer_diag(rays_d):
    """(d * d, the diagonal of 1 - d d^T / |d|^2) per direction [..., 3]."""
    d_mag_sq = torch.clamp(torch.sum(rays_d**2, -1, keepdim=True), min=1e-10)
    d_outer_diag = rays_d**2
    return d_outer_diag, 1 - d_outer_diag / d_mag_sq


def cone_segment_gaussians(rays_o, rays_d, t_vals, radii):
    """mip-NeRF conical-frustum Gaussians per segment: t_vals [R, S+1]
    fence posts, radii [R, 1] -> (mean [R, S, 3], diagonal covariance
    [R, S, 3])."""
    t0 = t_vals[..., :-1]
    t1 = t_vals[..., 1:]
    mu = (t0 + t1) / 2
    hw = (t1 - t0) / 2
    den, t_var, r_var = _cone_moments(mu, hw)
    t_mean = mu + (2 * mu * hw**2) / den
    r_var = radii**2 * r_var
    mean = rays_o[..., None, :] + rays_d[..., None, :] * t_mean[..., None]
    d_outer_diag, null_outer_diag = _null_outer_diag(rays_d)
    t_cov_diag = t_var[..., None] * d_outer_diag[..., None, :]
    xy_cov_diag = r_var[..., None] * null_outer_diag[..., None, :]
    return mean, t_cov_diag + xy_cov_diag


def cone_sample_cov(rays_d, t_vals, radii, dists):
    """Per-sample cone covariance of the instanced mip path: rays_d [N, 3],
    t_vals, radii and dists (the half-widths) [N] -> [N, 3]."""
    _, t_var, r_var = _cone_moments(t_vals, dists)
    r_var = radii**2 * r_var
    d_outer_diag, null_outer_diag = _null_outer_diag(rays_d)
    return t_var[:, None] * d_outer_diag + r_var[:, None] * null_outer_diag


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
    raw_noise_std: float = 0.0,
    noise_key=None,
    map_exr: bool = False,
    false_color: torch.Tensor = None,
    noise_width: int = None,
):
    """Instance-renderer compositing: per-sample world-space dists, a
    terminator sample appended, density divided by patch_scale.

    color_logits [R,S,3], density [R,S], dists [R,S], color_last [R,1,3],
    alpha_last [R,1] -> (color_map [R,3], alpha_map [R]).  The density
    noise is ``normal(noise_key, [R,S]) * raw_noise_std``, added before the
    relu (with ``noise_width``, the first S columns of the draw over [R,
    noise_width]); a given ``false_color`` [R,S,3] replaces the mapped
    colors."""
    if false_color is None:
        false_color = map_color(color_logits, map_exr)
    color_map = torch.cat([false_color, color_last], 1)
    if raw_noise_std > 0:
        noise = jax_rng.normal(noise_key, density.shape, density.device, full_width=noise_width)
        density = density + noise * raw_noise_std
    alpha = 1.0 - torch.exp(-torch.relu(density) * dists / patch_scale)
    alpha_map = torch.cat([alpha, alpha_last], 1)
    # The +1e-10 guard keeps the transmittance of an opaque sample nonzero;
    # for alpha == 0 it rounds to exactly 1.0 in float32.
    weights = alpha_map * exclusive_cumprod(1.0 - alpha_map + 1e-10)
    color_out = torch.sum(weights[..., None] * color_map, -2)
    alpha_out = torch.sum(weights, -1)
    if composite_bkgd:
        bkgd = as_f32(bkgd_color, color_out.device)
        color_out = color_out + (1.0 - alpha_out[..., None]) * bkgd
    return color_out, alpha_out
