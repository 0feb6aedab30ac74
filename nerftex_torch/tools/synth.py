"""Synthetic swatch datasets: an analytic stand-in for the Blender renders
(the port's own copy of nerftex_tpu/tools/synth.py).

Parameter-conditioned images of an analytic volume, written as a TFRecord
with the reference's schema (image, pose, angle, parameters).  The field
follows the usual parameter layout [geometry..., appearance..., light
direction x3]: geometry scales the slab's height, appearance tints the
medium, the light direction shades it.  Two backends integrate it:

  - "numpy" (the default, ``render_swatch``): the same arguments write the
    same bytes as the JAX package's ``make_synthetic_tfrecord(backend=
    "numpy")``;
  - "torch" (``make_swatch_renderer``, the counterpart of the JAX
    package's ``make_swatch_renderer_jax``): the same integrator in plain
    torch on the card, one elementwise march per view, u8 RGBA back to the
    host; within 2 u8 levels of the numpy integrator.  It builds the
    full-scale datasets (512^2 x thousands of views), where the host
    integrator would take hours.

    python -m nerftex_torch.tools.synth out.tfr --n-images 32 --size 64
    python -m nerftex_torch.tools.synth out.tfr --n-images 5000 --size 512 \
        --backend torch --imgs-per-shard 100
"""

import io
import os

import numpy as np
import torch

from nerftex_torch.data import tfrecord as tfr
from nerftex_torch.data.distribution import Hemisphere
from nerftex_torch.ops.rays import look_at, rays_from_camera
from nerftex_torch.utils.image import encode_png
from nerftex_torch.utils.util import resolve_device


def slab_height(geo, b_0, b_1):
    """The slab's height, scaled by the first geometry parameter."""
    z0, z1 = b_0[2], b_1[2]
    return z0 + (0.25 + 0.65 * float(geo[0])) * (z1 - z0)


def field_density(pts, geo, b_0, b_1):
    """Soft slab whose height scales with the first geometry parameter."""
    height = slab_height(geo, b_0, b_1)
    in_xy = np.all((pts[..., :2] > b_0[:2]) & (pts[..., :2] < b_1[:2]), -1)
    sigma = 25.0 / (1.0 + np.exp(-12.0 * (height - pts[..., 2])))
    return sigma * in_xy


def color_terms(app, light):
    """field_color's per-view terms: the appearance-tinted base color [3]
    (float32) and the lambert-like shade against the light direction."""
    base = np.array([0.9, 0.55, 0.25], np.float32)
    if len(app) >= 1:
        base = base * (0.4 + 0.6 * float(app[0]))
    if len(app) >= 2:
        base = base ** (0.5 + float(app[1]))
    ambient = float(app[2]) if len(app) >= 3 else 0.15
    return base, ambient + 0.85 * max(0.0, -float(light[2]))


def field_color(pts, dirs, app, light):
    """Appearance-tinted lambert-like shading against the light direction."""
    base, shade = color_terms(app, light)
    stripes = 0.75 + 0.25 * np.sin(8.0 * pts[..., 0]) * np.sin(8.0 * pts[..., 1])
    return np.clip(base[None, :] * (shade * stripes)[..., None], 0, 1)


def aabb_intersect(rays_o, rays_d, b_0, b_1):
    """Slab test of float32 rays against the box [b_0, b_1] in the bounds'
    own precision (float64 here, unlike ops.proxy.AABB's float32) -> t
    [N, 2], inf on miss."""
    rays_o = np.asarray(rays_o, np.float32)
    rays_d = np.asarray(rays_d, np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv_d = 1.0 / rays_d
        t_a = (b_0 - rays_o) * inv_d
        t_b = (b_1 - rays_o) * inv_d
    t_0 = np.minimum(t_a, t_b).max(-1)
    t_1 = np.maximum(t_a, t_b).min(-1)
    hit = t_0 < t_1
    return np.stack([np.where(hit, t_0, np.inf), np.where(hit, t_1, np.inf)], -1)


def swatch_rays(pose, size, angle, b_0, b_1):
    """A size x size view's camera rays (rays_o, unit rays_d: float32
    [N, 3]) and where each enters and leaves the box (t0, t1: [N] in the
    bounds' precision, both 0 where it misses)."""
    focal = size / np.tan(angle / 2) / 2
    idx = np.arange(size * size)
    loc = np.stack([idx // size, idx % size], -1).astype(np.float32)
    rays_o, rays_d, _ = rays_from_camera(loc, size, size, focal, pose)
    rays_d = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)

    t = aabb_intersect(rays_o, rays_d, b_0, b_1)
    hit = np.isfinite(t[:, 0])
    return rays_o, rays_d, np.where(hit, t[:, 0], 0), np.where(hit, t[:, 1], 0)


def split_params(params, n_geo):
    """(geometry, appearance, light direction) of a view's parameters."""
    geo = params[:n_geo]
    app = params[n_geo:-3] if len(params) >= 3 else params[n_geo:]
    light = params[-3:] if len(params) >= 3 else np.array([0, 0, -1.0])
    return geo, app, light


def render_swatch(pose, params, n_geo, size, angle, b_0, b_1, n_steps=192):
    """Integrate the analytic field along camera rays -> straight RGBA
    [size, size, 4] in [0, 1]."""
    rays_o, rays_d, t0, t1 = swatch_rays(pose, size, angle, b_0, b_1)
    zs = t0[:, None] + (t1 - t0)[:, None] * np.linspace(0, 1, n_steps)[None]
    pts = rays_o[:, None, :] + rays_d[:, None, :] * zs[..., None]

    geo, app, light = split_params(params, n_geo)
    sigma = field_density(pts, geo, np.asarray(b_0), np.asarray(b_1))
    color = field_color(pts, rays_d, app, light)

    dists = np.diff(zs, axis=-1)
    dists = np.concatenate([dists, dists[:, -1:]], -1)
    alpha = 1 - np.exp(-sigma * dists)
    trans = np.cumprod(1 - alpha + 1e-10, -1)
    trans = np.concatenate([np.ones_like(trans[:, :1]), trans[:, :-1]], -1)
    w = alpha * trans

    rgb = (w[..., None] * color).sum(1)
    a = w.sum(1)
    rgba = np.concatenate([rgb, a[:, None]], -1).reshape(size, size, 4)
    # Zero the un-premultiplied color wherever alpha vanishes.
    rgba[..., :3] = np.where(
        rgba[..., 3:] > 1e-5, rgba[..., :3] / np.maximum(rgba[..., 3:], 1e-5), 0.0
    )
    return np.clip(rgba, 0, 1)


def make_swatch_renderer(size, angle, b_0, b_1, n_geo, n_steps=192, device=None):
    """The device backend (the counterpart of the JAX package's
    ``make_swatch_renderer_jax``): render(pose [4, 4], params [P]) -> u8
    RGBA [size, size, 4] on the host, as encode_png would quantise
    render_swatch's image.

    The march over the size^2 x n_steps samples (density, color,
    compositing) runs in plain torch on ``device`` (CUDA unless given;
    without a card that raises, nothing falls back to the CPU), in the
    dtypes render_swatch computes in: float64 from the sample positions
    on, as numpy promotes them.  The per-view inputs come from the host
    functions render_swatch calls (swatch_rays, slab_height,
    color_terms: [N, 3] rays and a few scalars).  Only the u8 image leaves
    the device.  (The JAX twin marches in float32, which TPUs offer; at a
    ray that grazes the box's side a sample's in-box test flips there
    with the last bit of its position, and the pixel moves by several
    levels.)"""
    device = resolve_device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the swatch renderer was asked for CUDA, and no CUDA device is "
                           "available; pass device='cpu' to run on the CPU")
    f64 = torch.float64
    b_0, b_1 = np.asarray(b_0), np.asarray(b_1)
    lo = torch.as_tensor(b_0[:2], dtype=f64, device=device)
    hi = torch.as_tensor(b_1[:2], dtype=f64, device=device)
    steps = torch.as_tensor(np.linspace(0, 1, n_steps), device=device)

    @torch.no_grad()
    def render(pose, params) -> np.ndarray:
        geo, app, light = split_params(params, n_geo)
        height = float(slab_height(geo, b_0, b_1))
        base, shade = color_terms(app, light)
        rays_o, rays_d, t0, t1 = (torch.as_tensor(v, device=device).to(f64)
                                  for v in swatch_rays(pose, size, angle, b_0, b_1))
        zs = t0[:, None] + (t1 - t0)[:, None] * steps[None]
        pts = rays_o[:, None, :] + rays_d[:, None, :] * zs[..., None]

        in_xy = torch.all((pts[..., :2] > lo) & (pts[..., :2] < hi), -1)
        sigma = 25.0 / (1.0 + torch.exp(-12.0 * (height - pts[..., 2]))) * in_xy
        stripes = 0.75 + 0.25 * torch.sin(8.0 * pts[..., 0]) * torch.sin(8.0 * pts[..., 1])
        base = torch.as_tensor(base, device=device).to(f64)
        color = torch.clamp(base * (shade * stripes)[..., None], 0, 1)

        dists = torch.diff(zs, dim=-1)
        dists = torch.cat([dists, dists[:, -1:]], -1)
        alpha = 1 - torch.exp(-sigma * dists)
        trans = torch.cumprod(1 - alpha + 1e-10, -1)
        trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], -1)
        w = alpha * trans

        rgb = (w[..., None] * color).sum(1)
        a = w.sum(1, keepdim=True)
        rgb = torch.where(a > 1e-5, rgb / torch.clamp(a, min=1e-5), 0.0)
        rgba = torch.clamp(torch.cat([rgb, a], -1), 0, 1).reshape(size, size, 4)
        return (rgba * 255.0 + 0.5).to(torch.uint8).cpu().numpy()

    return render


def swatch_views(n_images: int, n_parameters=(1, 6), radius: float = 5.0, seed: int = 0):
    """[(pose [4, 4] float32, parameters [P] float32)] of the n_images views
    make_synthetic_tfrecord renders from ``seed``: a camera on the upper
    hemisphere at ``radius`` looking at the origin, parameters uniform in
    [0, 1), the last three (with three or more appearance parameters) a
    downward light direction.  The global numpy stream is seeded for the
    draws and restored afterwards."""
    rs = np.random.RandomState(seed)
    np_state = np.random.get_state()
    np.random.seed(seed)
    try:
        hemi = Hemisphere()
        n_geo, n_app = n_parameters
        views = []
        for _ in range(n_images):
            pos = hemi() * radius
            pose = look_at(pos)
            params = rs.rand(n_geo + n_app).astype(np.float32)
            if n_app >= 3:
                light = hemi()
                params[-3:] = -light  # light direction points downward
            views.append((pose.astype(np.float32), params))
    finally:
        np.random.set_state(np_state)
    return views


def _encode_png_u8(arr: np.ndarray) -> bytes:
    """u8 RGBA [H, W, 4] -> PNG bytes."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr, "RGBA").save(buf, format="PNG")
    return buf.getvalue()


def make_synthetic_tfrecord(
    path,
    n_images: int = 32,
    size: int = 32,
    angle: float = 0.63,
    b_0=(-1.5, -1.3, -0.2),
    b_1=(1.3, 1.3, 1.9),
    n_parameters=(1, 6),
    radius: float = 5.0,
    seed: int = 0,
    backend: str = "numpy",
    imgs_per_shard: int = 0,
    progress_every: int = 0,
    device=None,
):
    """Write a reference-schema TFRecord of ``n_images`` analytic swatch
    renders of ``size`` x ``size`` from ``seed`` (swatch_views).
    backend "numpy" integrates on the host (render_swatch), "torch" on
    ``device`` (make_swatch_renderer: CUDA unless given); imgs_per_shard
    > 0 writes shards named as nerf2tfr names them; progress_every > 0
    prints a line every that many views."""
    if backend not in ("numpy", "torch"):
        raise ValueError(f"backend {backend!r}: 'numpy' or 'torch'")
    render = None
    if backend == "torch":
        render = make_swatch_renderer(size, angle, b_0, b_1, n_parameters[0], device=device)
    payloads = []
    for i, (pose, params) in enumerate(swatch_views(n_images, n_parameters, radius, seed)):
        if render is not None:
            png = _encode_png_u8(render(pose, params))
        else:
            png = encode_png(render_swatch(pose, params, n_parameters[0], size, angle,
                                           np.asarray(b_0), np.asarray(b_1)))
        payloads.append(tfr.build_example({
            "image": png,
            "pose": tfr.serialize_tensor(pose),
            "angle": float(angle),
            "parameters": tfr.serialize_tensor(params),
        }))
        if progress_every and (i + 1) % progress_every == 0:
            print(f"  synth {i + 1}/{n_images}", flush=True)

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if imgs_per_shard and imgs_per_shard > 0:
        base, ext = os.path.splitext(path)
        n_shards = -(-len(payloads) // imgs_per_shard)
        for s in range(n_shards):
            shard = f"{base}-{s:05d}-of-{n_shards:05d}{ext}"
            tfr.write_records(shard, payloads[s * imgs_per_shard:(s + 1) * imgs_per_shard])
    else:
        tfr.write_records(path, payloads)
    return path


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="Generate a synthetic swatch TFRecord.")
    ap.add_argument("out", help="output .tfr path")
    ap.add_argument("--n-images", type=int, default=128)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-parameters", type=int, nargs=2, default=(1, 6))
    ap.add_argument("--backend", default="numpy", choices=["numpy", "torch"],
                    help="torch: integrate on the card")
    ap.add_argument("--imgs-per-shard", type=int, default=0)
    args = ap.parse_args()
    make_synthetic_tfrecord(args.out, n_images=args.n_images, size=args.size, seed=args.seed,
                            n_parameters=tuple(args.n_parameters), backend=args.backend,
                            imgs_per_shard=args.imgs_per_shard, progress_every=100)
    print(args.out)
