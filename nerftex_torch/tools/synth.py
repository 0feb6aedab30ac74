"""Synthetic swatch datasets: an analytic stand-in for the Blender renders
(the port's own copy of the numpy backend of nerftex_tpu/tools/synth.py).

Parameter-conditioned images of an analytic volume, written as a TFRecord
with the reference's schema (image, pose, angle, parameters).  The field
follows the usual parameter layout [geometry..., appearance..., light
direction x3]: geometry scales the slab's height, appearance tints the
medium, the light direction shades it.  The same arguments write the same
bytes as the JAX package's ``make_synthetic_tfrecord(backend="numpy")``.

    python -m nerftex_torch.tools.synth out.tfr --n-images 32 --size 64
"""

import os

import numpy as np

from nerftex_torch.data import tfrecord as tfr
from nerftex_torch.data.distribution import Hemisphere
from nerftex_torch.ops.rays import look_at, rays_from_camera
from nerftex_torch.utils.image import encode_png


def field_density(pts, geo, b_0, b_1):
    """Soft slab whose height scales with the first geometry parameter."""
    z0, z1 = b_0[2], b_1[2]
    height = z0 + (0.25 + 0.65 * float(geo[0])) * (z1 - z0)
    in_xy = np.all((pts[..., :2] > b_0[:2]) & (pts[..., :2] < b_1[:2]), -1)
    sigma = 25.0 / (1.0 + np.exp(-12.0 * (height - pts[..., 2])))
    return sigma * in_xy


def field_color(pts, dirs, app, light):
    """Appearance-tinted lambert-like shading against the light direction."""
    base = np.array([0.9, 0.55, 0.25], np.float32)
    if len(app) >= 1:
        base = base * (0.4 + 0.6 * float(app[0]))
    if len(app) >= 2:
        base = base ** (0.5 + float(app[1]))
    ambient = float(app[2]) if len(app) >= 3 else 0.15
    shade = ambient + 0.85 * max(0.0, -float(light[2]))
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


def render_swatch(pose, params, n_geo, size, angle, b_0, b_1, n_steps=192):
    """Integrate the analytic field along camera rays -> straight RGBA
    [size, size, 4] in [0, 1]."""
    focal = size / np.tan(angle / 2) / 2
    idx = np.arange(size * size)
    loc = np.stack([idx // size, idx % size], -1).astype(np.float32)
    rays_o, rays_d, _ = rays_from_camera(loc, size, size, focal, pose)
    rays_d = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)

    t = aabb_intersect(rays_o, rays_d, b_0, b_1)
    hit = np.isfinite(t[:, 0])
    t0 = np.where(hit, t[:, 0], 0)
    t1 = np.where(hit, t[:, 1], 0)

    zs = t0[:, None] + (t1 - t0)[:, None] * np.linspace(0, 1, n_steps)[None]
    pts = rays_o[:, None, :] + rays_d[:, None, :] * zs[..., None]

    geo = params[:n_geo]
    app = params[n_geo:-3] if len(params) >= 3 else params[n_geo:]
    light = params[-3:] if len(params) >= 3 else np.array([0, 0, -1.0])

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
    imgs_per_shard: int = 0,
):
    """Write a reference-schema TFRecord of ``n_images`` analytic swatch
    renders of ``size`` x ``size`` from ``seed`` (the global numpy stream
    is restored afterwards); imgs_per_shard > 0 writes shards named as
    nerf2tfr names them."""
    rs = np.random.RandomState(seed)
    np_state = np.random.get_state()
    np.random.seed(seed)
    try:
        hemi = Hemisphere()
        n_geo, n_app = n_parameters
        payloads = []
        for _ in range(n_images):
            pos = hemi() * radius
            pose = look_at(pos)
            params = rs.rand(n_geo + n_app).astype(np.float32)
            if n_app >= 3:
                light = hemi()
                params[-3:] = -light  # light direction points downward
            rgba = render_swatch(pose, params, n_geo, size, angle, np.asarray(b_0),
                                 np.asarray(b_1))
            payloads.append(tfr.build_example({
                "image": encode_png(rgba),
                "pose": tfr.serialize_tensor(pose.astype(np.float32)),
                "angle": float(angle),
                "parameters": tfr.serialize_tensor(params),
            }))
    finally:
        np.random.set_state(np_state)

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
    args = ap.parse_args()
    make_synthetic_tfrecord(args.out, n_images=args.n_images, size=args.size, seed=args.seed,
                            n_parameters=tuple(args.n_parameters))
    print(args.out)
