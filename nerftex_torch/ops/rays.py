"""Camera and ray math (pinhole model, look-at).

Host twins of nerftex_tpu/data/ray_sampler.py ``rays_from_camera_np`` and
nerftex_tpu/data/dataset.py ``look_at_np``, plus ``frame_rays``, which
builds the ray batch of a full frame the way scripts/bench_render.py's
``ray_data`` does; ``rays_from_camera_device`` is the device version
(nerftex_tpu/ops/rays.py ``rays_from_camera``) that the serving path runs
on the card.
"""

import numpy as np
import torch

from nerftex_torch.ops.proxy import AABB
from nerftex_torch.utils import trace


def look_at(pos, to=np.zeros(3), offset=np.zeros(3), eps=1e-6) -> np.ndarray:
    """Camera-to-world 4x4 looking from ``pos`` at ``to``, z up."""
    pos = np.asarray(pos, np.float64)

    def _norm(v):
        return v / np.linalg.norm(v)

    v_forward = _norm(pos - to + eps)
    v_right = _norm(np.cross([0, 0, 1.0], v_forward) + eps)
    v_up = _norm(np.cross(v_forward, v_right) + eps)
    top = np.stack([v_right, v_up, v_forward, pos + offset], axis=1)
    return np.concatenate([top, [[0, 0, 0, 1.0]]], axis=0).astype(np.float32)


def rays_from_camera(image_plane_loc, height, width, focal, c2w):
    """Pixel coords [N, 2] (row, col) -> (rays_o [N,3], rays_d [N,3]
    unnormalized, cone_scale [N,1]); camera looks down -z."""
    image_plane_loc = np.asarray(image_plane_loc, np.float32)
    c2w = np.asarray(c2w, np.float32)
    dirs = np.stack(
        [
            (image_plane_loc[:, 1] + 0.5 - 0.5 * width) / focal,
            -(image_plane_loc[:, 0] + 0.5 - 0.5 * height) / focal,
            -np.ones(image_plane_loc.shape[0], np.float32),
        ],
        -1,
    )
    rays_d = np.sum(dirs[:, None, :] * c2w[:3, :3], -1)
    rays_o = np.broadcast_to(c2w[:3, -1], rays_d.shape)
    r_xy = np.linalg.norm(dirs[:, :2], axis=-1)
    cone_scale = np.cos(np.arctan(r_xy)) / np.linalg.norm(dirs, axis=-1) / focal
    return (rays_o.astype(np.float32), rays_d.astype(np.float32),
            cone_scale[:, None].astype(np.float32))


def rays_from_camera_device(image_plane_loc: torch.Tensor, height, width, focal, c2w):
    """``rays_from_camera`` in float32 on the device of ``image_plane_loc``
    ([N, 2] row, col): (rays_o, rays_d unnormalized, cone_scale [N, 1])."""
    loc = image_plane_loc.float()
    with trace.host_read("pose"):
        c2w = torch.as_tensor(np.asarray(c2w, np.float32), device=loc.device)
    focal = float(np.float32(focal))
    dirs = torch.stack([(loc[:, 1] + 0.5 - 0.5 * width) / focal,
                        -(loc[:, 0] + 0.5 - 0.5 * height) / focal,
                        -torch.ones_like(loc[:, 0])], -1)
    rays_d = torch.sum(dirs[:, None, :] * c2w[:3, :3], -1)
    rays_o = c2w[:3, -1].expand(rays_d.shape)
    r_xy = torch.linalg.norm(dirs[:, :2], dim=-1)
    cone_scale = torch.cos(torch.arctan(r_xy)) / torch.linalg.norm(dirs, dim=-1) / focal
    return rays_o, rays_d, cone_scale[:, None]


def frame_rays(h, w, eye, angle, parameters, proxy_b0=(-1.5, -1.5, -1.5),
               proxy_b1=(1.5, 1.5, 1.5), focal=None) -> dict:
    """Batch of one [h, w] frame: normalized rays from ``eye`` looking at
    the origin, proxy-box t, per-frame parameters [1, P] and cone scale,
    each with a leading batch axis of 1.

    The focal length defaults to ``w / np.tan(angle / 2) / 2``, a NumPy
    float64 that makes the pixel grid's arithmetic float64 (as
    scripts/bench_render.py's frame does); the JAX package's GenerateData
    datasets use a Python float there, which keeps it float32: pass
    ``focal=float(...)`` to build their rays."""
    if focal is None:
        focal = w / np.tan(angle / 2) / 2
    c2w = look_at(np.asarray(eye, np.float64))
    idx = np.arange(h * w)
    loc = np.stack([idx // w, idx % w], -1).astype(np.float32)
    rays_o, rays_d, cone = rays_from_camera(loc, h, w, focal, c2w)
    rays_d = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    t = AABB(proxy_b0, proxy_b1).intersect(rays_o, rays_d)
    return dict(rays_o=rays_o[None], rays_d=rays_d[None], t=t[None],
                parameters=np.asarray(parameters, np.float32).reshape(1, -1),
                cone_scale=cone[None])
