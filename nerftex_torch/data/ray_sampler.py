"""Ray samplers: pixel coords -> world rays + near/far t + cone footprint
(the port's own copy of nerftex_tpu/data/ray_sampler.py).

They run on the host (numpy) in the dataset's prefetch pipeline and build
the rays with ops/rays.py ``rays_from_camera``, the numpy pinhole model
that ``frame_rays`` uses, so a dataset's rays are the JAX package's bit
for bit."""

from typing import Any

import numpy as np

from nerftex_torch.ops.rays import rays_from_camera


class Frustum:
    """Fixed near/far for every ray."""

    def __init__(self, height: int, width: int, focal: float, near: float, far: float,
                 **kwargs) -> None:
        self.height = height
        self.width = width
        self.focal = focal
        self.near = near
        self.far = far

    def __call__(self, image_plane_loc, c2w):
        n = image_plane_loc.shape[0]
        rays_o, rays_d, cone_scale = rays_from_camera(
            image_plane_loc, self.height, self.width, self.focal, c2w)
        t = np.stack([np.full(n, self.near, np.float32), np.full(n, self.far, np.float32)], -1)
        return rays_o, rays_d, t, cone_scale


class Proxy:
    """Near/far from the proxy's intersection; normalizes directions."""

    def __init__(self, height: int, width: int, focal: float, proxy: Any, **kwargs) -> None:
        self.height = height
        self.width = width
        self.focal = focal
        self.proxy = proxy

    def __call__(self, image_plane_loc, c2w):
        rays_o, rays_d, cone_scale = rays_from_camera(
            image_plane_loc, self.height, self.width, self.focal, c2w)
        rays_d = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
        t = self.proxy.intersect(rays_o, rays_d)
        return rays_o, rays_d.astype(np.float32), t.astype(np.float32), cone_scale
