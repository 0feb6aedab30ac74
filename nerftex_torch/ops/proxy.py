"""Ray-march proxy: slab-test AABB intersection on the host.

Host twin of nerftex_tpu/ops/proxy.py ``AABB.intersect_np``: misses give
t = [inf, inf].  Used to build ray batches (see ops/rays.py).
"""

import numpy as np


class AABB:
    """Axis-aligned box [b_0, b_1]."""

    def __init__(self, b_0, b_1) -> None:
        self.b_0 = np.asarray(b_0, np.float32)
        self.b_1 = np.asarray(b_1, np.float32)

    def intersect(self, rays_o, rays_d) -> np.ndarray:
        """rays_o/rays_d [N, 3] -> t [N, 2] float32, inf on miss."""
        rays_o = np.asarray(rays_o, np.float32)
        rays_d = np.asarray(rays_d, np.float32)
        with np.errstate(divide="ignore", invalid="ignore"):
            inv_d = 1.0 / rays_d
            t_a = (self.b_0 - rays_o) * inv_d
            t_b = (self.b_1 - rays_o) * inv_d
        t_0 = np.minimum(t_a, t_b).max(-1)
        t_1 = np.maximum(t_a, t_b).min(-1)
        hit = t_0 < t_1
        return np.stack([np.where(hit, t_0, np.inf), np.where(hit, t_1, np.inf)], -1)
