"""Ray-march proxy: slab-test AABB intersection.

Counterpart of nerftex_tpu/ops/proxy.py ``AABB``: ``intersect`` is the
host twin (numpy, used to build ray batches, see ops/rays.py) and calling
the box runs the same slab test on tensors where they lie (the serving
path's device rays).  Misses give t = [inf, inf].
"""

import numpy as np
import torch

from nerftex_torch.utils import trace


class AABB:
    """Axis-aligned box [b_0, b_1]."""

    def __init__(self, b_0, b_1) -> None:
        self.b_0 = np.asarray(b_0, np.float32)
        self.b_1 = np.asarray(b_1, np.float32)
        self._on_device = {}

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

    def __call__(self, rays_o: torch.Tensor, rays_d: torch.Tensor) -> torch.Tensor:
        """The slab test on float32 tensors [..., 3] on their device -> t
        [..., 2].  The bounds are copied to a device once (a CUDA graph
        captures no host copy)."""
        if rays_o.device not in self._on_device:
            with trace.host_read("upload"):
                b_0 = torch.as_tensor(self.b_0, device=rays_o.device)
            with trace.host_read("upload"):
                b_1 = torch.as_tensor(self.b_1, device=rays_o.device)
            self._on_device[rays_o.device] = (b_0, b_1)
        b_0, b_1 = self._on_device[rays_o.device]
        inv_d = 1.0 / rays_d
        t_a = (b_0 - rays_o) * inv_d
        t_b = (b_1 - rays_o) * inv_d
        t_0 = torch.minimum(t_a, t_b).amax(-1)
        t_1 = torch.maximum(t_a, t_b).amin(-1)
        hit = t_0 < t_1
        return torch.stack([torch.where(hit, t_0, float("inf")),
                            torch.where(hit, t_1, float("inf"))], -1)
