"""Pixel samplers: choose image-plane locations per image (the port's own
copy of nerftex_tpu/data/pixel_sampler.py).

Host numpy, drawing from the global numpy stream that utils/rng.set_seed
seeds, so the same seed picks the JAX package's pixels.  The Proxy
sampler caches each pose's hit mask."""

from typing import Any

import numpy as np

from nerftex_torch.ops.rays import rays_from_camera


class Full:
    """Every pixel, row-major (evaluation)."""

    def __init__(self, height: int, width: int, **kwargs) -> None:
        self.height = height
        self.width = width

    def __call__(self, **kwargs) -> np.ndarray:
        idx = np.arange(self.height * self.width)
        return np.stack([idx // self.width, idx % self.width], -1)


class Independent:
    """iid uniform pixels."""

    def __init__(self, height: int, width: int, n_samples: int, **kwargs) -> None:
        self.height = height
        self.width = width
        self.n_samples = n_samples

    def __call__(self, **kwargs) -> np.ndarray:
        i = np.random.randint(0, self.height, self.n_samples)
        j = np.random.randint(0, self.width, self.n_samples)
        return np.stack([i, j], -1)


class Proxy:
    """Only pixels whose rays hit the proxy, found on a downsampled grid and
    upsampled."""

    def __init__(self, height: int, width: int, n_samples: int, proxy: Any, focal: float,
                 downsample_factor: int = 8, **kwargs) -> None:
        self.height = height
        self.width = width
        self.n_samples = n_samples
        self.proxy = proxy
        self.downsample_factor = downsample_factor
        # Integer division of the focal length, as the reference does.
        self.focal = focal // downsample_factor
        self.height_down = height // downsample_factor
        self.width_down = width // downsample_factor
        self._mask_cache = {}

    def _hit_pixels(self, c2w) -> np.ndarray:
        key = np.asarray(c2w).tobytes()
        if key not in self._mask_cache:
            idx = np.arange(self.height_down * self.width_down)
            loc = np.stack([idx // self.width_down, idx % self.width_down], -1)
            rays_o, rays_d, _ = rays_from_camera(loc, self.height_down, self.width_down,
                                                 self.focal, c2w)
            t = self.proxy.intersect(rays_o, rays_d)
            hit = np.isfinite(t[:, 0]).reshape(self.height_down, self.width_down)
            if self.downsample_factor > 1:
                hit = np.repeat(np.repeat(hit, self.downsample_factor, 0),
                                self.downsample_factor, 1)
                hit = hit[: self.height, : self.width]
            self._mask_cache[key] = np.argwhere(hit)
        return self._mask_cache[key]

    def __call__(self, c2w, **kwargs) -> np.ndarray:
        idxs = self._hit_pixels(c2w)
        n_hits = idxs.shape[0]
        if n_hits == 0:
            # A pose that sees no proxy: uniform pixels instead.
            i = np.random.randint(0, self.height, self.n_samples)
            j = np.random.randint(0, self.width, self.n_samples)
            return np.stack([i, j], -1)
        choice = np.random.permutation(n_hits)
        if n_hits < self.n_samples:
            choice = np.concatenate(
                [choice, np.random.randint(0, n_hits, self.n_samples - n_hits)])
        return idxs[choice[: self.n_samples]]
