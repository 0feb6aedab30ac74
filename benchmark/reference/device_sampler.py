"""A plain reference of the device-resident training sampler: step s's
batch of a set of views, drawn from the step's key and worked out from
the views' images and cameras, in NumPy and PyTorch.

What it draws (NeRF-Tex's Proxy pixel sampler and Proxy ray sampler,
drawn per step as the JAX package's device path draws them): under the
step's key fold_in(fold_in(fold_in(key(seed), STREAM_DATA), 0), s), split
in three (k_img, k_cell, k_sub),

- B views uniform over the set's N, with replacement:
  randint(k_img, (B,), 0, N);
- per ray a cell of the view's grid downsampled by d, uniform over the
  cells whose centre ray meets the proxy box (the pinhole of the grid has
  the focal length floor(focal / d), and the ray is not normalised for
  the test): u = uniform(k_cell, (B, R)), the cell at position
  min(floor(u * count), count - 1) of the view's hit cells in raster
  order; a view that sees the box in no cell takes min(floor(u * cells),
  cells - 1) of all its cells;
- a pixel uniform within the cell: randint(k_sub, (B, R, 2), 0, d) added
  to the cell's row and column times d.

Each row is then worked out from the pixel and the view: the origin is
the camera's centre, the direction through the pixel's centre of a
pinhole of focal length focal (float32), normalised; the proxy box's
interval along it by the slab test (inf where it misses); the cone
footprint cos(atan(r)) / |dir| / focal of the camera-space direction
(r its distance from the axis); the color premultiplied by alpha, from
the u8 image / 255; alpha; the view's parameters.  The arithmetic is
float32 throughout, as the records store the camera and the angle.

randint is JAX's: two 32-bit draws per value from split(key)'s two keys,
hi % span * ((2^16 % span)^2 % span) + lo % span, reduced mod span, every
product and sum with uint32 wraparound.  It imports nothing of the
program.
"""

import math

import numpy as np
import torch

from benchmark.reference import jax_rng

STREAM_DATA = 6
_MASK = 0xFFFFFFFF


def step_key(seed: int, s: int) -> torch.Tensor:
    base = jax_rng.fold_in(jax_rng.fold_in(jax_rng.key(seed), STREAM_DATA), 0)
    return jax_rng.fold_in(base, s)


def randint(key, shape, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(key, shape, minval, maxval)`` as int64."""
    shape = tuple(int(x) for x in shape)
    span = max(int(maxval) - int(minval), 1)
    multiplier = ((2**16 % span) ** 2 & _MASK) % span
    k_hi, k_lo = jax_rng.split(key)
    counters = torch.arange(math.prod(shape), dtype=torch.int64)
    hi, lo = jax_rng.bits_at(k_hi, counters), jax_rng.bits_at(k_lo, counters)
    offset = ((((hi % span) * multiplier) & _MASK) + lo % span) & _MASK
    return (int(minval) + offset % span).reshape(shape).numpy()


def slab(o, d, b_0, b_1):
    """The box [b_0, b_1]'s interval [N, 2] along rays o + t d (float32),
    inf where the ray misses it."""
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.float32(1.0) / d
        t_a, t_b = (b_0 - o) * inv, (b_1 - o) * inv
    t0, t1 = np.minimum(t_a, t_b).max(-1), np.maximum(t_a, t_b).min(-1)
    hit = t0 < t1
    return np.stack([np.where(hit, t0, np.inf), np.where(hit, t1, np.inf)], -1).astype(np.float32)


def camera_dirs(loc, height, width, focal):
    """Camera-space directions [N, 3] through the centres of pixels loc
    [N, 2] (row, column), looking down -z."""
    loc = np.asarray(loc, np.float32)
    return np.stack([(loc[:, 1] + 0.5 - 0.5 * width) / focal,
                     -(loc[:, 0] + 0.5 - 0.5 * height) / focal,
                     -np.ones(len(loc), np.float32)], -1)


class ReferenceSampler:
    """The batches of a set of ``size`` x ``size`` views with float32
    cameras ``poses`` [N, 4, 4], ``parameters`` [N, P] and a horizontal
    field ``angle`` (as the records hold it); ``image(i)`` gives view i's
    straight-alpha RGBA as uint8 [size, size, 4]; ``proxy`` holds the box
    corners ``b_0`` and ``b_1``; B ``batchsize`` views of R ``n_rays`` rays
    a step, on a grid downsampled by ``downsample``."""

    def __init__(self, poses, parameters, size: int, angle: float, proxy: dict,
                 batchsize: int, n_rays: int, downsample: int, image):
        self.poses = np.asarray(poses, np.float32)
        self.parameters = np.asarray(parameters, np.float32)
        self.size, self.b, self.r, self.d = int(size), int(batchsize), int(n_rays), int(downsample)
        self.image = image
        self.b_0, self.b_1 = (np.asarray(proxy[k], np.float32) for k in ("b_0", "b_1"))
        # The focal length in double, then rounded to float32 for the rays.
        self.focal64 = self.size / math.tan(float(np.float32(angle)) / 2) / 2
        self.focal = float(np.float32(self.focal64))
        self._hits = {}

    def hit_cells(self, i: int) -> np.ndarray:
        """View i's hit cells of the downsampled grid, flat, in raster order."""
        if i not in self._hits:
            n = self.size // self.d
            cells = np.arange(n * n)
            dirs = camera_dirs(np.stack([cells // n, cells % n], -1), n, n,
                               self.focal64 // self.d)
            c2w = self.poses[i]
            d = np.sum(dirs[:, None, :] * c2w[:3, :3], -1)
            o = np.broadcast_to(c2w[:3, -1], d.shape)
            self._hits[i] = np.flatnonzero(np.isfinite(slab(o, d, self.b_0, self.b_1)[:, 0]))
        return self._hits[i]

    def draw(self, seed: int, s: int):
        """Step s's views img_idx [B] and pixels loc [B, R, 2] (row, column)."""
        k_img, k_cell, k_sub = jax_rng.split(step_key(seed, s), 3)
        img_idx = randint(k_img, (self.b,), 0, len(self.poses))
        u = jax_rng.uniform(k_cell, (self.b, self.r)).numpy()
        sub = randint(k_sub, (self.b, self.r, 2), 0, self.d)
        n = self.size // self.d
        loc = np.zeros((self.b, self.r, 2), np.int64)
        for b, i in enumerate(img_idx):
            hits = self.hit_cells(int(i))
            if hits.size:
                pick = np.minimum((u[b] * np.float32(hits.size)).astype(np.int64), hits.size - 1)
                cell = hits[pick]
            else:
                cell = np.minimum((u[b] * np.float32(n * n)).astype(np.int64), n * n - 1)
            loc[b, :, 0] = cell // n * self.d + sub[b, :, 0]
            loc[b, :, 1] = cell % n * self.d + sub[b, :, 1]
        return img_idx, loc

    def rows(self, i: int, loc) -> dict:
        """The rows of view i at pixels loc [R, 2]: rays_o, rays_d, t,
        cone_scale, color, alpha."""
        c2w = self.poses[i]
        dirs = camera_dirs(loc, self.size, self.size, self.focal)
        d = np.sum(dirs[:, None, :] * c2w[:3, :3], -1)
        o = np.broadcast_to(c2w[:3, -1], d.shape).astype(np.float32)
        cone = (np.cos(np.arctan(np.linalg.norm(dirs[:, :2], axis=-1)))
                / np.linalg.norm(dirs, axis=-1) / np.float32(self.focal))
        d = d / np.linalg.norm(d, axis=-1, keepdims=True)
        px = self.image(i)[loc[:, 0], loc[:, 1]].astype(np.float32) / np.float32(255.0)
        return {"rays_o": o, "rays_d": d.astype(np.float32), "t": slab(o, d, self.b_0, self.b_1),
                "cone_scale": cone[:, None].astype(np.float32), "color": px[:, :3] * px[:, 3:],
                "alpha": px[:, 3]}

    def batch(self, seed: int, s: int):
        """Step s's batch {rays_o, rays_d [B, R, 3], t [B, R, 2], cone_scale
        [B, R, 1], color [B, R, 3], alpha [B, R], parameters [B, P]} and
        its draw {img_idx [B], loc [B, R, 2]}."""
        img_idx, loc = self.draw(seed, s)
        rows = [self.rows(int(i), loc[b]) for b, i in enumerate(img_idx)]
        out = {k: np.stack([r[k] for r in rows]) for k in rows[0]}
        out["parameters"] = self.parameters[img_idx]
        return out, {"img_idx": img_idx, "loc": loc}
