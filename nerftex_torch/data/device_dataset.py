"""Device-resident training data (counterpart of
nerftex_tpu/data/device_dataset.py ``DeviceResidentSampler``): the whole
decoded dataset lives on the card and every per-step sampling op runs in
the training step, so a CUDA graph captures it with the rest of the step.

  * images are held once as uint8 [N, H, W, 4] for PNG sources (512^2 x
    5,000 views = 5.24 GB), decoded on the host once, with the
    ``u8 / 255 -> premultiply`` decode math of ``LazyTFRecordSource``
    replayed per sample on the card; other sources as float32
    (premultiplied color and alpha);
  * poses and parameters ride along as small float32 tables;
  * the Proxy pixel sampler's hit test is precomputed per pose into a
    padded table of hit cells of its downsampled grid.  The host sampler
    upsamples the hit mask by block repeat, so "uniform over hit pixels"
    is "uniform over hit cells x uniform within the d x d cell", and the
    card needs only [N, Hd*Wd] int32 of state;
  * rays and the proxy's near/far run in the step with the arithmetic of
    ``ops.rays.rays_from_camera`` in its order, so the values match the
    host pipeline to float32 rounding.

``sample_from(tables, key)`` draws as the JAX package's does (the same
threefry draws through utils.jax_rng): ``split(key, 3)``, then ``randint``
for the image, ``uniform`` for the cell and ``randint`` for the sub-pixel.
Like the JAX package's device path it picks images iid per step, not
through the host pipeline's shuffle buffer, and pixels iid within a draw.
The pixel gather computes its flat offsets in int64 (the 5.24 GB table is
past 2^31 bytes).

Set-up records a ``data.table`` span over the decode, the hit-cell tables
and the upload, and counts ``data.table_bytes`` (the image table's bytes)
and ``data.table_views`` (its views) under it (utils/trace.py).
"""

from typing import Any

import numpy as np
import torch

from nerftex_torch.data import pixel_sampler as px_mod
from nerftex_torch.data import ray_sampler as ray_mod
from nerftex_torch.data import tfrecord as tfr
from nerftex_torch.ops.rays import rays_from_camera
from nerftex_torch.utils import jax_rng, trace
from nerftex_torch.utils.image import decode_png_u8
from nerftex_torch.utils.util import resolve_device


class DeviceResidentSampler:
    """Device tables built from a record source, and training batches as a
    function of a key that reads nothing back to the host."""

    def __init__(
        self,
        source: Any,
        pixel_sampler: Any,
        ray_sampler: Any,
        batchsize: int,
        height: int,
        width: int,
        focal: float,
        composite_bkgd: bool,
        bkgd_color,
        max_bytes: int = 12 << 30,
        device=None,
    ):
        if isinstance(pixel_sampler, px_mod.Proxy):
            d = int(pixel_sampler.downsample_factor)
            if height % d or width % d:
                raise ValueError(
                    "device_resident Proxy sampling needs height/width divisible "
                    f"by downsample_factor (got {height}x{width}, factor {d}); "
                    "partial boundary cells would break cell-uniform sampling")
        elif isinstance(pixel_sampler, px_mod.Independent):
            d = 1
        else:
            raise ValueError(f"device_resident supports Proxy/Independent pixel samplers, "
                             f"got {type(pixel_sampler).__name__}")
        if not isinstance(ray_sampler, (ray_mod.Proxy, ray_mod.Frustum)):
            raise ValueError(f"device_resident supports Proxy/Frustum ray samplers, "
                             f"got {type(ray_sampler).__name__}")

        self.device = resolve_device(device)
        self.batchsize = int(batchsize)
        self.n_samples = int(pixel_sampler.n_samples)
        self.height = int(height)
        self.width = int(width)
        # The step divides by the focal length as a float32, as XLA does.
        self.focal = float(np.float32(focal))
        self.composite_bkgd = bool(composite_bkgd)
        self.downsample = d
        self._pixel_mode = "proxy" if isinstance(pixel_sampler, px_mod.Proxy) else "independent"
        self._ray_mode = "proxy" if isinstance(ray_sampler, ray_mod.Proxy) else "frustum"
        if self._ray_mode == "frustum":
            self._near = float(ray_sampler.near)
            self._far = float(ray_sampler.far)
            self._proxy = None
        else:
            self._proxy = ray_sampler.proxy

        n = len(source)
        with trace.span("data.table"):
            images, store = self._decode_all(source, n, max_bytes)
            poses, params = (np.stack(rows) for rows in zip(*(self._pose_params(source, i)
                                                              for i in range(n))))
            if self._pixel_mode == "proxy":
                cells, counts = self._hit_cell_tables(pixel_sampler, poses)
            else:
                cells = np.zeros((n, 1), np.int32)
                counts = np.zeros((n,), np.int32)  # count 0: uniform over all cells

            self._store = store
            dev = self.device
            self.images = torch.from_numpy(images).to(dev)
            self.poses = torch.from_numpy(poses).to(dev)
            self.parameters = torch.from_numpy(params).to(dev)
            self.cells = torch.from_numpy(cells).to(dev)
            self.counts = torch.from_numpy(counts).to(dev)
            self._bkgd = torch.as_tensor(np.asarray(bkgd_color, np.float32), device=dev)
            trace.count("data.table_bytes", images.nbytes)
            trace.count("data.table_views", n)
        self.n_images = n
        self.n_parameters = params.shape[-1]

    @property
    def tables(self) -> dict:
        """The device state the step samples from."""
        return {"images": self.images, "poses": self.poses, "parameters": self.parameters,
                "cells": self.cells, "counts": self.counts}

    # -- set-up ------------------------------------------------------------------

    @staticmethod
    def _pose_params(source, i):
        """Record i's pose [4, 4] and parameters [P] (float32); from a
        TFRecord without decoding its image."""
        examples = getattr(source, "examples", None)
        if examples is not None:
            return (tfr.parse_tensor(examples[i]["pose"]).astype(np.float32).reshape(4, 4),
                    tfr.parse_tensor(examples[i]["parameters"]).astype(np.float32).reshape(-1))
        rec = source[i]
        return (np.asarray(rec["pose"], np.float32),
                np.asarray(rec["parameters"], np.float32).reshape(-1))

    def _decode_all(self, source, n, max_bytes):
        """[N, H, W, 4] image table: uint8 straight alpha for PNG sources
        (the decode math replays in the step), float32 premultiplied for
        the rest."""
        h, w = self.height, self.width
        if getattr(source, "examples", None) is not None and not source.read_exr:
            need = n * h * w * 4
            if need > max_bytes:
                raise ValueError(f"dataset needs {need >> 20} MiB u8, over the "
                                 f"{max_bytes >> 20} MiB cap")
            images = np.empty((n, h, w, 4), np.uint8)
            for i in range(n):
                images[i] = decode_png_u8(source.examples[i]["image"])
            return images, "u8"

        need = n * h * w * 4 * 4
        if need > max_bytes:
            raise ValueError(f"float dataset needs {need >> 20} MiB on the card, over the "
                             f"{max_bytes >> 20} MiB cap — use the host pipeline")
        images = np.empty((n, h, w, 4), np.float32)
        for i in range(n):
            rec = source[i]
            images[i, ..., :3] = rec["image"]
            images[i, ..., 3] = rec["alpha"]
        return images, "f32"

    @staticmethod
    def _hit_cell_tables(sampler, poses):
        """Per pose, the flat indices of the downsampled grid's cells whose
        center ray hits the proxy: the mask ``pixel_sampler.Proxy`` computes
        before upsampling."""
        hd, wd, fd = sampler.height_down, sampler.width_down, sampler.focal
        idx = np.arange(hd * wd)
        loc = np.stack([idx // wd, idx % wd], -1)
        n = poses.shape[0]
        hits = np.zeros((n, hd * wd), bool)
        for i in range(n):
            rays_o, rays_d, _ = rays_from_camera(loc, hd, wd, fd, poses[i])
            hits[i] = np.isfinite(sampler.proxy.intersect(rays_o, rays_d)[:, 0])
        counts = hits.sum(-1).astype(np.int32)
        cells = np.zeros((n, max(1, int(counts.max()))), np.int32)
        for i in range(n):
            where = np.flatnonzero(hits[i])
            cells[i, : where.size] = where
        return cells, counts

    # -- the per-step sampling function ------------------------------------------

    def sample(self, key, with_aux: bool = False):
        """``sample_from`` with this sampler's tables."""
        return self.sample_from(self.tables, key, with_aux)

    def sample_from(self, tables: dict, key, with_aux: bool = False):
        """(tables, key) -> a training batch with the host pipeline's
        shapes: rays_o/rays_d [B,n,3], t [B,n,2], cone_scale [B,n,1],
        color [B,n,3], alpha [B,n], parameters [B,P], on the tables'
        device; images are drawn from all of ``tables``' rows.  with_aux=True
        also returns {img_idx [B], loc [B,n,2]}.
        ``key`` is a jax_rng key; on the tables' device nothing is read
        back to the host."""
        b, n = self.batchsize, self.n_samples
        h, w, d = self.height, self.width, self.downsample
        hd, wd = h // d, w // d
        dev = tables["images"].device

        k_img, k_cell, k_sub = jax_rng.split(key, 3)
        img_idx = jax_rng.randint(k_img, (b,), 0, tables["images"].shape[0], device=dev)

        counts = tables["counts"][img_idx][:, None]  # [B, 1]
        u = jax_rng.uniform(k_cell, (b, n), device=dev)
        # Uniform over the image's hit cells; a zero count (a pose that sees
        # no proxy, or the Independent sampler) is uniform over all cells,
        # as the host sampler falls back.
        pick = torch.minimum((u * counts).to(torch.int32), counts - 1)
        cell_hit = torch.gather(tables["cells"][img_idx], 1, pick.clamp_min(0).long())
        cell_all = torch.clamp_max((u * (hd * wd)).to(torch.int32), hd * wd - 1)
        cell = torch.where(counts > 0, cell_hit, cell_all).long()

        ci, cj = cell // wd, cell % wd
        if d > 1:
            sub = jax_rng.randint(k_sub, (b, n, 2), 0, d, device=dev)
            i = ci * d + sub[..., 0]
            j = cj * d + sub[..., 1]
        else:
            i, j = ci, cj

        # Rays: ops.rays.rays_from_camera's arithmetic, batched over poses.
        c2w = tables["poses"][img_idx]  # [B, 4, 4]
        loc = torch.stack([i, j], -1).float()
        dirs = torch.stack([(loc[..., 1] + 0.5 - 0.5 * w) / self.focal,
                            -(loc[..., 0] + 0.5 - 0.5 * h) / self.focal,
                            -torch.ones_like(loc[..., 0])], -1)  # [B, n, 3]
        rays_d = torch.sum(dirs[:, :, None, :] * c2w[:, None, :3, :3], -1)
        rays_o = c2w[:, None, :3, -1].expand(rays_d.shape)
        r_xy = torch.linalg.norm(dirs[..., :2], dim=-1)
        cone_scale = (torch.cos(torch.arctan(r_xy)) / torch.linalg.norm(dirs, dim=-1)
                      / self.focal)[..., None]

        if self._ray_mode == "proxy":
            rays_d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
            t = self._proxy(rays_o, rays_d)
        else:
            t = torch.stack([torch.full((b, n), self._near, device=dev),
                             torch.full((b, n), self._far, device=dev)], -1)

        # The pixel gather (flat int64 offsets) and LazyTFRecordSource's
        # decode math.
        flat = (img_idx[:, None] * h + i) * w + j
        images = tables["images"]
        px = images.reshape(-1, 4).index_select(0, flat.reshape(-1)).reshape(b, n, 4)
        if self._store == "u8":
            img_f = px.float() / 255.0
            rgb, a = img_f[..., :3], img_f[..., 3:]
            if self.composite_bkgd:
                color = rgb * a + (1 - a) * self._bkgd.to(dev)
            else:
                color = rgb * a
            alpha = img_f[..., 3]
        else:
            color = px[..., :3]
            alpha = px[..., 3]

        batch = {"rays_o": rays_o, "rays_d": rays_d, "t": t, "cone_scale": cone_scale,
                 "color": color, "alpha": alpha, "parameters": tables["parameters"][img_idx]}
        if with_aux:
            return batch, {"img_idx": img_idx, "loc": torch.stack([i, j], -1)}
        return batch
