"""Image interpolation and filtering in PyTorch (counterpart of
nerftex_tpu/ops/interpolate.py ``interpolate_img``, ``gaussian_kernel`` and
``filtered_downsample``).

The Dataset samples an image at float pixel locations with
``interpolate_img``; the eval Logger's ``downsampling_factor`` runs
``filtered_downsample``.  Each takes numpy arrays or tensors and computes
on the tensor's device (numpy inputs on the CPU)."""

import math

import torch
import torch.nn.functional as F


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def interpolate_img(x, y_ref) -> torch.Tensor:
    """Bilinear interpolation of image ``y_ref`` [H,W,C] at pixel coords
    ``x`` [N,2] (row, col) in [0,H-1]x[0,W-1]; corner indices out of range
    are clamped, as the JAX package does."""
    y_ref = torch.as_tensor(y_ref)
    x = _f32(x).to(y_ref.device)
    idx00 = torch.floor(x).long()
    w = x - torch.floor(x)
    h, wd = y_ref.shape[0], y_ref.shape[1]

    def gather(di, dj):
        ii = (idx00[:, 0] + di).clamp(0, h - 1)
        jj = (idx00[:, 1] + dj).clamp(0, wd - 1)
        return y_ref[ii, jj]

    w0, w1 = w[:, :1], w[:, 1:]
    return (gather(0, 0) * (1 - w0) * (1 - w1)
            + gather(1, 0) * w0 * (1 - w1)
            + gather(0, 1) * (1 - w0) * w1
            + gather(1, 1) * w0 * w1)


def gaussian_kernel(size: int, std: float, channels: int = 3) -> torch.Tensor:
    """Separable 2-D gaussian as a [size, size, channels, 1] depthwise
    filter (the JAX package's layout)."""
    x = torch.linspace(-(size - 1) / 2, (size - 1) / 2, size) + (0.5 if size % 2 == 0 else 0.0)
    k1 = torch.exp(-0.5 * (x / std) ** 2)
    k2 = torch.outer(k1, k1)
    k2 = k2 / k2.sum()
    return k2[:, :, None, None].repeat(1, 1, channels, 1)


def filtered_downsample(img, downsampling_factor: int, std: float = 0.5) -> torch.Tensor:
    """Gaussian lowpass + stride-downsample an [H,W,C] image, with XLA's
    "SAME" padding (zeros, the odd one after)."""
    img = _f32(img)
    h, w, c = img.shape
    f = int(downsampling_factor)
    size = int(downsampling_factor * std * 6)
    kernel = gaussian_kernel(size, downsampling_factor * std, c).to(img.device)
    weight = kernel[:, :, :, 0].permute(2, 0, 1)[:, None]          # [C, 1, size, size]

    def same(n):
        total = max((math.ceil(n / f) - 1) * f + size - n, 0)
        return total // 2, total - total // 2

    (top, bottom), (left, right) = same(h), same(w)
    x = F.pad(img.permute(2, 0, 1)[None], (left, right, top, bottom))
    return F.conv2d(x, weight, stride=f, groups=c)[0].permute(1, 2, 0)
