"""Bilinear parameter-texture fetch: CUDA kernel and its plain versions.

Counterpart of nerftex_tpu/kernels/tex_gather.py (``sample_channel_quads_pallas``
and the gather path ``device._sample_channel_quads``).  ``sample_channel``
takes a [W, H] float32 channel (u indexes W, v from the bottom indexes H),
uv [..., 2] and, for a byte-valued channel, its quad table from
``byte_quads``.  A CPU tensor goes to the plain version of the variant the
arguments pick, a CUDA tensor to ``csrc/tex_fetch.cu``:

  byte_quad  quads given: one uchar4 of the four corner bytes per sample
             (``fetch_quads_plain`` on the CPU);
  f32        no quads: four loads from the f32 channel
             (``sample_channel_plain`` on the CPU).

Both give the same bits for a byte-valued channel.
"""

import numpy as np
import torch

from nerftex_torch.kernels import build

VARIANTS = {"byte_quad": 0, "f32": 1}
# b / 255 correctly rounded for every byte: the channel's texels as
# scene.load_texture_channels makes them (float32 division), and what the
# kernel computes (a reciprocal product corrected by one fma).
BYTE_VALUES = np.arange(256, dtype=np.float32) / np.float32(255.0)


def byte_quads(channel):
    """The byte-quad table of a [W, H] channel: uint8 [max(W-1, 1),
    max(H-1, 1), 4] holding, at (x0, y0), the bytes of the corners (x0, y0),
    (x0, y1), (x1, y0), (x1, y1) with x1 = min(x0 + 1, W - 1), likewise y1.
    On the channel's device; None when the channel is not exactly byte
    valued (rounding to bytes and back must give it to the bit)."""
    tex = torch.as_tensor(channel)
    c = tex.detach().cpu().numpy().astype(np.float32)
    if c.ndim != 2 or c.size == 0 or not np.isfinite(c).all():
        return None
    b = np.round(c.astype(np.float64) * 255.0)
    if b.min() < 0 or b.max() > 255:
        return None
    b = b.astype(np.uint8)
    if not np.array_equal(BYTE_VALUES[b], c):
        return None
    w, h = b.shape
    x0, y0 = np.arange(max(w - 1, 1)), np.arange(max(h - 1, 1))
    x1, y1 = np.minimum(x0 + 1, w - 1), np.minimum(y0 + 1, h - 1)
    quads = np.stack([b[x0][:, y0], b[x0][:, y1], b[x1][:, y0], b[x1][:, y1]], -1)
    return torch.tensor(np.ascontiguousarray(quads), device=tex.device)


def _footprint(w: int, h: int, uv: torch.Tensor):
    """The JAX wrapper's index math: corners x0, x1, y0, y1 and weights."""
    x = torch.clamp(uv[..., 0], 0, 1) * (w - 1)
    y = torch.clamp(uv[..., 1], 0, 1) * (h - 1)
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, max(w - 2, 0))
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, max(h - 2, 0))
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    return x0, x1, y0, y1, x - x0.to(x.dtype), y - y0.to(y.dtype)


def _lerp(q00, q01, q10, q11, fx, fy):
    c0 = q00 * (1 - fy) + q01 * fy
    c1 = q10 * (1 - fy) + q11 * fy
    return c0 * (1 - fx) + c1 * fx


def sample_channel_plain(tex: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """The fetch in PyTorch ops: the JAX wrapper's index math, the four
    corners, then the lerp, each operation rounded separately."""
    w, h = tex.shape
    x0, x1, y0, y1, fx, fy = _footprint(w, h, uv)
    flat = tex.reshape(-1)
    return _lerp(flat[x0 * h + y0], flat[x0 * h + y1], flat[x1 * h + y0], flat[x1 * h + y1],
                 fx, fy)


def fetch_quads_plain(quads: torch.Tensor, w: int, h: int, uv: torch.Tensor) -> torch.Tensor:
    """The byte_quad variant in PyTorch ops: one gather of the footprint's
    four bytes, each turned into b / 255 by table, then the same lerp."""
    x0, _, y0, _, fx, fy = _footprint(w, h, uv)
    q = quads.reshape(-1, 4)[x0 * quads.shape[1] + y0].long()
    val = torch.tensor(BYTE_VALUES, device=uv.device)[q]
    return _lerp(val[..., 0], val[..., 1], val[..., 2], val[..., 3], fx, fy)


def sample_channel(tex: torch.Tensor, uv: torch.Tensor, quads: torch.Tensor = None) -> torch.Tensor:
    """Bilinear fetch of channel ``tex`` [W, H] at ``uv`` [..., 2] -> [...],
    through ``quads`` (``byte_quads(tex)``) when given."""
    w, h = tex.shape
    if uv.device.type == "cpu":
        if quads is None:
            return sample_channel_plain(tex, uv)
        return fetch_quads_plain(quads, w, h, uv)
    table = tex if quads is None else quads
    if uv.device.type != "cuda" or table.device != uv.device:
        raise ValueError(f"texture table on {table.device}, uv on {uv.device}: need one CUDA device")
    if tex.dtype != torch.float32 or uv.dtype != torch.float32:
        raise TypeError("tex and uv must be float32")
    if quads is not None and (quads.dtype != torch.uint8
                              or tuple(quads.shape) != (max(w - 1, 1), max(h - 1, 1), 4)):
        raise ValueError(f"quads must be uint8 [{max(w - 1, 1)}, {max(h - 1, 1)}, 4], "
                         f"got {quads.dtype} {tuple(quads.shape)}")
    if tex.dim() != 2 or uv.shape[-1] != 2:
        raise ValueError(f"need tex [W, H] and uv [..., 2], got {tuple(tex.shape)}, {tuple(uv.shape)}")
    if not (table.is_contiguous() and uv.is_contiguous()) or uv.data_ptr() % 8:
        raise ValueError("the texture table and uv must be contiguous, uv 8-byte aligned")
    out = torch.empty(uv.shape[:-1], dtype=torch.float32, device=uv.device)
    n = out.numel()
    if n == 0:
        return out
    variant = "f32" if quads is None else "byte_quad"
    rc = build.entry("tex_fetch")(
        VARIANTS[variant], table.data_ptr(), w, h, uv.data_ptr(), out.data_ptr(), n,
        torch.cuda.current_stream(uv.device).cuda_stream,
    )
    build.check("tex_fetch", rc)
    sample_channel.launches += 1
    sample_channel.variant_launches[variant] += 1
    return out


sample_channel.launches = 0
sample_channel.variant_launches = dict.fromkeys(VARIANTS, 0)
