"""Bilinear parameter-texture fetch: CUDA kernel and its plain version.

Counterpart of nerftex_tpu/kernels/tex_gather.py (``sample_channel_quads_pallas``
and the gather path ``device._sample_channel_quads``).  ``sample_channel``
takes a [W, H] float32 channel (u indexes W, v from the bottom indexes H)
and uv [..., 2]; a CPU tensor goes to ``sample_channel_plain``, a CUDA
tensor to ``csrc/tex_fetch.cu``.
"""

import ctypes

import torch

from nerftex_torch.kernels import build


def sample_channel_plain(tex: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """The fetch in PyTorch ops: the JAX wrapper's index math, the four
    corners, then the lerp, each operation rounded separately."""
    w, h = tex.shape
    x = torch.clamp(uv[..., 0], 0, 1) * (w - 1)
    y = torch.clamp(uv[..., 1], 0, 1) * (h - 1)
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, max(w - 2, 0))
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, max(h - 2, 0))
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    fx = x - x0.to(x.dtype)
    fy = y - y0.to(y.dtype)
    flat = tex.reshape(-1)
    c0 = flat[x0 * h + y0] * (1 - fy) + flat[x0 * h + y1] * fy
    c1 = flat[x1 * h + y0] * (1 - fy) + flat[x1 * h + y1] * fy
    return c0 * (1 - fx) + c1 * fx


def _lib():
    lib = build.load("tex_fetch")
    lib.nt_tex_fetch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
    ]
    lib.nt_tex_fetch.restype = ctypes.c_int
    return lib


def sample_channel(tex: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear fetch of channel ``tex`` [W, H] at ``uv`` [..., 2] -> [...]."""
    if uv.device.type == "cpu":
        return sample_channel_plain(tex, uv)
    if uv.device.type != "cuda" or tex.device != uv.device:
        raise ValueError(f"tex on {tex.device}, uv on {uv.device}: need one CUDA device")
    if tex.dtype != torch.float32 or uv.dtype != torch.float32:
        raise TypeError("tex and uv must be float32")
    if tex.dim() != 2 or uv.shape[-1] != 2:
        raise ValueError(f"need tex [W, H] and uv [..., 2], got {tuple(tex.shape)}, {tuple(uv.shape)}")
    if not (tex.is_contiguous() and uv.is_contiguous()):
        raise ValueError("tex and uv must be contiguous")
    out = torch.empty(uv.shape[:-1], dtype=torch.float32, device=uv.device)
    n = out.numel()
    if n == 0:
        return out
    lib = _lib()
    rc = lib.nt_tex_fetch(
        tex.data_ptr(), tex.shape[0], tex.shape[1], uv.data_ptr(), out.data_ptr(), n,
        torch.cuda.current_stream(uv.device).cuda_stream,
    )
    build.check(lib, rc, "tex_fetch")
    sample_channel.launches += 1
    return out


sample_channel.launches = 0
