"""Fused ParamNerf inference MLP: CUDA kernel and its plain version.

Counterpart of nerftex_tpu/kernels/mlp_pallas.py (``make_fused_apply``).
``pack`` lays a ParamNerf's dense chain out as a layer table plus flat,
zero-padded weights; ``mlp_fused(pos_map, dir_map, packed)`` runs the chain
on a CPU tensor with ``mlp_fused_plain`` and on a CUDA tensor with
``csrc/mlp_fused.cu``, whose variant follows ``packed.dtype``:

  wgmma_bf16    bf16 operands, warp-specialised wgmma over ``packed.slabs``;
  wgmma_tf32x3  f32 operands, the same skeleton with every product split
                into three TF32 wgmmas (a_lo w_hi + a_hi w_lo + a_hi w_hi)
                over ``packed.tf32_slabs``, which keeps f32 accuracy.

Both compute each layer with f32 accumulation over ``packed.dtype``
operands and round every layer's output to that dtype.
"""

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from nerftex_torch.kernels import build

BUF_POS, BUF_DIR, BUF_HA, BUF_HB, OUT = 0, 1, 2, 3, -1
MAX_WIDTH = 256
MAX_LAYERS = 32
VARIANTS = {torch.bfloat16: "wgmma_bf16", torch.float32: "wgmma_tf32x3"}
# The order of the 8 K rows of each block in the tf32 image: K index m of a
# wgmma step reads weight row TF32_ROW_ORDER[m], so a thread's A-fragment
# indices l%4 and l%4 + 4 are the adjacent activation columns 2(l%4), +1.
TF32_ROW_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass
class PackedMLP:
    dtype: torch.dtype
    weights: torch.Tensor     # flat [sum K_pad * n_pad] in dtype, each layer row-major
    biases: torch.Tensor      # flat [sum n_pad] f32 (dtype-rounded values)
    table: np.ndarray         # [n_layers, 11] int64, LayerDesc order, C-contiguous
    pos_dim: int
    dir_dim: int
    pos_pad: int
    dir_pad: int
    macs: int                 # multiply-adds per sample at the real widths
    # bf16 only: the same weights at the same offsets, each layer laid out
    # [K_pad / 8][n_pad][8] (wgmma's K-major core matrices, no swizzle), so
    # every 64-deep K slab is one contiguous block for the kernel's bulk copy.
    slabs: Optional[torch.Tensor] = None
    # f32 only: each layer's weights split into tf32 hi and lo (tf32_split)
    # at twice its offset, every block of 8 K rows (in TF32_ROW_ORDER) laid
    # out as hi [2][n_pad][4] then lo [2][n_pad][4] (TF32 core matrices), so
    # every 16-deep K slab of both is one contiguous block.
    tf32_slabs: Optional[torch.Tensor] = None


def slab_image(w: torch.Tensor) -> torch.Tensor:
    """[K_pad, n_pad] -> the flat [K_pad / 8][n_pad][8] core-matrix image."""
    k, n = w.shape
    return w.reshape(k // 8, 8, n).permute(0, 2, 1).reshape(-1)


def tf32_split(x: torch.Tensor):
    """(hi, lo) with float32 x = hi + lo to about 2^-22 relative: hi is x
    rounded to tf32 (to nearest, ties away from zero, as cvt.rna.tf32.f32;
    the low 13 bits zero), lo the remainder rounded likewise, by the
    integer rule the kernel applies to its activations."""
    def rna(v):
        return ((v.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)

    hi = rna(x)
    return hi, rna(x - hi)


def tf32_image(w: torch.Tensor) -> torch.Tensor:
    """[K_pad, n_pad] float32 -> the flat [K_pad / 8][hi, lo][2][n_pad][4]
    image of its tf32 split, rows of each 8-block in TF32_ROW_ORDER."""
    k, n = w.shape
    blocks = [x.reshape(k // 8, 8, n)[:, list(TF32_ROW_ORDER)].reshape(k // 8, 2, 4, n)
              .permute(0, 1, 3, 2) for x in tf32_split(w.float().contiguous())]
    return torch.stack(blocks, 1).reshape(-1)


def pack(layers, pos_dim: int, dir_dim: int, dtype: torch.dtype) -> PackedMLP:
    """layers: list of (weight [out, in] as in nn.Linear, bias [out],
    segments, dst, relu, out_col) in execution order, where segments lists
    the input buffers whose concatenation feeds the layer (BUF_POS /
    BUF_DIR of the real widths pos_dim / dir_dim, or a hidden buffer) and
    dst is a hidden buffer or OUT (then out_col is the first output column).
    Each segment's rows are padded to a multiple of 16 with zero rows, each
    layer's outputs to a multiple of 16 with zero columns."""
    if len(layers) > MAX_LAYERS:
        raise ValueError(f"{len(layers)} layers > {MAX_LAYERS}")
    pos_pad, dir_pad = _round_up(pos_dim, 16), _round_up(dir_dim, 16)
    real = {BUF_POS: pos_dim, BUF_DIR: dir_dim}
    padded = {BUF_POS: pos_pad, BUF_DIR: dir_pad}
    device = layers[0][0].device
    w_parts, s_parts, t_parts, b_parts, table = [], [], [], [], []
    w_off = b_off = macs = 0
    for weight, bias, segments, dst, relu, out_col in layers:
        n_out, k_real = weight.shape
        if len(segments) > 2:
            raise ValueError("a layer takes at most two input segments")
        if dst != OUT and n_out % 16:
            raise ValueError(f"hidden width {n_out} is not a multiple of 16")
        n_pad = _round_up(n_out, 16)
        if n_pad > MAX_WIDTH:
            raise ValueError(f"layer width {n_out} > {MAX_WIDTH}")
        k_pads = [padded[s] for s in segments]
        w = torch.zeros(sum(k_pads), n_pad, dtype=torch.float32, device=device)
        src_row = dst_row = 0
        for s, kp in zip(segments, k_pads):
            k = real[s]
            w[dst_row:dst_row + k, :n_out] = weight[:, src_row:src_row + k].T.float()
            src_row += k
            dst_row += kp
        if src_row != k_real:
            raise ValueError(f"segments cover {src_row} inputs, weight has {k_real}")
        b = torch.zeros(n_pad, dtype=torch.float32, device=device)
        b[:n_out] = bias.float()
        w_parts.append(w.reshape(-1))
        if dtype == torch.bfloat16:
            s_parts.append(slab_image(w))
        else:
            t_parts.append(tf32_image(w))
        b_parts.append(b.to(dtype).float())
        seg = list(zip(segments, k_pads)) + [(-1, 0)] * (2 - len(segments))
        table.append([w_off, b_off, seg[0][0], seg[0][1], seg[1][0], seg[1][1],
                      n_pad, dst, n_out, out_col, int(relu)])
        w_off += w.numel()
        b_off += n_pad
        macs += k_real * n_out
        if dst != OUT:
            real[dst] = padded[dst] = n_pad
    return PackedMLP(
        dtype=dtype,
        weights=torch.cat(w_parts).to(dtype).contiguous(),
        biases=torch.cat(b_parts).contiguous(),
        table=np.ascontiguousarray(table, np.int64),
        pos_dim=pos_dim, dir_dim=dir_dim, pos_pad=pos_pad, dir_pad=dir_pad, macs=macs,
        slabs=torch.cat(s_parts).to(dtype).contiguous() if s_parts else None,
        tf32_slabs=torch.cat(t_parts).contiguous() if t_parts else None,
    )


def _pad_cast(x: torch.Tensor, width: int, dtype: torch.dtype) -> torch.Tensor:
    out = torch.zeros(x.shape[0], width, dtype=dtype, device=x.device)
    out[:, : x.shape[1]] = x
    return out


def mlp_fused_plain(pos_map: torch.Tensor, dir_map: torch.Tensor, packed: PackedMLP) -> torch.Tensor:
    """The layer table run as PyTorch matmuls: [N, 4] f32."""
    bufs = {
        BUF_POS: _pad_cast(pos_map, packed.pos_pad, packed.dtype),
        BUF_DIR: _pad_cast(dir_map, packed.dir_pad, packed.dtype),
    }
    out = torch.zeros(pos_map.shape[0], 4, dtype=torch.float32, device=pos_map.device)
    for w_off, b_off, s0, k0, s1, k1, n_pad, dst, n_out, out_col, relu in packed.table.tolist():
        x = torch.cat([bufs[s0], bufs[s1]], 1) if s1 >= 0 else bufs[s0]
        k = k0 + (k1 if s1 >= 0 else 0)
        w = packed.weights[w_off:w_off + k * n_pad].view(k, n_pad)
        y = x.float() @ w.float() + packed.biases[b_off:b_off + n_pad]
        if relu:
            y = torch.relu(y)
        y = y.to(packed.dtype)
        if dst == OUT:
            out[:, out_col:out_col + n_out] = y[:, :n_out].float()
        else:
            bufs[dst] = y
    return out


def mlp_fused(pos_map: torch.Tensor, dir_map: torch.Tensor, packed: PackedMLP) -> torch.Tensor:
    """Fused forward of the packed chain: pos_map [N, pos_dim] and dir_map
    [N, dir_dim] float32 -> [N, 4] float32 (rgb logits, density)."""
    if pos_map.device.type == "cpu":
        return mlp_fused_plain(pos_map, dir_map, packed)
    dev = pos_map.device
    if dev.type != "cuda" or dir_map.device != dev or packed.weights.device != dev:
        raise ValueError("pos_map, dir_map and the packed weights must be on one CUDA device")
    if pos_map.dtype != torch.float32 or dir_map.dtype != torch.float32:
        raise TypeError("pos_map and dir_map must be float32")
    n = pos_map.shape[0]
    if pos_map.shape != (n, packed.pos_dim) or dir_map.shape != (n, packed.dir_dim):
        raise ValueError(f"need pos_map [N, {packed.pos_dim}] and dir_map [N, {packed.dir_dim}], "
                         f"got {tuple(pos_map.shape)} and {tuple(dir_map.shape)}")
    if packed.dtype not in VARIANTS:
        raise TypeError(f"unsupported operand dtype {packed.dtype}")
    variant = VARIANTS[packed.dtype]
    weights = packed.slabs if variant == "wgmma_bf16" else packed.tf32_slabs
    if weights is None or weights.device != dev:
        raise ValueError(f"{variant} needs its weight image on {dev} (pack() makes it)")
    if n >= 2**31:
        raise ValueError(f"{n} samples in one call; split them (chunked_apply)")
    out = torch.empty(n, 4, dtype=torch.float32, device=dev)
    if n == 0:
        return out
    pos = _pad_cast(pos_map, packed.pos_pad, packed.dtype)
    dirs = _pad_cast(dir_map, packed.dir_pad, packed.dtype)
    rc = build.entry("mlp_fused")(
        int(variant == "wgmma_bf16"), pos.data_ptr(), dirs.data_ptr(), packed.pos_pad,
        packed.dir_pad, weights.data_ptr(), packed.biases.data_ptr(), packed.table.ctypes.data,
        len(packed.table), out.data_ptr(), n, torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check("mlp_fused", rc)
    mlp_fused.launches += 1
    mlp_fused.variant_launches[variant] += 1
    return out


mlp_fused.launches = 0
mlp_fused.variant_launches = dict.fromkeys(VARIANTS.values(), 0)
