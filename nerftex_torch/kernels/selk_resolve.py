"""Per-sample overlap resolution over the K hit slots: CUDA kernel and its
plain version.

Counterpart of nerftex_tpu/kernels/selk_resolve.py (``selk_resolve``) and
of the XLA chain it replaces (nerftex_tpu/instancing/device.py
``_per_sample_grid``).  For each (ray, sample) over the ray's K hit
intervals:

  active    valid & tk0 <= t < tk1; with none active, the interval nearest
            to t (first minimum of the clamped distance) alone;
  random    the floor(u * n)-th active interval by rank;
  nearest   the first minimum of |o + t d - c_k|^2 = sel_a + 2 t sel_b + t^2;
  nearest_blend  weights max(range + min_d - d_k, 0) over the active
            anchor distances d_k, normalised; the pick is the count of
            u > cumsum, clipped to K - 1, and p_sel its probability.

Returns (sel_k int32, p_sel float32, n_active int32), each [Rb, S];
p_sel is zero for ``nearest`` and ``random``, n_active is clamped to >= 1.
``selk_resolve`` runs ``selk_resolve_plain`` for CPU tensors and
``csrc/selk_resolve.cu`` for CUDA tensors.
"""

import torch

from nerftex_torch.instancing.geometry import fma
from nerftex_torch.kernels import build

METHODS = {"random": 0, "nearest": 1, "nearest_blend": 2}


def anchor_d2(sel_a, sel_b, t):
    """|o + t d - c|^2 = sa + 2 t sb + t^2 as XLA evaluates the JAX
    package's expression: fma(t, t, fma(2 t, sb, sa)).  The terms (~|o -
    c|^2) are far larger than the result near an anchor, so the rounding
    decides the blend weights."""
    return fma(t, t, fma(2.0 * t, sel_b, sel_a))


def selk_resolve_plain(tk0, tk1, kvalid, sel_a, sel_b, t_pt, u_sel, method="nearest_blend",
                       blend_range=0.0):
    """The [Rb, S, K] chain in PyTorch ops, written as the JAX package's XLA
    chain is.  sel_a/sel_b may be None for ``random``, u_sel for
    ``nearest``."""
    if method not in METHODS:
        raise ValueError(f"unknown instance_sampling_method {method}")
    K = tk0.shape[-1]
    inf = float("inf")
    tp = t_pt[..., None]
    kv = kvalid[:, None, :]
    t0, t1 = tk0[:, None, :], tk1[:, None, :]
    active = kv & (t0 <= tp) & (tp < t1)
    n_active = active.sum(-1)
    iv_dist = torch.maximum(t0 - tp, tp - t1)
    iv_dist = torch.where(kv, torch.clamp(iv_dist, min=0.0), inf)
    fallback = torch.nn.functional.one_hot(torch.argmin(iv_dist, -1), K).bool()
    active = torch.where((n_active == 0)[..., None], fallback, active)
    n_active = torch.clamp(n_active, min=1)
    p_sel = torch.zeros_like(t_pt)

    if method == "random":
        target = torch.minimum(torch.floor(u_sel * n_active).to(torch.int64), n_active - 1)
        rank = torch.cumsum(active, -1) - 1
        sel_k = torch.argmax((active & (rank == target[..., None])).to(torch.int8), -1)
    else:
        d2 = anchor_d2(sel_a[:, None, :], sel_b[:, None, :], tp)
        d2 = torch.where(active, torch.clamp(d2, min=0.0), inf)
        if method == "nearest":
            sel_k = torch.argmin(d2, -1)
        else:
            dist = torch.where(active, torch.sqrt(d2), inf)
            min_d = dist.min(-1, keepdim=True).values
            w = torch.where(active, torch.clamp(blend_range + min_d - dist, min=0.0), 0.0)
            prob = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-20)
            cum = torch.cumsum(prob, -1)
            sel_k = torch.clamp((u_sel[..., None] > cum).sum(-1), 0, K - 1)
            p_sel = prob.gather(-1, sel_k[..., None])[..., 0]
    return sel_k.to(torch.int32), p_sel, n_active.to(torch.int32)


def selk_resolve(tk0, tk1, kvalid, sel_a, sel_b, t_pt, u_sel, method="nearest_blend",
                 blend_range=0.0):
    """Overlap resolution: tables tk0, tk1, kvalid, sel_a, sel_b [Rb, K] and
    planes t_pt, u_sel [Rb, S] -> (sel_k, p_sel, n_active) [Rb, S]."""
    if t_pt.device.type == "cpu":
        return selk_resolve_plain(tk0, tk1, kvalid, sel_a, sel_b, t_pt, u_sel, method,
                                  blend_range)
    if method not in METHODS:
        raise ValueError(f"unknown instance_sampling_method {method}")
    dev = t_pt.device
    tables = {"tk0": tk0, "tk1": tk1, "kvalid": kvalid, "sel_a": sel_a, "sel_b": sel_b}
    planes = {"t_pt": t_pt, "u_sel": u_sel}
    unused = {"random": ("sel_a", "sel_b"), "nearest": ("u_sel",), "nearest_blend": ()}
    for name in unused[method]:
        tables.pop(name, None)
        planes.pop(name, None)
    if dev.type != "cuda" or any(x is None or x.device != dev
                                 for x in (*tables.values(), *planes.values())):
        raise ValueError(f"selk_resolve needs every input on one CUDA device, t_pt on {dev}")
    rb, K = tk0.shape
    S = t_pt.shape[1]
    if min(rb, S, K) < 1:
        raise ValueError(f"selk_resolve needs Rb, S, K >= 1, got {rb}, {S}, {K}")
    for name, x in tables.items():
        if tuple(x.shape) != (rb, K):
            raise ValueError(f"{name} must be [{rb}, {K}], got {tuple(x.shape)}")
        if x.dtype != (torch.bool if name == "kvalid" else torch.float32):
            raise TypeError(f"{name} has dtype {x.dtype}")
    for name, x in planes.items():
        if tuple(x.shape) != (rb, S) or x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 [{rb}, {S}], got {x.dtype} "
                             f"{tuple(x.shape)}")
    tables = {k: v.contiguous() for k, v in tables.items()}
    planes = {k: v.contiguous() for k, v in planes.items()}
    sel = torch.empty((rb, S), dtype=torch.int32, device=dev)
    p = torch.empty((rb, S), dtype=torch.float32, device=dev)
    n = torch.empty((rb, S), dtype=torch.int32, device=dev)

    def ptr(d, name):
        return d[name].data_ptr() if name in d else None

    rc = build.entry("selk_resolve")(
        ptr(tables, "tk0"), ptr(tables, "tk1"), ptr(tables, "kvalid"), ptr(tables, "sel_a"),
        ptr(tables, "sel_b"), ptr(planes, "t_pt"), ptr(planes, "u_sel"),
        rb, S, K, METHODS[method], float(blend_range),
        sel.data_ptr(), p.data_ptr(), n.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check("selk_resolve", rc)
    selk_resolve.launches += 1
    return sel, p, n


selk_resolve.launches = 0
