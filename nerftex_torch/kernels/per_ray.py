"""The per-ray stage of one ray block: the culls, the mesh's first hit, the
slab intervals, the top-K nearest and their union as sorted events with
prefix sums, and the per-ray sample layout, as a CUDA pass and its plain
version.

Source note.  These kernels replace no Pallas kernel: they replace the
eager chain of nerftex_tpu/instancing/device.py's ``_per_ray`` (fan,
culls, Moller-Trumbore, slab test, ``lax.top_k``, event sort and cumsums),
which XLA fuses on the TPU and which PyTorch ran as about 300 launches and
three host reads a ray block (the ray fan's axis and each cull's branch);
``per_ray_plain`` below is that chain, moved here (its fan and culls in
instancing.geometry).  The block's work is small (tens of microseconds on
the card), so the chain was bound by the host's launches; csrc/per_ray.cu
answers a block in two launches and a memset, with each cull's branch
chosen on the card from its count.

For the rays [Rb, 3] of one block and the scene's tables (``scene``: an
object with ``n_instances``, ``inv_rot`` [N, 3, 3], ``inv_trans``,
``origins``, ``inst_center`` [N, 3], ``inst_radius`` [N], ``slab_kappa``,
``b_0``, ``b_1`` [3], ``n_tris`` and, with triangles, ``tri_v0``,
``tri_e1``, ``tri_e2``, ``tri_center`` [T, 3], ``tri_radius`` [T], as
instancing.device.DeviceScene holds them), ``per_ray`` returns:

  tk0, tk1, inst_idx, kvalid, sel_a, sel_b   [Rb, K] hit slots, nearest
                                             first (sel_a, sel_b: the
                                             anchor-distance terms)
  times_s, cum_incl, cum_excl, arc_corr      [Rb, 2K] sorted events and
                                             their prefix sums
  total, n_steps, t_offset, tiny             [Rb] sample layout
  t_mesh, tri, tri_u, tri_v                  [Rb] the mesh's first hit
                                             (None for tri and its
                                             barycentrics without triangles)
  hit [Rb], alpha_last [Rb, 1], color_last [Rb, 1, 3] (zeros)
  overflow_hits, overflow_steps              0-d int64 drop counts
  cull                                       None (the plain chain, which
                                             counts its culls itself, or no
                                             cull), or the kernels' int32
                                             [4 + C + TC] on the device: the
                                             instance and triangle keep sets'
                                             counts, the culls that fit and
                                             that did not, then the kept
                                             instance and triangle ids (C, TC:
                                             the budgets in force)

``per_ray`` runs ``per_ray_plain`` for CPU tensors and the kernels for CUDA
tensors; it counts ``per_ray.rays`` for every ray that enters it and
``per_ray.kernel`` for those the kernels answered.  Without a fitting keep
set and with one the tables are equal: the keep sets are conservative, the
instance spheres widened under bfloat16 slab operands by what the rounded
test can reach beyond them (geometry.slab_pad: the scene's ``slab_kappa``).
An invalid hit slot (kvalid False, tk0 = tk1 = inf) holds instance 0 in the
kernels, and the first columns not kept in the chain (so the chain's
culled and full branches differ there too); no pick reads it.
"""

import math

import numpy as np
import torch

from nerftex_torch.instancing.geometry import (T_FAR, block_fan, dot3, fan_keep,
                                                keep_to_candidates, moller_trumbore, slab_pad)
from nerftex_torch.kernels import build
from nerftex_torch.models.encodings import check_matmul_precision, round_operand
from nerftex_torch.utils import trace

_INF = float("inf")
# The kernels' hit-slot capacity (csrc/per_ray.cu's largest list).
MAX_HITS = 128


def _cull_fits(keep, budget) -> bool:
    """Whether the kept ids fit the budget: a read of the device's count,
    which picks the culled branch (counted ``cull.fit``) or the full one
    (``cull.full``)."""
    with trace.host_read("cull"):
        fits = int(keep.sum()) <= budget
    trace.count("cull.fit" if fits else "cull.full")
    return fits


def budgets(scene, K, cull_budget, tri_cull_budget):
    """The instance and triangle cull budgets in force (0: not culled): an
    instance budget below K is raised to K, and a budget that would keep
    every column culls nothing."""
    C = max(cull_budget, K) if (cull_budget and max(cull_budget, K) < scene.n_instances) else 0
    TC = tri_cull_budget if (tri_cull_budget and 0 < tri_cull_budget < scene.n_tris) else 0
    return C, TC


def inst_pad(scene, C, matmul_precision):
    """The instance cull's sphere pad (geometry.slab_pad) under this
    operand rounding, from the scene's ``slab_kappa``; None without an
    instance cull or at float32."""
    return slab_pad(scene.slab_kappa, matmul_precision) if C else None


def per_ray_plain(scene, rays_o, rays_d, u_off, K, S, step, cull_budget=0, tri_cull_budget=0,
                  matmul_precision="float32"):
    """The per-ray stage as the eager chain; arguments and result as for
    ``per_ray``."""
    ds = scene
    Rb = rays_o.shape[0]
    dev = rays_o.device
    C, TC = budgets(ds, K, cull_budget, tri_cull_budget)
    fan = block_fan(rays_o, rays_d) if (C or TC) else None

    # mesh first hit (clamps the intervals' exits): its distance,
    # triangle and barycentrics (the first of equal distances).
    tri = tri_u = tri_v = None
    with trace.span("per_ray.mesh_hit"):
        if ds.n_tris > 0:
            first = None
            if TC:
                keep_t = fan_keep(fan, ds.tri_center, ds.tri_radius)
                if _cull_fits(keep_t, TC):
                    tcand, tvalid = keep_to_candidates(keep_t, TC)
                    t_all, u_all, v_all = moller_trumbore(
                        rays_o, rays_d, ds.tri_v0[tcand], ds.tri_e1[tcand], ds.tri_e2[tcand])
                    first = (torch.where(tvalid[None, :], t_all, _INF), u_all, v_all, tcand)
            if first is None:
                first = (*moller_trumbore(rays_o, rays_d, ds.tri_v0, ds.tri_e1, ds.tri_e2),
                         None)
            t_all, u_all, v_all, tri_ids = first
            t_mesh, best = t_all.min(-1)
            tri = best if tri_ids is None else tri_ids[best]
            tri_u = u_all.gather(1, best[:, None])[:, 0]
            tri_v = v_all.gather(1, best[:, None])[:, 0]
        else:
            t_mesh = torch.full((Rb,), _INF, device=dev)
        mesh_hit = torch.isfinite(t_mesh)

    # instance slab intervals + top-K nearest
    def intervals_topk(inv_rot_n, inv_trans_n, inst_ids, cand_valid):
        n_cols = inv_trans_n.shape[0]
        t0 = torch.full((Rb, n_cols), -_INF, device=dev)
        t1 = torch.full((Rb, n_cols), _INF, device=dev)
        prec = matmul_precision
        o_r, d_r = round_operand(rays_o, prec), round_operand(rays_d, prec)
        for c in range(3):
            rot_c = round_operand(inv_rot_n[:, c, :].T, prec)
            o_lc = o_r @ rot_c + inv_trans_n[:, c]
            d_lc = d_r @ rot_c
            inv_dl = 1.0 / torch.where(d_lc.abs() < 1e-12, 1e-12, d_lc)
            t_a = (ds.b_0[c] - o_lc) * inv_dl
            t_b = (ds.b_1[c] - o_lc) * inv_dl
            t0 = torch.maximum(t0, torch.minimum(t_a, t_b))
            t1 = torch.minimum(t1, torch.maximum(t_a, t_b))
        if cand_valid is not None:
            t0 = torch.where(cand_valid[None, :], t0, _INF)
            t1 = torch.where(cand_valid[None, :], t1, -_INF)
        box_hit = (t0 < t1) & (t1 > 0) & (t0 < T_FAR)
        t0c = torch.clamp(t0, 0.0, T_FAR)
        t1c = torch.minimum(torch.clamp(t1, 0.0, T_FAR), t_mesh[:, None])
        valid_iv = box_hit & (t0c < t1c)
        overflow = torch.clamp(valid_iv.sum(-1) - K, min=0).sum()
        score = torch.where(valid_iv, t0c, _INF)
        # Stable ascending sort: equal scores keep the lowest column
        # first, the tie order of lax.top_k in the JAX package.
        score_s, sel = torch.sort(score, dim=-1, stable=True)
        sel = sel[:, :K]
        tk0 = score_s[:, :K]
        kvalid = torch.isfinite(tk0)
        tk1 = torch.where(kvalid, t1c.gather(1, sel), _INF)
        hit_box = (box_hit & (t1 > 0)).any(-1)
        return tk0, tk1, inst_ids[sel], kvalid, overflow, hit_box

    with trace.span("per_ray.slabs"):
        res = None
        if C:
            keep_i = fan_keep(fan, ds.inst_center, ds.inst_radius,
                              inst_pad(ds, C, matmul_precision))
            if _cull_fits(keep_i, C):
                cand, cand_valid = keep_to_candidates(keep_i, C)
                res = intervals_topk(ds.inv_rot[cand], ds.inv_trans[cand], cand, cand_valid)
        if res is None:
            res = intervals_topk(ds.inv_rot, ds.inv_trans,
                                 torch.arange(ds.n_instances, device=dev), None)
        tk0, tk1, inst_idx, kvalid, overflow_hits, hit_box = res

    with trace.span("per_ray.events"):
        # |o + t d - c|^2 = a + 2 t b + t^2 (|d| = 1) per hit slot, for
        # the anchor-distance picks; the 3-term dots rounded as XLA
        # contracts them (the picks' distances cancel these terms, see
        # selk_resolve).
        diff = rays_o[:, None, :] - ds.origins[inst_idx]
        sel_a = dot3(diff, diff)
        sel_b = dot3(rays_d[:, None, :].expand_as(diff), diff)

        # union of intervals via sorted events (starts before ends at
        # equal t)
        times = torch.cat([tk0, tk1], -1)
        delta = torch.cat([torch.ones_like(tk0, dtype=torch.int32),
                           torch.full_like(tk1, -1, dtype=torch.int32)], -1)
        times_s, ev = torch.sort(times, dim=-1, stable=True)
        count = torch.cumsum(delta.gather(1, ev), -1)
        finite_t = torch.isfinite(times_s)
        nxt = torch.cat([times_s[:, 1:], times_s[:, -1:]], -1)
        gap = torch.where(torch.isfinite(nxt) & finite_t, nxt - times_s, 0.0)
        seg_len = torch.where(count > 0, gap, 0.0)
        cum_incl = torch.cumsum(seg_len, -1)
        cum_excl = cum_incl - seg_len
        total = cum_incl[:, -1]
        arc_corr = torch.where(finite_t, times_s - cum_excl, 0.0)

        # per-ray sample layout
        necessary = torch.floor(total / step).to(torch.int32)
        overflow_steps = torch.clamp(necessary - S, min=0).sum()
        tiny = (necessary == 0) & (total > 0)
        n_steps = torch.where(tiny, 1, torch.clamp(necessary, max=S)).to(torch.int32)
        t_offset = torch.where(tiny, u_off * total, u_off * step)

    return {
        "tk0": tk0, "tk1": tk1, "inst_idx": inst_idx, "kvalid": kvalid,
        "sel_a": sel_a, "sel_b": sel_b,
        "times_s": times_s, "cum_incl": cum_incl.contiguous(), "cum_excl": cum_excl,
        "arc_corr": arc_corr, "total": total, "n_steps": n_steps, "t_offset": t_offset,
        "tiny": tiny, "t_mesh": t_mesh, "tri": tri, "tri_u": tri_u, "tri_v": tri_v,
        "hit": hit_box | mesh_hit, "alpha_last": mesh_hit[:, None].float(),
        "color_last": torch.zeros(Rb, 1, 3, device=dev),
        "overflow_hits": overflow_hits, "overflow_steps": overflow_steps, "cull": None,
    }


def _check(scene, rays_o, rays_d, u_off, K):
    """Raise unless the kernels take these inputs: K within the hit slots'
    capacity, each input's dtype, shape and contiguity (the rays may lie at
    any strides), then all on the CUDA device of ``rays_o``."""
    if not 1 <= K <= MAX_HITS:
        raise ValueError(f"per_ray: K = {K} hit slots; the kernels hold 1 to {MAX_HITS}")

    def rows(x):
        return x.shape[0] if x.dim() else -1

    rb, n, t = rows(rays_o), scene.n_instances, scene.n_tris
    if K > n:
        raise ValueError(f"per_ray: K = {K} hit slots over {n} instances")
    named = {"rays_o": (rays_o, (rb, 3)), "rays_d": (rays_d, (rb, 3)), "u_off": (u_off, (rb,)),
             "inv_rot": (scene.inv_rot, (n, 3, 3)), "inv_trans": (scene.inv_trans, (n, 3)),
             "origins": (scene.origins, (n, 3)), "inst_center": (scene.inst_center, (n, 3)),
             "inst_radius": (scene.inst_radius, (n,)), "b_0": (scene.b_0, (3,)),
             "b_1": (scene.b_1, (3,))}
    if t:
        named.update({k: (getattr(scene, k), (t, 3))
                      for k in ("tri_v0", "tri_e1", "tri_e2", "tri_center")})
        named["tri_radius"] = (scene.tri_radius, (t,))
    for name, (x, shape) in named.items():
        if x.dtype != torch.float32:
            raise TypeError(f"per_ray: {name} has dtype {x.dtype}, not torch.float32")
        if tuple(x.shape) != shape or not 0 < x.numel() < 2**31:
            raise ValueError(f"per_ray: {name} must be {list(shape)} (1 to 2^31 - 1 elements), "
                             f"got {list(x.shape)}")
        # The rays may lie at any strides (one origin expanded over a block).
        if not (x.is_contiguous() or name in ("rays_o", "rays_d")):
            raise ValueError(f"per_ray: {name} is not contiguous")
    for name, (x, _) in named.items():
        if x.device.type != "cuda" or x.device != rays_o.device:
            raise ValueError(f"per_ray needs every input on one CUDA device: {name} is on "
                             f"{x.device}, rays_o on {rays_o.device}")


def _carve(dtype, shapes, dev):
    """Views of one new buffer of ``dtype``, one per shape, in order."""
    sizes = [math.prod(s) for s in shapes]
    buf = torch.empty(sum(sizes), dtype=dtype, device=dev)
    return [part.view(s) for part, s in zip(buf.split(sizes), shapes)]


def per_ray(scene, rays_o, rays_d, u_off, K, S, step, cull_budget=0, tri_cull_budget=0,
            matmul_precision="float32"):
    """The per-ray stage of one ray block (module docstring).  rays_o,
    rays_d [Rb, 3]; u_off [Rb], the stratified offsets; K hit slots (at
    most the instance count); S, the step cap; step, the arc step;
    cull_budget / tri_cull_budget, the fan culls' budgets (0: off);
    matmul_precision, the slab test's operand rounding.  CPU tensors run
    the plain chain; CUDA tensors the kernels, or raise."""
    rb = rays_o.shape[0]
    trace.count("per_ray.rays", rb)
    matmul_precision = check_matmul_precision(matmul_precision)
    if rays_o.device.type == "cpu":
        return per_ray_plain(scene, rays_o, rays_d, u_off, K, S, step, cull_budget,
                             tri_cull_budget, matmul_precision)
    _check(scene, rays_o, rays_d, u_off, K)
    dev = rays_o.device
    C, TC = budgets(scene, K, cull_budget, tri_cull_budget)
    pad = inst_pad(scene, C, matmul_precision) or (0.0, 0.0)
    t = scene.n_tris
    f32 = _carve(torch.float32, [(rb, K)] * 4 + [(rb, 2 * K)] * 4 + [(rb,)] * 5
                 + [(rb, 1), (rb, 1, 3)], dev)
    inst_idx, tri, overflow = _carve(torch.int64, [(rb, K), (rb,), (2,)], dev)
    n_steps = torch.empty(rb, dtype=torch.int32, device=dev)
    kvalid, tiny, hit = _carve(torch.bool, [(rb, K), (rb,), (rb,)], dev)
    cull = torch.empty(4 + C + TC, dtype=torch.int32, device=dev) if (C or TC) else None

    rc = build.entry("per_ray")(
        rays_o.data_ptr(), rays_d.data_ptr(), *rays_o.stride(), *rays_d.stride(),
        u_off.data_ptr(), rb,
        scene.inv_rot.data_ptr(), scene.inv_trans.data_ptr(), scene.origins.data_ptr(),
        scene.inst_center.data_ptr(), scene.inst_radius.data_ptr(), scene.n_instances,
        *(getattr(scene, k).data_ptr() if t else None
          for k in ("tri_v0", "tri_e1", "tri_e2", "tri_center", "tri_radius")), t,
        scene.b_0.data_ptr(), scene.b_1.data_ptr(), C, TC, *pad,
        None if cull is None else cull.data_ptr(), K, S, float(np.float32(step)),
        int(matmul_precision == "bfloat16"),
        f32[0].data_ptr(), inst_idx.data_ptr(), n_steps.data_ptr(), kvalid.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check("per_ray", rc)
    per_ray.launches += 1
    trace.count("per_ray.kernel", rb)
    (tk0, tk1, sel_a, sel_b, times_s, cum_incl, cum_excl, arc_corr, total, t_offset, t_mesh,
     tri_u, tri_v, alpha_last, color_last) = f32
    return {
        "tk0": tk0, "tk1": tk1, "inst_idx": inst_idx, "kvalid": kvalid,
        "sel_a": sel_a, "sel_b": sel_b,
        "times_s": times_s, "cum_incl": cum_incl, "cum_excl": cum_excl, "arc_corr": arc_corr,
        "total": total, "n_steps": n_steps, "t_offset": t_offset, "tiny": tiny,
        "t_mesh": t_mesh, "tri": tri if t else None, "tri_u": tri_u if t else None,
        "tri_v": tri_v if t else None, "hit": hit, "alpha_last": alpha_last,
        "color_last": color_last, "overflow_hits": overflow[0], "overflow_steps": overflow[1],
        "cull": cull,
    }


per_ray.launches = 0
