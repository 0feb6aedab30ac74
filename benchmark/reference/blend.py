"""A plain reference of a frame whose instances sit on the mesh's vertices
and whose overlaps resolve by ``nearest_blend`` (NeRF-Tex's plush render),
beside render.py, which resolves them by ``nearest`` over anchor files.

- ``VertexSceneTables``: with no anchor file the upstream instancer
  (DistributeInstancesOnMesh) puts one instance on each distinct vertex of
  the mesh, first occurrence first, in the vertex's frame (T, B, N) from
  the faces' UV gradients; with jitter it turns B about N by jitter x
  U(0, pi), drawn from RandomState(seed) vertex by vertex, and takes the
  tangent as cross(N, B) with the sign that keeps it on T's side.
- ``BlendRenderer``: render.py's frame with the blended pick.  Over the
  active intervals at a sample (the nearest interval alone when none is),
  the anchor distances d_k (d_k^2 = fma(t, t, fma(2 t, b_k, a_k)), the
  contraction XLA gives the upstream expression) weigh max(range + d_min -
  d_k, 0), range = 0.2 x patch_scale, normalised; the pick is the number of
  running sums of the weights below the sample's uniform u, at most the
  block's hit tier less one (``sorted_uniforms``), and where more than one
  interval is active the sample's density is multiplied by 1 / p of the
  pick.  With ``nearest`` it is render.py's pick, and no uniform is drawn.
- ``sorted_uniforms``: the uniform of each sample, as the occupancy-sorted
  render draws it.  The frame's rays (padded to whole ray blocks with rays
  from the origin straight up) are sorted by their step count, descending
  and stable; sorted block b of ``ray_block`` rays draws uniform(split(
  fold_in(fold_in(k, 0x7FFFFFFF), b))[0], (ray_block, W)), k the frame's
  instancer key (render.frame_offsets), W the smallest of the step buckets
  (8, then cap x q / 8 for q = 1 .. 8) that holds the block's first ray;
  a ray takes the row of its place in the block.  The block's hit tier is
  the smallest of (8, K / 4, K) that holds its rays' hit counts (K >= 64;
  K alone otherwise).  ``frame_layout`` gives every ray's step and hit
  counts for that sort.

Departures from render.py, each where the program states the arithmetic
that the upstream instancer leaves open: the ray-to-local products as
fma(a2, b2, fma(a1, b1, a0 b0)); the arc's running sums in float64, each
rounded once to float32; the step count as the floor of a correctly
rounded float32 quotient on every device; the weights' sum and running
sum in float32 in slot order; an invalid hit slot names instance 0.  Rays are rendered in
chunks that keep each [rays, steps, slots] plane to about 2^24 elements.
It imports nothing of the program.
"""

import bisect
import math
import os

import numpy as np
import torch

from benchmark.reference import jax_rng
from benchmark.reference.ply import read_ply
from benchmark.reference.render import (INF, STREAM_PERTURB, T_FAR, ReferenceRenderer, dot3,
                                        fma, frame_offsets, moller_trumbore)
from benchmark.reference.scene import SceneTables, _tangent_frames, closest_points
from benchmark.reference.scene import texture_channels

SORTED_FOLD = 0x7FFFFFFF
BLEND_RANGE = 0.2          # of the patch scale
PLANE = 1 << 24            # elements of the largest [rays, steps, slots] plane
LAYOUT_CHUNK = 4096        # rays per chunk of the whole-frame pass


class VertexSceneTables(SceneTables):
    """SceneTables of a configuration without ``patch_origins_path``: an
    instance on each distinct vertex (module docstring)."""

    def __init__(self, instancer: dict, root: str):
        self.b_0 = np.asarray(instancer["b_0"], np.float32)
        self.b_1 = np.asarray(instancer["b_1"], np.float32)
        self.cast_shadow_rays = bool(instancer.get("cast_shadow_rays", False))
        self.method = instancer.get("instance_sampling_method", "random")
        self.use_mean_distance = bool(instancer.get("use_mean_distance", False))
        self.light_dir_idx = self.light_strength_idx = -1
        self.texture_slots, self.channels = [], []
        n = 0
        for entry in instancer.get("textures", ()):
            if entry == "light":
                self.light_dir_idx, n = n, n + 3
            elif entry == "point":
                self.light_strength_idx, self.light_dir_idx, n = n, n + 1, n + 4
            elif entry:
                chans = texture_channels(os.path.join(root, entry))
                self.texture_slots.append(n)
                self.channels.extend(chans)
                n += len(chans)
            else:
                n += 1

        ply = read_ply(os.path.join(root, instancer["mesh_path"]))
        V = np.asarray(ply.V, np.float32)
        F = np.asarray(ply.F, np.int64)
        UV = np.asarray(ply.UV, np.float32)
        scale = float(instancer["patch_scale"])
        self.patch_scale = scale
        T, B, N = _tangent_frames(V, F, np.asarray(ply.N, np.float32), UV)
        rng = np.random.RandomState(int(instancer.get("seed", 0)))
        jitter = float(instancer.get("jitter_amount", 0.0))
        forward, seen = [], set()
        for i in range(len(V)):
            key = V[i].tobytes()
            if key in seen:
                continue
            seen.add(key)
            tan, bit, nrm = T[i].copy(), B[i].copy(), N[i].copy()
            if jitter > 0:
                angle = jitter * rng.uniform(0, np.pi)
                bit = (bit * np.cos(angle) + np.cross(nrm, bit) * np.sin(angle)
                       + nrm * np.dot(nrm, bit) * (1 - np.cos(angle)))
                t_cross = np.cross(nrm, bit)
                tan = np.sign(np.dot(tan, t_cross) or 1.0) * t_cross
            m = np.eye(4, dtype=np.float32)
            m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = tan * scale, bit * scale, nrm * scale, V[i]
            forward.append(m)
        self.forward = np.stack(forward)
        self.inverse = np.stack([np.linalg.inv(m).astype(np.float32) for m in forward])
        dinv = self.forward[:, :3, :3].transpose(0, 2, 1).copy()
        self.dir_inverse = (dinv / np.linalg.norm(dinv, axis=-1, keepdims=True)).astype(
            np.float32)
        self.origins = self.forward[:, :3, 3].copy()

        # The anchor's UV and its closest triangle's UV Jacobian, as
        # SceneTables bakes them.
        a, b, c = V[F[:, 0]], V[F[:, 1]], V[F[:, 2]]
        n_inst = len(forward)
        self.anchor_uv = np.zeros((n_inst, 2), np.float32)
        self.uv_jacobian = np.zeros((n_inst, 2, 3), np.float32)
        tris, barys = closest_points(self.origins, a, b, c)
        for i, (tri, bary) in enumerate(zip(tris, barys)):
            f = F[tri]
            self.anchor_uv[i] = bary @ UV[f]
            e1, e2 = V[f[1]] - V[f[0]], V[f[2]] - V[f[0]]
            nrm = np.cross(e1, e2)
            nn = np.linalg.norm(nrm)
            if nn < 1e-12:
                continue
            A_inv = np.linalg.inv(np.stack([e1, e2, nrm / nn]))
            for r in range(2):
                rhs = np.array([UV[f[1], r] - UV[f[0], r], UV[f[2], r] - UV[f[0], r], 0.0])
                self.uv_jacobian[i, r] = A_inv @ rhs
        self.tri_v0, self.tri_e1, self.tri_e2 = a, b - a, c - a
        scales = np.linalg.norm(self.forward[:, :3, 0], axis=-1)
        from_inv = self.inverse[:, :3, :3] * scales[:, None, None]
        self.uniform_scale = None
        if (np.abs(scales - scales[0]) < 1e-5 * max(scales[0], 1e-9)).all() and \
                np.abs(from_inv - self.dir_inverse).max() < 1e-4:
            self.uniform_scale = float(scales[0])


def scene_tables(instancer: dict, root: str) -> SceneTables:
    """The scene's tables: by vertex without an anchor file."""
    if instancer.get("patch_origins_path"):
        return SceneTables(instancer, root)
    return VertexSceneTables(instancer, root)


def frame_key(seed, call):
    """The instancer's key of the ``call``-th frame under ``seed``, as
    render.frame_offsets derives it."""
    key = jax_rng.fold_in(jax_rng.fold_in(jax_rng.fold_in(jax_rng.key(seed), STREAM_PERTURB),
                                          call), 0)
    return jax_rng.split(key)[0]


def step_buckets(cap: int) -> list:
    return sorted({min(cap, 8), *(max(1, cap * q // 8) for q in range(1, 9)), cap})


def hit_tiers(K: int) -> list:
    return sorted({min(K, 8), max(1, K // 4), K}) if K >= 64 else [K]


def sorted_uniforms(n_steps, hits, k_inst, ray_block: int, cap: int, K: int, pixels, S: int):
    """(u [M, S], hit tier [M]) of the frame's rays ``pixels`` [M]: the
    uniforms of their first S samples and the tiers of their sorted blocks
    (module docstring); n_steps, hits [N] are every ray's of the padded
    frame (frame_layout)."""
    dev = n_steps.device
    n_rows = n_steps.shape[0]
    block = min(ray_block, n_rows)
    order = torch.argsort(n_steps, descending=True, stable=True)
    place = torch.empty_like(order)
    place[order] = torch.arange(n_rows, device=dev)
    block_max = n_steps[order][::block].tolist()
    block_hits = hits[order].reshape(-1, block).max(-1).values.tolist()
    buckets, tiers = step_buckets(cap), hit_tiers(K)
    p = place[torch.as_tensor(pixels, device=dev)]
    b, row = (p // block).tolist(), p % block
    width = torch.tensor([buckets[bisect.bisect_left(buckets, block_max[i])] for i in b],
                         dtype=torch.int64, device=dev)
    tier = torch.tensor([tiers[bisect.bisect_left(tiers, block_hits[i])] for i in b],
                        dtype=torch.int64, device=dev)
    keys = jax_rng.block_keys(jax_rng.fold_in(k_inst, SORTED_FOLD), n_rows // block)
    keys = keys[torch.as_tensor(b, dtype=torch.int64)].to(dev)
    counters = row[:, None] * width[:, None] + torch.arange(S, device=dev)[None, :]
    y0, y1 = jax_rng.threefry2x32(keys[:, :1], keys[:, 1:], counters >> 32, counters & 0xFFFFFFFF)
    return jax_rng._unit_float(y0 ^ y1), tier


class BlendRenderer(ReferenceRenderer):
    """ReferenceRenderer with vertex scenes' ``nearest`` and
    ``nearest_blend`` picks (module docstring)."""

    def __init__(self, scene, settings: dict, mlps, device):
        super().__init__(scene, settings, mlps, device)
        self.step = float(settings["step_size"])
        self.cap = min(int(settings["n_samples"]), int(settings["max_steps_per_ray"]))
        self.K = min(int(settings["max_hits"]), scene.n_instances)
        # The world box around every instance's box, widened far past any
        # rounding of the local slab test: a ray that misses it has no
        # interval.
        b = np.stack([scene.b_0, scene.b_1]).astype(np.float64)
        corners = np.array([[b[i, 0], b[j, 1], b[k, 2]] for i in (0, 1) for j in (0, 1)
                            for k in (0, 1)])
        fwd = scene.forward.astype(np.float64)
        world = np.einsum("nij,kj->nki", fwd[:, :3, :3], corners) + fwd[:, None, :3, 3]
        pad = 1e-3 * max(1.0, float(np.abs(world).max()))
        self.world_box = (world.min((0, 1)) - pad, world.max((0, 1)) + pad)

    # -- per ray -----------------------------------------------------------

    def _intervals(self, o, d, t_mesh):
        """render.py's intervals with each ray-to-local product written as
        fma(a2, b2, fma(a1, b1, a0 b0)) plus the translation."""
        n = self.inv_trans.shape[0]
        K = min(int(self.s["max_hits"]), n)
        R = o.shape[0]
        t0 = torch.full((R, n), -INF, device=self.dev)
        t1 = torch.full((R, n), INF, device=self.dev)
        for c in range(3):
            rot = self.inv_rot[None, :, c, :]
            o_lc = dot3(o[:, None, :], rot) + self.inv_trans[:, c]
            d_lc = dot3(d[:, None, :], rot)
            inv_dl = 1.0 / torch.where(d_lc.abs() < 1e-12, 1e-12, d_lc)
            t_a = (self.b_0[c] - o_lc) * inv_dl
            t_b = (self.b_1[c] - o_lc) * inv_dl
            t0 = torch.maximum(t0, torch.minimum(t_a, t_b))
            t1 = torch.minimum(t1, torch.maximum(t_a, t_b))
        box_hit = (t0 < t1) & (t1 > 0) & (t0 < T_FAR)
        t0c = torch.clamp(t0, 0.0, T_FAR)
        t1c = torch.minimum(torch.clamp(t1, 0.0, T_FAR), t_mesh[:, None])
        valid = box_hit & (t0c < t1c)
        score_s, sel = torch.sort(torch.where(valid, t0c, INF), dim=-1, stable=True)
        tk0, sel = score_s[:, :K], sel[:, :K]
        kvalid = torch.isfinite(tk0)
        tk1 = torch.where(kvalid, t1c.gather(1, sel), INF)
        return tk0, tk1, sel, kvalid, box_hit.any(-1)

    def layout(self, o, d):
        """The per-ray tables of rays o, d [R, 3]: the K nearest intervals and
        their anchor terms, the arc's events and running sums, the step
        count and offset scale."""
        t_mesh = moller_trumbore(o, d, self.v0, self.e1, self.e2).min(-1).values
        tk0, tk1, inst_k, kvalid, hit_box = self._intervals(o, d, t_mesh)
        inst_k = torch.where(kvalid, inst_k, 0)
        diff = o[:, None, :] - self.origins[inst_k]
        sel_a = dot3(diff, diff)
        sel_b = dot3(d[:, None, :].expand_as(diff), diff)

        times = torch.cat([tk0, tk1], -1)
        delta = torch.cat([torch.ones_like(tk0, dtype=torch.int32),
                           torch.full_like(tk1, -1, dtype=torch.int32)], -1)
        times_s, ev = torch.sort(times, dim=-1, stable=True)
        count = torch.cumsum(delta.gather(1, ev), -1)
        finite_t = torch.isfinite(times_s)
        nxt = torch.cat([times_s[:, 1:], times_s[:, -1:]], -1)
        gap = torch.where(torch.isfinite(nxt) & finite_t, nxt - times_s, 0.0)
        seg_len = torch.where(count > 0, gap, 0.0)
        cum_incl = torch.cumsum(seg_len.double(), -1).float()
        cum_excl = cum_incl - seg_len
        total = cum_incl[:, -1]
        # A correctly rounded quotient: CUDA divides a tensor by a Python
        # scalar as a product with its rounded reciprocal, which can round
        # an arc just short of a whole step count up to it.
        necessary = torch.floor(total / torch.full_like(total, self.step)).to(torch.int32)
        tiny = (necessary == 0) & (total > 0)
        return {
            "t_mesh": t_mesh, "tk0": tk0, "tk1": tk1, "inst_k": inst_k, "kvalid": kvalid,
            "hit_box": hit_box, "sel_a": sel_a, "sel_b": sel_b, "times_s": times_s,
            "cum_incl": cum_incl, "cum_excl": cum_excl, "total": total, "tiny": tiny,
            "arc_corr": torch.where(finite_t, times_s - cum_excl, 0.0),
            "n_steps": torch.where(tiny, 1, torch.clamp(necessary, max=self.cap)).to(torch.int32),
        }

    def frame_layout(self, rays_o, rays_d):
        """(n_steps, hit count) [N] of every ray of a frame, padded to whole
        ray blocks as the program pads it (module docstring)."""
        o, d = rays_o.float(), rays_d.float()
        r = o.shape[0]
        block = min(int(self.s["ray_block"]), r)
        pad = -(-r // block) * block - r
        if pad:
            o = torch.cat([o, o.new_zeros(pad, 3)])
            d = torch.cat([d, d.new_tensor([[0.0, 0.0, 1.0]]).expand(pad, 3)])
        lo, hi = (torch.as_tensor(x, dtype=torch.float32, device=self.dev)
                  for x in self.world_box)
        inv_d = 1.0 / torch.where(d.abs() < 1e-12, 1e-12, d)
        t_a, t_b = (lo - o) * inv_d, (hi - o) * inv_d
        near = (torch.minimum(t_a, t_b).amax(-1) <= torch.maximum(t_a, t_b).amin(-1)) & \
            (torch.maximum(t_a, t_b).amin(-1) > 0)
        n_steps = torch.zeros(o.shape[0], dtype=torch.int32, device=self.dev)
        hits = torch.zeros(o.shape[0], dtype=torch.int64, device=self.dev)
        idx = torch.nonzero(near).flatten()
        for i in range(0, idx.shape[0], LAYOUT_CHUNK):
            rows = idx[i:i + LAYOUT_CHUNK]
            lay = self.layout(o[rows], d[rows])
            n_steps[rows] = lay["n_steps"]
            hits[rows] = lay["kvalid"].sum(-1)
        return n_steps, hits

    # -- the frame's pixels ------------------------------------------------

    def render_frame(self, rays_o, rays_d, t_proxy, parameters, seed, call, pixels):
        """[(premultiplied color [M, 3], alpha [M])] for each of the
        renderer's MLPs, of the ``pixels`` [M] of the ``call``-th frame under
        ``seed`` whose rays [N, 3] (in the order the program takes them) are
        rays_o, rays_d, with proxy entries t_proxy [N, 2] and the frame's
        parameters [P]."""
        n = rays_o.shape[0]
        block = int(self.s["ray_block"])
        px = torch.as_tensor(np.asarray(pixels), dtype=torch.int64, device=self.dev)
        u_off = frame_offsets(seed, call, n, block, np.asarray(pixels), self.dev)
        o, d, t = rays_o[px].float(), rays_d[px].float(), t_proxy[px].float()
        prm = torch.as_tensor(parameters, dtype=torch.float32, device=self.dev)
        prm = prm.reshape(1, -1).expand(len(px), -1)
        u_sel = tier = None
        if self.scene.method == "nearest_blend":
            n_steps, hits = self.frame_layout(rays_o, rays_d)
            S = max(int(n_steps[px].max()), 1)
            u_sel, tier = sorted_uniforms(n_steps, hits, frame_key(seed, call), block, self.cap,
                                          self.K, px, S)
        return self.render(o, d, t, prm, u_off, u_sel, tier)

    def render(self, rays_o, rays_d, t_proxy, parameters, u_off, u_sel=None, tier=None):
        """[(premultiplied color [R, 3], alpha [R])] of R rays for each of the
        renderer's MLPs; u_sel [R, >= S] and tier [R] for ``nearest_blend``."""
        per = max(1, PLANE // (self.cap * self.K))
        parts = []
        for i in range(0, rays_o.shape[0], per):
            sl = slice(i, i + per)
            parts.append(self._render(rays_o[sl], rays_d[sl], t_proxy[sl], parameters[sl],
                                      u_off[sl], None if u_sel is None else u_sel[sl],
                                      None if tier is None else tier[sl]))
        return [(torch.cat([p[m][0] for p in parts]), torch.cat([p[m][1] for p in parts]))
                for m in range(len(self.mlps))]

    def _pick(self, lay, t_pt, u_sel, tier):
        """(instance [R, S], density weight [R, S]) of each sample."""
        tp = t_pt[..., None]
        tk0, tk1 = lay["tk0"][:, None, :], lay["tk1"][:, None, :]
        kv = lay["kvalid"][:, None, :]
        K = tk0.shape[-1]
        active = kv & (tk0 <= tp) & (tp < tk1)
        n_active = active.sum(-1)
        iv_dist = torch.maximum(tk0 - tp, tp - tk1)
        iv_dist = torch.where(kv, torch.clamp(iv_dist, min=0.0), INF)
        fallback = torch.nn.functional.one_hot(torch.argmin(iv_dist, -1), K).bool()
        active = torch.where((n_active == 0)[..., None], fallback, active)
        d2 = fma(tp, tp, fma(2.0 * tp, lay["sel_b"][:, None, :], lay["sel_a"][:, None, :]))
        d2 = torch.where(active, torch.clamp(d2, min=0.0), INF)
        if self.scene.method == "nearest":
            return lay["inst_k"].gather(1, torch.argmin(d2, -1)), torch.ones_like(t_pt)
        if self.scene.method != "nearest_blend":
            raise NotImplementedError("the reference resolves overlaps by 'nearest' and "
                                      "'nearest_blend' only")
        dist = torch.sqrt(d2)
        reach = BLEND_RANGE * self.scene.patch_scale + dist.min(-1, keepdim=True).values
        w = torch.where(active, torch.clamp(reach - dist, min=0.0), 0.0)
        wsum = torch.zeros_like(t_pt)
        for k in range(K):
            wsum = wsum + w[..., k]
        prob = w / torch.clamp(wsum, min=1e-20)[..., None]
        cum = torch.zeros_like(t_pt)
        count = torch.zeros_like(t_pt, dtype=torch.int64)
        for k in range(K):
            cum = cum + prob[..., k]
            count += u_sel > cum
        sel = torch.minimum(count, tier[:, None] - 1)
        p_sel = prob.gather(-1, sel[..., None])[..., 0]
        weight = torch.where(n_active > 1, 1.0 / torch.clamp(p_sel, min=1e-20), 1.0)
        return lay["inst_k"].gather(1, sel), weight

    def _render(self, o, d, t_proxy, prm, u_off, u_sel, tier):
        s, sc = self.s, self.scene
        o, d, prm = o.float(), d.float(), prm.float()
        R, P = o.shape[0], prm.shape[-1]
        step = self.step
        lay = self.layout(o, d)
        total, tiny, n_steps = lay["total"], lay["tiny"], lay["n_steps"]
        cum_incl, cum_excl, times_s = lay["cum_incl"], lay["cum_excl"], lay["times_s"]
        K = lay["tk0"].shape[-1]
        mesh_hit = torch.isfinite(lay["t_mesh"])
        t_offset = torch.where(tiny, u_off * total, u_off * step)

        light = blocked = None
        if sc.light_dir_idx >= 0 and P > sc.light_dir_idx + 2:
            light = prm[:, sc.light_dir_idx:sc.light_dir_idx + 3]
            if sc.cast_shadow_rays:
                n_sh = int(s["shadow_samples"])
                frac = (torch.arange(n_sh, device=self.dev) + 0.5) / n_sh
                s_sh = frac[None, :] * total[:, None]
                j = torch.clamp(torch.searchsorted(cum_incl.contiguous(), s_sh, right=True),
                                max=2 * K - 1)
                t_sh = times_s.gather(1, j) + (s_sh - cum_excl.gather(1, j))
                pts = o[:, None, :] + d[:, None, :] * t_sh[..., None]
                lights = light[:, None, :].expand(pts.shape)
                blocked = self._occluded(pts.reshape(-1, 3), lights.reshape(-1, 3))
                blocked = blocked.reshape(R, n_sh)

        S = max(int(n_steps.max()), 1)
        i_grid = torch.arange(S, dtype=torch.float32, device=self.dev)[None, :]
        s_arc = i_grid * step + t_offset[:, None]
        j = torch.clamp(torch.searchsorted(cum_incl.contiguous(), s_arc, right=True),
                        max=2 * K - 1)
        t_mu = s_arc + lay["arc_corr"].gather(1, j)
        if sc.use_mean_distance:
            t_pt = t_mu + 2 * t_mu * step**2 / (3 * t_mu**2 + step**2)
        else:
            t_pt = t_mu
        pts_w = o[:, None, :] + d[:, None, :] * t_pt[..., None]
        inst, weight = self._pick(lay, t_pt, None if u_sel is None else u_sel[:, :S], tier)

        rot = self.inv_rot[inst]
        pts_l = torch.sum(rot * pts_w[..., None, :], -1) + self.inv_trans[inst]
        dinv = rot * sc.uniform_scale if sc.uniform_scale is not None else self.dir_inv[inst]
        dirs_l = torch.sum(dinv * d[:, None, None, :], -1)

        prms = prm[:, None, :].expand(R, S, P).clone()
        if sc.texture_slots:
            rel = pts_w - self.origins[inst]
            uv = torch.clamp(self.anchor_uv[inst]
                             + torch.sum(self.uv_jac[inst] * rel[..., None, :], -1), 0.0, 1.0)
            for slot, chan in zip(sc.texture_slots, self.channels):
                prms[..., slot] = prms[..., slot] * self._bilinear(chan, uv)
        if light is not None:
            li, si = sc.light_dir_idx, sc.light_strength_idx
            lw = light[:, None, :]
            vec = lw - pts_w if si >= 0 else lw
            vec_n = vec / torch.clamp(torch.linalg.norm(vec, dim=-1, keepdim=True), min=1e-12)
            local_l = torch.sum(dinv * vec_n[..., None, :], -1)
            if blocked is not None:
                n_sh = blocked.shape[-1]
                bucket = torch.floor(s_arc / torch.clamp(total[:, None], min=1e-12) * n_sh).long()
                shadowed = blocked.gather(1, torch.clamp(bucket, 0, n_sh - 1))
                local_l = torch.where(shadowed[..., None], local_l.new_tensor([0.0, 0.0, -1.0]),
                                      local_l)
            prms[..., li:li + 3] = local_l
            if si >= 0:
                d2l = torch.sum((lw - pts_w) ** 2, -1)
                prms[..., si] = prm[:, si, None] / (4 * math.pi * d2l + 1e-6)

        ns = n_steps[:, None]
        i_int = torch.arange(S, device=self.dev)[None, :]
        dists = torch.where(i_int == ns - 1, step + total[:, None] - ns * step,
                            torch.full((1, S), step, dtype=torch.float32, device=self.dev))
        dists = torch.where(tiny[:, None], torch.where(i_int == 0, total[:, None], 0.0), dists)
        dists = torch.where(i_int < ns, dists, 0.0)

        mask = dists > 0
        valid = (~(torch.isinf(t_proxy[:, 0]) | ~(lay["hit_box"] | mesh_hit))).float()
        reweigh = bool(s.get("density_reweighting", True))
        out = []
        for mlp in self.mlps:
            logits = torch.zeros(R, S, 3, device=self.dev)
            density = torch.zeros(R, S, device=self.dev)
            if mask.any():
                c, dens = mlp(pts_l[mask], dirs_l[mask], prms[mask])
                logits[mask], density[mask] = c, dens
            if reweigh:
                density = density * weight
            density = density * float(s.get("density_scale", 1.0))
            alpha = 1.0 - torch.exp(-torch.relu(density) * dists / sc.patch_scale)
            color_map = torch.cat([torch.sigmoid(logits), torch.zeros(R, 1, 3, device=self.dev)],
                                  1)
            alpha_map = torch.cat([alpha, mesh_hit[:, None].float()], 1)
            trans = torch.cumprod(1.0 - alpha_map + 1e-10, -1)
            trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], -1)
            weights = alpha_map * trans
            color = torch.sum(weights[..., None] * color_map, -2)
            out.append((color * valid[:, None], torch.sum(weights, -1) * valid))
        return out
