"""A plain reference of the instanced frame, ray by ray.

For each ray it does in PyTorch what the instanced renderer is to compute
(NeRF-Tex's instancer and volume march, with the program's documented
caps): the first hit of the base mesh; a slab test of every instance's
local box, of which the ``max_hits`` nearest entries are kept, clipped at
the mesh; the union of those intervals as an arc, marched at
``step_size`` from an offset drawn per ray, at most ``max_steps_per_ray``
steps; at each sample the active instance whose anchor is nearest; the
sample's local position and direction; texture-driven parameter slots
from the instance's linearised UV map; the light in the local frame, with
a point light's inverse-square strength and, with shadows, the occlusion
of ``shadow_samples`` points spread over the arc, each sample taking its
arc bucket's; the MLP (benchmark/reference/mlp.py) on every sample; and
the composite with the mesh as an opaque black terminator.

Every ray is computed whole, with no culling, no sorting into blocks and
no kernel; the arithmetic of each step is written out in float32 as the
upstream instancer states it, with the anchor distance and the 3-term
dot products contracted as fused multiply-adds.  It imports nothing of
the program.
"""

import math

import numpy as np
import torch

from benchmark.reference import jax_rng

T_FAR = 100.0
INF = float("inf")
STREAM_PERTURB = 1


def fma(a, b, c):
    """a * b + c rounded once to float32."""
    return (a.double() * b.double() + c.double()).float()


def dot3(a, b):
    return fma(a[..., 2], b[..., 2], fma(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def look_at(pos, eps=1e-6):
    """Camera-to-world [4, 4] float32 looking from pos at the origin, z up."""
    pos = np.asarray(pos, np.float64)

    def norm(v):
        return v / np.linalg.norm(v)

    fwd = norm(pos + eps)
    right = norm(np.cross([0, 0, 1.0], fwd) + eps)
    up = norm(np.cross(fwd, right) + eps)
    top = np.stack([right, up, fwd, pos], axis=1)
    return np.concatenate([top, [[0, 0, 0, 1.0]]], axis=0).astype(np.float32)


def pixel_rays(c2w, height, width, angle, pixels, device):
    """Normalized rays (rays_o, rays_d) [M, 3] of pixel indices [M] of a
    height x width pinhole camera with horizontal field ``angle``."""
    focal = float(np.float32(width / np.tan(angle / 2) / 2))
    pixels = torch.as_tensor(pixels, device=device)
    row, col = (pixels // width).float(), (pixels % width).float()
    dirs = torch.stack([(col + 0.5 - 0.5 * width) / focal, -(row + 0.5 - 0.5 * height) / focal,
                        -torch.ones_like(row)], -1)
    m = torch.as_tensor(c2w, device=device)
    rays_d = torch.sum(dirs[:, None, :] * m[:3, :3], -1)
    rays_o = m[:3, -1].expand(rays_d.shape)
    return rays_o, rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)


def proxy_t(rays_o, rays_d, b_0, b_1):
    """Entry and exit of the proxy box [M, 2], inf on a miss."""
    b_0 = torch.as_tensor(np.asarray(b_0, np.float32), device=rays_o.device)
    b_1 = torch.as_tensor(np.asarray(b_1, np.float32), device=rays_o.device)
    inv_d = 1.0 / rays_d
    t_a, t_b = (b_0 - rays_o) * inv_d, (b_1 - rays_o) * inv_d
    t_0 = torch.minimum(t_a, t_b).amax(-1)
    t_1 = torch.maximum(t_a, t_b).amin(-1)
    hit = t_0 < t_1
    return torch.stack([torch.where(hit, t_0, INF), torch.where(hit, t_1, INF)], -1)


def frame_offsets(seed, call, n_rays, ray_block, pixels, device):
    """The marching offset of each pixel [M] of the ``call``-th frame a
    renderer draws under the configuration's ``seed``: its key is
    fold_in(fold_in(fold_in(key(seed), STREAM_PERTURB), call), 0) (the
    frame's stream, then its one chunk, which starts at ray 0), split in
    two; ray block b of the frame draws uniform(split(fold_in(first, b))[0],
    (block,)) and ray i takes entry i % block of block i // block."""
    key = jax_rng.fold_in(jax_rng.fold_in(jax_rng.fold_in(jax_rng.key(seed), STREAM_PERTURB),
                                          call), 0)
    k_inst = jax_rng.split(key)[0]
    block = min(ray_block, n_rays)
    pixels = torch.as_tensor(pixels, dtype=torch.int64)
    blocks = torch.unique(pixels // block)
    keys = jax_rng.block_keys(k_inst, -(-n_rays // block))[blocks]
    rows = jax_rng.uniform_rows(keys, block, device)
    where = torch.searchsorted(blocks, pixels // block)
    return rows[where.to(device), (pixels % block).to(device)]


def moller_trumbore(o, d, v0, e1, e2):
    """First-hit distance [R, T] of each ray to each triangle, inf if none."""
    ox, oy, oz = (o[:, c, None] for c in range(3))
    dx, dy, dz = (d[:, c, None] for c in range(3))
    e2x, e2y, e2z = e2.unbind(-1)
    e1x, e1y, e1z = e1.unbind(-1)
    v0x, v0y, v0z = v0.unbind(-1)
    px, py, pz = dy * e2z - dz * e2y, dz * e2x - dx * e2z, dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv_det = 1.0 / torch.where(det.abs() < 1e-12, 1e-12, det)
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx, qy, qz = ty * e1z - tz * e1y, tz * e1x - tx * e1z, tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok = (det.abs() > 1e-12) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-6) & (t < T_FAR)
    return torch.where(ok, t, INF)


class ReferenceRenderer:
    """The reference frame of one scene (scene.SceneTables) under the
    instancer ``settings`` actually in effect, composited once for each of
    ``mlps`` (mlp.ReferenceMLP: the float32 model, and the control's) over
    one pass of the geometry."""

    # Points per shadow query chunk (each [points, columns] plane at most
    # about 2^24 elements).
    SHADOW_PLANE = 1 << 24

    def __init__(self, scene, settings: dict, mlps, device):
        self.s = settings
        self.mlps = list(mlps)
        self.dev = device

        def t(x):
            return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)

        self.scene = scene
        self.inv_rot = t(scene.inverse[:, :3, :3])
        self.inv_trans = t(scene.inverse[:, :3, 3])
        self.dir_inv = t(scene.dir_inverse)
        self.origins = t(scene.origins)
        self.anchor_uv, self.uv_jac = t(scene.anchor_uv), t(scene.uv_jacobian)
        self.b_0, self.b_1 = t(scene.b_0), t(scene.b_1)
        self.v0, self.e1, self.e2 = t(scene.tri_v0), t(scene.tri_e1), t(scene.tri_e2)
        self.ng = torch.linalg.cross(self.e1, self.e2)
        self.channels = [t(c) for c in scene.channels]

    # -- per ray -----------------------------------------------------------

    def _intervals(self, o, d, t_mesh):
        """The K nearest valid intervals (entry order) of each ray: tk0, tk1,
        instance, valid [R, K]; whether any box is hit [R]."""
        n = self.inv_trans.shape[0]
        K = min(int(self.s["max_hits"]), n)
        R = o.shape[0]
        t0 = torch.full((R, n), -INF, device=self.dev)
        t1 = torch.full((R, n), INF, device=self.dev)
        for c in range(3):
            rot_c = self.inv_rot[:, c, :].T
            o_lc = o @ rot_c + self.inv_trans[:, c]
            d_lc = d @ rot_c
            inv_dl = 1.0 / torch.where(d_lc.abs() < 1e-12, 1e-12, d_lc)
            t_a = (self.b_0[c] - o_lc) * inv_dl
            t_b = (self.b_1[c] - o_lc) * inv_dl
            t0 = torch.maximum(t0, torch.minimum(t_a, t_b))
            t1 = torch.minimum(t1, torch.maximum(t_a, t_b))
        box_hit = (t0 < t1) & (t1 > 0) & (t0 < T_FAR)
        t0c = torch.clamp(t0, 0.0, T_FAR)
        t1c = torch.minimum(torch.clamp(t1, 0.0, T_FAR), t_mesh[:, None])
        valid = box_hit & (t0c < t1c)
        score = torch.where(valid, t0c, INF)
        score_s, sel = torch.sort(score, dim=-1, stable=True)
        tk0, sel = score_s[:, :K], sel[:, :K]
        kvalid = torch.isfinite(tk0)
        tk1 = torch.where(kvalid, t1c.gather(1, sel), INF)
        return tk0, tk1, sel, kvalid, box_hit.any(-1)

    def _occluded(self, pts, light):
        """Whether anything blocks each point [M, 3] toward ``light`` [M, 3]:
        an instance box's bottom face, its top face from above, or a mesh
        triangle's front."""
        rot, trans, b0, b1 = self.inv_rot, self.inv_trans, self.b_0, self.b_1
        cols = max(rot.shape[0], self.v0.shape[0])
        m = max(1, self.SHADOW_PLANE // cols)
        out = []
        for i in range(0, pts.shape[0], m):
            p, l = pts[i:i + m], light[i:i + m]

            def row(c, v):
                return (v[:, 0, None] * rot[:, c, 0] + v[:, 1, None] * rot[:, c, 1]
                        + v[:, 2, None] * rot[:, c, 2])

            o_x, o_y, o_z = (row(c, p) + trans[:, c] for c in range(3))
            d_x, d_y, d_z = (row(c, l) for c in range(3))
            safe_dz = torch.where(d_z.abs() < 1e-12, 1e-12, d_z)
            dz_ok = d_z.abs() > 1e-12

            def face(z):
                t = (z - o_z) / safe_dz
                px, py = o_x + t * d_x, o_y + t * d_y
                return ((t > 0) & (t < T_FAR) & (px >= b0[0]) & (px <= b1[0]) & (py >= b0[1])
                        & (py <= b1[1]) & dz_ok)

            blocked = ((face(b1[2]) & (d_z < 0)) | face(b0[2])).any(-1)
            t_hit = moller_trumbore(p, l, self.v0, self.e1, self.e2)
            front = (l[:, 0, None] * self.ng[:, 0] + l[:, 1, None] * self.ng[:, 1]
                     + l[:, 2, None] * self.ng[:, 2]) < 0
            out.append(blocked | (torch.isfinite(t_hit) & front).any(-1))
        return torch.cat(out)

    def render(self, rays_o, rays_d, t_proxy, parameters, u_off):
        """[(premultiplied color [R, 3], alpha [R])] of R rays, one for each
        of the renderer's MLPs; parameters [R, P] are the frame's, u_off [R]
        the rays' marching offsets."""
        s, sc = self.s, self.scene
        o, d, prm = rays_o.float(), rays_d.float(), parameters.float()
        R, P = o.shape[0], prm.shape[-1]
        step = float(s["step_size"])
        cap = min(int(s["n_samples"]), int(s["max_steps_per_ray"]))

        t_mesh = moller_trumbore(o, d, self.v0, self.e1, self.e2).min(-1).values
        mesh_hit = torch.isfinite(t_mesh)
        tk0, tk1, inst_k, kvalid, hit_box = self._intervals(o, d, t_mesh)
        K = tk0.shape[-1]
        diff = o[:, None, :] - self.origins[inst_k]
        sel_a = dot3(diff, diff)
        sel_b = dot3(d[:, None, :].expand_as(diff), diff)

        # The union of the intervals: sorted events, starts before ends.
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

        necessary = torch.floor(total / step).to(torch.int32)
        tiny = (necessary == 0) & (total > 0)
        n_steps = torch.where(tiny, 1, torch.clamp(necessary, max=cap)).to(torch.int32)
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

        # Samples on the arc, mapped to world t.
        S = max(int(n_steps.max()), 1)
        i_grid = torch.arange(S, dtype=torch.float32, device=self.dev)[None, :]
        s_arc = i_grid * step + t_offset[:, None]
        j = torch.clamp(torch.searchsorted(cum_incl.contiguous(), s_arc, right=True),
                        max=2 * K - 1)
        t_mu = s_arc + arc_corr.gather(1, j)
        if sc.use_mean_distance:
            t_pt = t_mu + 2 * t_mu * step**2 / (3 * t_mu**2 + step**2)
        else:
            t_pt = t_mu
        pts_w = o[:, None, :] + d[:, None, :] * t_pt[..., None]

        # The active instance with the nearest anchor (the nearest interval
        # when none is active).
        if sc.method != "nearest":
            raise NotImplementedError("the reference resolves overlaps by 'nearest' only")
        tp = t_pt[..., None]
        kv = kvalid[:, None, :]
        active = kv & (tk0[:, None, :] <= tp) & (tp < tk1[:, None, :])
        n_active = active.sum(-1)
        iv_dist = torch.maximum(tk0[:, None, :] - tp, tp - tk1[:, None, :])
        iv_dist = torch.where(kv, torch.clamp(iv_dist, min=0.0), INF)
        fallback = torch.nn.functional.one_hot(torch.argmin(iv_dist, -1), K).bool()
        active = torch.where((n_active == 0)[..., None], fallback, active)
        d2 = fma(tp, tp, fma(2.0 * tp, sel_b[:, None, :], sel_a[:, None, :]))
        d2 = torch.where(active, torch.clamp(d2, min=0.0), INF)
        inst = inst_k.gather(1, torch.argmin(d2, -1))                        # [R,S]

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

        # Spacing: step, a longer last one, a tiny arc's single sample.
        ns = n_steps[:, None]
        i_int = torch.arange(S, device=self.dev)[None, :]
        dists = torch.where(i_int == ns - 1, step + total[:, None] - ns * step,
                            torch.full((1, S), step, dtype=torch.float32, device=self.dev))
        dists = torch.where(tiny[:, None], torch.where(i_int == 0, total[:, None], 0.0), dists)
        dists = torch.where(i_int < ns, dists, 0.0)

        mask = dists > 0
        valid = (~(torch.isinf(t_proxy[:, 0]) | ~(hit_box | mesh_hit))).float()
        out = []
        for mlp in self.mlps:
            logits = torch.zeros(R, S, 3, device=self.dev)
            density = torch.zeros(R, S, device=self.dev)
            if mask.any():
                c, dens = mlp(pts_l[mask], dirs_l[mask], prms[mask])
                logits[mask], density[mask] = c, dens
            # A nearest pick weighs its sample 1, so density reweighting
            # leaves the density as it is.
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

    @staticmethod
    def _bilinear(chan, uv):
        w, h = chan.shape
        x = torch.clamp(uv[..., 0], 0, 1) * (w - 1)
        y = torch.clamp(uv[..., 1], 0, 1) * (h - 1)
        x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, max(w - 2, 0))
        y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, max(h - 2, 0))
        x1, y1 = torch.clamp(x0 + 1, max=w - 1), torch.clamp(y0 + 1, max=h - 1)
        fx, fy = x - x0.to(x.dtype), y - y0.to(y.dtype)
        flat = chan.reshape(-1)
        c0 = flat[x0 * h + y0] * (1 - fy) + flat[x0 * h + y1] * fy
        c1 = flat[x1 * h + y0] * (1 - fy) + flat[x1 * h + y1] * fy
        return c0 * (1 - fx) + c1 * fx


def straight_rgba(color, alpha):
    """Straight-alpha RGBA [R, 4] of premultiplied color and alpha, clipped
    to [0, 1], as a renderer hands a frame out."""
    img = torch.cat([color, alpha[:, None]], -1)
    img = torch.cat([img[:, :3] / (img[:, 3:] + 1e-5), img[:, 3:]], -1)
    return torch.clamp(img, 0, 1)
