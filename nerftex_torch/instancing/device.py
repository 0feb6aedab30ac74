"""Device instancer: per-ray hit intervals, per-sample overlap resolution,
local frames and texture parameters, in PyTorch.

Counterpart of nerftex_tpu/instancing/device.py for the grid render paths
(``random``, ``nearest`` and ``nearest_blend`` overlap selection, a
directional or point light, optional shadow rays, auxiliary meshes with
shaded terminators):

  1. ``_per_ray``: slab tests of every ray against every instance's local
     box (or the exact fan-culled candidates), top-K nearest intervals
     clipped at the first hit of the triangle soup (base mesh plus
     auxiliary meshes; Moller-Trumbore, optionally over the fan-culled
     triangles), the union of intervals as sorted events with prefix sums,
     the per-ray sample layout (``n_steps``, offset), all of it through
     kernels.per_ray (one CUDA pass on the card), and, with shadows, the
     per-ray ``shadow_blocked`` table: occlusion toward the light of
     ``shadow_samples`` points spread over the inside arc, through the
     exact skip/culled/full branch of ``_occlusion_branched``; with
     auxiliary meshes, the terminator's color (``_shade_terminator``:
     Lambert plus ambient over the aux mesh's albedo, shadowed, the base
     mesh black);
  2. ``_per_sample_grid``: arc-length sample positions mapped to world t,
     the overlap pick among the active intervals (kernels.selk_resolve)
     and its density weight,
     then ``_per_sample_grid_tail``: local transforms, the texture-driven
     parameter slots (through kernels.tex_gather) and the light direction
     (toward a point light's position, with its inverse-square strength),
     pointed down for samples whose shadow bucket is blocked;
  3. ``render_grid_sorted``: the per-ray stage for all rays, rays sorted by
     step count, each sorted block run at its own maximum step count and,
     for K >= 64, at the JAX package's hit tier (all-empty blocks take the
     caller's terminator-only shading), and the results put back in ray
     order.  ``get_model_input`` is the dense grid over
     ``min(n_samples, max_steps_per_ray)`` steps, the exactness yardstick
     of the sorted path;
  4. ``get_model_input_compact``: per ray block, the valid samples packed
     sample-major into ``budget_per_ray`` x Rb slots (the deepest dropped
     past it), then ``_per_sample`` on those slots alone: the grid path's
     arc-to-t step, pick and tail on [M] samples.

Texture slots take each sample's uv from the instance's linearised anchor
map (``texture_lookup="jacobian"``) or from the exact closest point over
the instance's nearest base-mesh triangles (``"closest"``).

The JAX package's one-hot selects, packed permutes, layout barriers and
``lax.switch`` buckets exist for the TPU; here they are plain indexing,
``torch.sort`` and per-block dynamic shapes, with the same results.  On
the card the culls' branches are chosen by the per-ray kernels; the CPU's
eager chain chooses them on the host.

Random draws.  Per-ray stratified offsets are 0.5 with
``deterministic_offset``, else drawn from the caller's ``key``
(utils.jax_rng: the very numbers the JAX package draws from the same key).
The per-sample pick draws ``u_sel`` from the key likewise.

A point light's position sits in the light-direction slots; the shadow and
terminator passes take it as a direction, as the JAX package does (its
grass golden frame was rendered so).
"""

import bisect
import math

import numpy as np
import torch

from nerftex_torch.instancing.geometry import dot3, fma, keep_to_candidates, slab_kappa
from nerftex_torch.instancing.scene import Scene
from nerftex_torch.kernels.per_ray import per_ray
from nerftex_torch.kernels.selk_resolve import selk_resolve
from nerftex_torch.kernels.shadow_query import shadow_query
from nerftex_torch.kernels.tex_gather import byte_quads, sample_channel
from nerftex_torch.models.encodings import check_matmul_precision
from nerftex_torch.ops.volume import mean_distance
from nerftex_torch.utils import jax_rng, trace
from nerftex_torch.utils.util import as_f32

_INF = float("inf")
# The sorted path's per-sample stream folds this into the key (JAX's
# render_grid_sorted), disjoint from the per-block folds of the offsets.
_SORTED_FOLD = 0x7FFFFFFF


class DeviceScene:
    """The compiled Scene's tables as tensors on one device."""

    def __init__(self, scene: Scene, device: torch.device):
        def t(x, dtype=torch.float32):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

        n = scene.n_instances()
        self.n_instances = n
        inv = np.asarray(scene.inverse, np.float32).reshape(n, 4, 4)
        self.inv_rot = t(inv[:, :3, :3])
        self.inv_trans = t(inv[:, :3, 3])
        self.dir_inv = t(np.asarray(scene.dir_inverse, np.float32).reshape(n, 3, 3))
        self.origins = t(np.asarray(scene.origins, np.float32).reshape(n, 3))
        self.b_0 = t(scene.b_0)
        self.b_1 = t(scene.b_1)

        # Triangle soup: the base mesh (mesh id 0) then the auxiliary meshes
        # (1, 2, ...; without a base mesh the first aux mesh takes id 0, as
        # in the JAX package), with vertex normals and UVs per corner.
        meshes = ([scene.base_mesh] if scene.base_mesh is not None else []) + scene.aux_meshes
        self.n_meshes = len(meshes)
        parts = [(mid, m) for mid, m in enumerate(meshes) if len(m.F)]
        self.n_tris = 0
        if parts:
            v0 = np.concatenate([m.V[m.F[:, 0]] for _, m in parts])
            e1 = np.concatenate([m.V[m.F[:, 1]] - m.V[m.F[:, 0]] for _, m in parts])
            e2 = np.concatenate([m.V[m.F[:, 2]] - m.V[m.F[:, 0]] for _, m in parts])
            self.tri_v0, self.tri_e1, self.tri_e2 = t(v0), t(e1), t(e2)
            self.tri_n = t(np.concatenate([np.stack([m.N[m.F[:, k]] for k in range(3)], 1)
                                           for _, m in parts]))                     # [T,3,3]
            self.tri_uv = t(np.concatenate([np.stack([m.UV[m.F[:, k]] for k in range(3)], 1)
                                            for _, m in parts]))                    # [T,3,2]
            self.tri_mesh_id = t(np.concatenate([np.full(len(m.F), mid) for mid, m in parts]),
                                 torch.int64)
            # Geometric normals for the shadow query's front-face test.
            self.tri_ng = torch.linalg.cross(self.tri_e1, self.tri_e2)
            self.n_tris = len(v0)
            # Triangle bounding spheres for the block-fan cull.
            cen = v0 + (e1 + e2) / 3.0
            rad = np.maximum(
                np.linalg.norm(cen - v0, axis=-1),
                np.maximum(np.linalg.norm(cen - (v0 + e1), axis=-1),
                           np.linalg.norm(cen - (v0 + e2), axis=-1)),
            )
            self.tri_center, self.tri_radius = t(cen), t(rad)

        # Albedo textures of the meshes as [M, W, H, 3] (gray replicated),
        # -1 where a mesh has none or is smaller; None when none has one.
        self.mesh_tex = None
        if any(m.textures for m in meshes):
            w = max(c.shape[0] for m in meshes for c in m.textures)
            h = max(c.shape[1] for m in meshes for c in m.textures)
            stack = np.full((len(meshes), w, h, 3), -1.0, np.float32)
            for i, m in enumerate(meshes):
                chans = m.textures if len(m.textures) >= 3 else m.textures[:1] * 3
                for c, ch in enumerate(chans[:3]):
                    stack[i, :ch.shape[0], :ch.shape[1], c] = ch
            self.mesh_tex = t(stack)

        # Each instance's k nearest base-mesh triangles, for the exact
        # closest-point texture lookup (texture_lookup="closest").
        self.tri_candidates, self.k_tri = None, 0
        if getattr(scene, "instance_tri_candidates", None) is not None and \
                scene.base_mesh is not None:
            self.tri_candidates = t(scene.instance_tri_candidates, torch.int64)
            self.k_tri = int(self.tri_candidates.shape[1])

        self.anchor_uv = self.uv_jacobian = None
        if getattr(scene, "anchor_uv", None) is not None:
            self.anchor_uv = t(scene.anchor_uv)
            self.uv_jacobian = t(scene.uv_jacobian)

        # Parameter texture channels at their own [W, H] (v from the bottom),
        # each with its byte-quad table where the channel is byte valued
        # (None otherwise: the fetch then reads the f32 channel).
        self.tex_channels = [t(c).contiguous() for c in scene.texture_channels]
        self.tex_quads = [byte_quads(c) for c in self.tex_channels]

        # Per-instance world bounding spheres: the 8 corners of the local
        # patch box pushed through each forward transform.
        if n:
            fwd = np.asarray(scene.forward, np.float32).reshape(n, 4, 4)
            b0 = np.asarray(scene.b_0, np.float32)
            b1 = np.asarray(scene.b_1, np.float32)
            corners = np.array([[x, y, z] for x in (b0[0], b1[0]) for y in (b0[1], b1[1])
                                for z in (b0[2], b1[2])], np.float32)
            wc = np.einsum("nij,kj->nki", fwd[:, :3, :3], corners) + fwd[:, None, :3, 3]
            center = wc.mean(1)
            self.inst_center = t(center)
            self.inst_radius = t(np.linalg.norm(wc - center[:, None], axis=-1).max(1))
            # How far rounding inv_rot's entries moves a box (geometry.slab_pad).
            self.slab_kappa = slab_kappa(inv[:, :3, :3])

        # A uniformly scaled rotation (the mesh placement path always is)
        # lets the local direction transform reuse inv_rot.
        self.uniform_scale = None
        if n:
            scales = np.linalg.norm(np.asarray(scene.forward)[:, :3, 0], axis=-1)
            dir_from_inv = inv[:, :3, :3] * scales[:, None, None]
            if (np.abs(scales - scales[0]) < 1e-5 * max(scales[0], 1e-9)).all() and np.abs(
                dir_from_inv - np.asarray(scene.dir_inverse, np.float32)
            ).max() < 1e-4:
                self.uniform_scale = float(scales[0])

        self.patch_scale = float(scene.patch_scale)
        self.light_dir_idx = int(scene.light_dir_idx)
        self.light_strength_idx = int(scene.light_strength_idx)
        self.texture_parameter_idxs = tuple(scene.texture_parameter_idxs)
        self.use_mean_distance = bool(scene.use_mean_distance)
        self.cast_shadow_rays = bool(scene.cast_shadow_rays)
        self.instance_sampling_method = scene.instance_sampling_method
        self.nearest_blend_range = 0.2 * self.patch_scale


# ---------------------------------------------------------------------------
# geometry helpers
# ---------------------------------------------------------------------------


def _light_cone(light_dir, valid):
    """Cone bound of the valid rows' light directions: unit mean axis, a
    conservative tan of the half-angle, and a ``wide`` flag (cos below
    0.1) that turns culling off."""
    eps = 1e-12
    l = light_dir / torch.clamp(torch.linalg.norm(light_dir, dim=-1, keepdim=True), min=eps)
    w = valid.float()[:, None]
    u = torch.sum(l * w, 0) / torch.clamp(torch.sum(w), min=1.0)
    u = u / torch.clamp(torch.linalg.norm(u), min=eps)
    cos_min = torch.min(torch.where(valid, l @ u, 1.0))
    cos_safe = torch.clamp(cos_min, min=0.1)
    sin_max = torch.sqrt(torch.clamp(1.0 - cos_safe * cos_safe, min=0.0))
    return u, sin_max / cos_safe, cos_min <= 0.1


def _swept_keep(c, r, u_l, tan_a, centers, radii):
    """Conservative sphere-vs-swept-cone test: False only for spheres that
    no segment from the ball (c, r) toward the light cone can reach."""
    v = centers - c
    va = v @ u_l
    lat2 = torch.sum(v * v, -1) - va * va
    reach = radii + r
    slack = reach + torch.clamp(va + reach, min=0.0) * tan_a
    return (va >= -reach) & (lat2 <= slack * slack)


def _point_bound(pts, valid):
    """Bounding sphere of pts[valid], its radius inflated by a relative
    epsilon; a zero sphere at the origin when nothing is valid."""
    pts_safe = torch.where(valid[:, None], pts, 0.0)
    w = valid.float()[:, None]
    c = torch.sum(pts_safe * w, 0) / torch.clamp(torch.sum(w), min=1.0)
    d2 = torch.sum((pts_safe - c) ** 2, -1)
    r = torch.sqrt(torch.max(torch.where(valid, d2, 0.0)))
    return c, r * 1.001 + 1e-5


def _slice_hits(ray, K_b):
    """A block's per-ray tables cut to their first K_b hit slots (2 K_b
    events)."""
    ray = dict(ray)
    for k in ("tk0", "tk1", "inst_idx", "kvalid", "sel_a", "sel_b"):
        ray[k] = ray[k][:, :K_b]
    for k in ("cum_incl", "arc_corr"):
        ray[k] = ray[k][:, :2 * K_b].contiguous()
    return ray


def _closest_point_tri(p, a, b, c):
    """Barycentrics [..., 3] of the exact closest point of triangle (a, b, c)
    to p (Ericson's region tests, as scene.closest_point_triangles), with
    the JAX package's guard eps and order of selects (the last matching
    region wins)."""
    ab, ac = b - a, c - a
    ap, bp, cp = p - a, p - b, p - c
    d1, d2 = dot3(ab, ap), dot3(ac, ap)
    d3, d4 = dot3(ab, bp), dot3(ac, bp)
    d5, d6 = dot3(ab, cp), dot3(ac, cp)
    # a * b - c * d as XLA contracts it: fma(a, b, -(c d)).
    vc = fma(d1, d4, -(d3 * d2))
    vb = fma(d5, d2, -(d1 * d6))
    va = fma(d3, d6, -(d5 * d4))

    eps = 1e-20

    def guard(x):
        return torch.where(x.abs() < eps, eps, x)

    denom = 1.0 / guard(va + vb + vc)
    v_in, w_in = vb * denom, vc * denom
    v_ab = d1 / guard(d1 - d3)
    v_ac = d2 / guard(d2 - d6)
    v_bc = (d4 - d3) / guard((d4 - d3) + (d5 - d6))
    zero, one = torch.zeros_like(d1), torch.ones_like(d1)

    bary = torch.stack([fma(-vc, denom, 1 - v_in), v_in, w_in], -1)
    for region, corners in (
        ((va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0), (zero, 1 - v_bc, v_bc)),
        ((vb <= 0) & (d2 >= 0) & (d6 <= 0), (1 - v_ac, zero, v_ac)),
        ((vc <= 0) & (d1 >= 0) & (d3 <= 0), (1 - v_ab, v_ab, zero)),
        ((d6 >= 0) & (d5 <= d6), (zero, zero, one)),
        ((d3 >= 0) & (d4 <= d3), (zero, one, zero)),
        ((d1 <= 0) & (d2 <= 0), (one, zero, zero)),
    ):
        bary = torch.where(region[..., None], torch.stack(corners, -1), bary)
    bary = torch.clamp(bary, 0, 1)
    return bary / torch.clamp(bary.sum(-1, keepdim=True), min=eps)


def _dists_grid(n_steps, total, tiny, S, step):
    """Sample spacing [Rb, S] from the per-ray scalars: uniform ``step``, a
    shortened last interval, and the single sample of a tiny interval."""
    i_grid = torch.arange(S, device=n_steps.device)[None, :]
    ns = n_steps[:, None]
    dists = torch.where(i_grid == ns - 1, step + total[:, None] - ns * step,
                        torch.full((1, S), step, dtype=torch.float32, device=n_steps.device))
    dists = torch.where(tiny[:, None], torch.where(i_grid == 0, total[:, None], 0.0), dists)
    return torch.where(i_grid < ns, dists, 0.0)


# ---------------------------------------------------------------------------
# the instancer
# ---------------------------------------------------------------------------


class DeviceInstancer:
    """Per-ray and per-sample instancing of one compiled Scene on one
    device; see the module docstring for the stages."""

    def __init__(
        self,
        scene: Scene,
        device: torch.device,
        max_hits: int = 64,
        ray_block: int = 256,
        max_steps_per_ray: int = 512,
        cull_budget: int = 0,
        tri_cull_budget: int = 0,
        shadow_samples: int = 32,
        shadow_cull_budget: int = 0,
        shadow_tri_cull_budget: int = 0,
        deterministic_offset: bool = False,
        matmul_precision: str = "float32",
        texture_lookup: str = "jacobian",
        seed: int = 0,
    ):
        if scene.instance_sampling_method not in ("random", "nearest", "nearest_blend"):
            raise ValueError(
                f"unknown instance_sampling_method {scene.instance_sampling_method!r}")
        self.device = device
        self.ds = DeviceScene(scene, device)
        self.max_hits = max_hits
        self.ray_block = ray_block
        self.max_steps_per_ray = max_steps_per_ray
        # Exact speed tiers: a block whose conservative keep set fits the
        # budget tests only those candidates, any other block all of them;
        # likewise for the shadow query's swept-cone keep sets.
        self.cull_budget = cull_budget
        self.tri_cull_budget = tri_cull_budget
        self.shadow_samples = shadow_samples
        self.shadow_cull_budget = shadow_cull_budget
        self.shadow_tri_cull_budget = shadow_tri_cull_budget
        self.deterministic_offset = deterministic_offset
        # Operand rounding of the slab test's ray-to-local matmuls (see
        # models.encodings.round_operand).
        self.matmul_precision = check_matmul_precision(matmul_precision)
        # "jacobian": a texture's uv from the instance's linearised anchor
        # map; "closest" (or any other value, as in the JAX package): the
        # exact closest point over the instance's k nearest base-mesh
        # triangles.
        self.texture_lookup = texture_lookup
        # A call without a key draws under fold_in(key(seed), n) for its
        # n-th keyless call, as the JAX package does.
        self.seed = seed
        self._call_counter = 0

        ds = self.ds
        n = ds.n_instances
        self.use_jac = (bool(ds.texture_parameter_idxs) and texture_lookup == "jacobian"
                        and ds.anchor_uv is not None)
        # One [N, D] per-instance table read once per sample: inv_rot 9,
        # inv_trans 3, [dir_inv 9], [anchor_uv 2, uv_jacobian 6, origins 3].
        cols = [ds.inv_rot.reshape(n, 9), ds.inv_trans]
        if ds.uniform_scale is None:
            cols.append(ds.dir_inv.reshape(n, 9))
        if self.use_jac:
            cols += [ds.anchor_uv, ds.uv_jacobian.reshape(n, 6), ds.origins]
        self.inst_table = torch.cat(cols, -1).contiguous()
        # The local light of a shadowed sample: straight from below.
        self._light_down = torch.tensor([0.0, 0.0, -1.0], device=device)

    def n_instances(self) -> int:
        return self.ds.n_instances

    # -- ray batches ------------------------------------------------------

    def _prepare(self, rays_o, rays_d, parameters, key, extra=()):
        """Float32 tensors on this device, padded to a multiple of the ray
        block, and the per-ray offsets u_off: 0.5 with
        ``deterministic_offset``, else drawn from ``key`` as JAX draws them
        for each ray block (split(fold_in(key, block))[0])."""
        dev = self.device
        rays_o, rays_d, parameters = (as_f32(x, dev) for x in (rays_o, rays_d, parameters))
        r = rays_o.shape[0]
        block = min(self.ray_block, r)
        n_pad = -(-r // block) * block
        if self.deterministic_offset:
            u_off = torch.full((r,), 0.5, device=dev)
        else:
            keys = jax_rng.block_keys(key, n_pad // block)
            if keys.device.type == "cpu":
                # Keys made on the host: a card waits for their copy (counted
                # on every device, so that a CPU run counts what a card's does).
                with trace.host_read("keys"):
                    keys = keys.to(dev)
            u_off = jax_rng.uniform_rows(keys, block, dev).reshape(-1)
        extra = tuple(extra)
        if n_pad > r:
            pad = n_pad - r
            rays_o = torch.cat([rays_o, rays_o.new_zeros(pad, 3)])
            with trace.host_read("pad"):
                up = rays_d.new_tensor([[0, 0, 1.0]])
            rays_d = torch.cat([rays_d, up.expand(pad, 3)])
            parameters = torch.cat([parameters, parameters.new_zeros(pad, parameters.shape[1])])
            if u_off.shape[0] < n_pad:
                u_off = torch.cat([u_off, u_off.new_full((pad,), 0.5)])
            extra = tuple(torch.cat([e, e.new_zeros((pad,) + e.shape[1:])]) for e in extra)
        return rays_o, rays_d, parameters, u_off, extra, r, block

    def _draw_u_sel(self, shape, key, full_width=None):
        """The per-sample pick's uniforms [Rb, S] (None for ``nearest``):
        JAX's draw under ``key``."""
        if self.ds.instance_sampling_method == "nearest":
            return None
        return jax_rng.uniform(key, shape, self.device, full_width=full_width)

    def _call_key(self, key):
        """``key``, or for the n-th call without one fold_in(key(seed), n),
        as the JAX package draws."""
        if key is None:
            key = jax_rng.fold_in(jax_rng.key(self.seed), self._call_counter)
            self._call_counter += 1
        return key

    def get_model_input(self, rays_o, rays_d, parameters, n_samples, step_size, key=None):
        """Dense grid over S = min(n_samples, max_steps_per_ray) steps:
        rays_d [R,S,3] (local), pts [R,S,3] (local), t, dists,
        alpha_weight, instance_id [R,S], parameters [R,S,P],
        color_last [R,1,3], alpha_last [R,1], hit [R] and the overflow
        counts.  Block b draws its pick uniforms from
        split(fold_in(key, b))[1] of the jax_rng ``key``, as the JAX
        package's dense path does."""
        key = self._call_key(key)
        rays_o, rays_d, parameters, u_off, _, r, block = self._prepare(
            rays_o, rays_d, parameters, key)
        S = min(int(n_samples), self.max_steps_per_ray)
        step = float(step_size)
        outs = []
        for b, i in enumerate(range(0, rays_o.shape[0], block)):
            k_sample = jax_rng.split(jax_rng.fold_in(key, b))[1]
            outs.append(self._block(rays_o[i:i + block], rays_d[i:i + block],
                                    parameters[i:i + block], S, step, u_off[i:i + block],
                                    self._draw_u_sel((block, S), k_sample)))
        return {
            k: (sum(o[k] for o in outs) if k.startswith("overflow")
                else torch.cat([o[k] for o in outs])[:r])
            for k in outs[0]
        }

    def get_model_input_compact(self, rays_o, rays_d, parameters, n_samples, step_size,
                                budget_per_ray, key=None):
        """Compacted model input: each ray block's valid samples, sample-major
        (m = i * Rb + r), packed into B = budget_per_ray * Rb slots, so that
        a block over its budget drops its deepest samples first (counted
        in overflow_steps).  Returns [R * budget_per_ray] sample arrays
        (pts, rays_d, parameters, t, dists_c, alpha_weight, instance_id,
        taken, ray_idx, i_idx) and the per-ray dists [R,S], color_last,
        alpha_last, hit, overflow_hits and overflow_steps.  Block b draws
        its offsets and pick uniforms (B of them) from split(fold_in(key,
        b)).

        Not ported: the JAX package's row-packed permutes and its estimate
        of TPU lane padding (_permute_rows_packed, _check_compact_capacity
        and NERFTEX_COMPACT_MAX_GB) model TPU tiles; a request that does
        not fit fails as PyTorch's allocator fails."""
        key = self._call_key(key)
        rays_o, rays_d, parameters, u_off, _, r, block = self._prepare(
            rays_o, rays_d, parameters, key)
        S = min(int(n_samples), self.max_steps_per_ray)
        step = float(step_size)
        outs = []
        for b, i in enumerate(range(0, rays_o.shape[0], block)):
            k_sample = jax_rng.split(jax_rng.fold_in(key, b))[1]
            out = self._block_compact(rays_o[i:i + block], rays_d[i:i + block],
                                      parameters[i:i + block], S, step, int(budget_per_ray),
                                      u_off[i:i + block], k_sample)
            out["ray_idx"] = out["ray_idx"] + i
            outs.append(out)
        flat = {k: (sum(o[k] for o in outs) if k.startswith("overflow")
                    else torch.cat([o[k] for o in outs])) for k in outs[0]}
        flat["dists"] = _dists_grid(flat.pop("n_steps"), flat.pop("total"), flat.pop("tiny"), S,
                                    step)
        for k in ("dists", "color_last", "alpha_last", "hit"):
            flat[k] = flat[k][:r]
        # Samples of the padding rays are not taken.
        flat["taken"] = flat["taken"] & (flat["ray_idx"] < r)
        return flat

    def _block_compact(self, rays_o, rays_d, parameters, S, step, budget, u_off, k_sample):
        Rb = rays_o.shape[0]
        B = budget * Rb
        dev = rays_o.device
        ray = self._per_ray(rays_o, rays_d, parameters, S, step, u_off)
        n_steps = ray["n_steps"]

        # Sample-major compaction without a host sync: the slot of each
        # valid sample is the exclusive prefix count of valid samples
        # before it; those past the budget go to a dump slot.  Unfilled
        # slots keep m = 0, as jnp.nonzero's fill_value leaves them.
        mask = (torch.arange(S, device=dev)[:, None] < n_steps[None, :]).reshape(-1)
        slot = torch.cumsum(mask, 0) - 1
        n_valid = slot[-1] + 1
        dest = torch.where(mask & (slot < B), slot, B)
        m_idx = torch.zeros(B + 1, dtype=torch.int64, device=dev)
        m_idx.scatter_(0, dest, torch.arange(S * Rb, device=dev))
        m_idx = m_idx[:B]
        taken = torch.arange(B, device=dev) < n_valid
        ray_idx, i_idx = m_idx % Rb, m_idx // Rb
        overflow_steps = ray["overflow_steps"] + torch.clamp(n_valid - B, min=0)

        sample = self._per_sample(ray, rays_o, rays_d, parameters, ray_idx, i_idx, step,
                                  self._draw_u_sel((B,), k_sample))

        # Per-sample spacing from the gathered per-ray scalars (the
        # expressions of _dists_grid).
        ns_c, tot_c, tiny_c = n_steps[ray_idx], ray["total"][ray_idx], ray["tiny"][ray_idx]
        dists_c = torch.where(i_idx == ns_c - 1, step + tot_c - ns_c * step,
                              torch.full_like(tot_c, step))
        dists_c = torch.where(tiny_c, torch.where(i_idx == 0, tot_c, 0.0), dists_c)
        dists_c = torch.where(i_idx < ns_c, dists_c, 0.0)
        return {
            "pts": sample["pts"],
            "rays_d": sample["dirs"],
            "parameters": sample["parameters"],
            "t": sample["t"],
            "dists_c": torch.where(taken, dists_c, 0.0),
            "alpha_weight": sample["weight"],
            "instance_id": sample["instance_id"],
            "taken": taken,
            "ray_idx": ray_idx,
            "i_idx": i_idx,
            "n_steps": n_steps,
            "total": ray["total"],
            "tiny": ray["tiny"],
            "color_last": ray["color_last"],
            "alpha_last": ray["alpha_last"],
            "hit": ray["hit"],
            "overflow_hits": ray["overflow_hits"],
            "overflow_steps": overflow_steps,
        }

    def _block(self, rays_o, rays_d, parameters, S, step, u_off, u_sel):
        ray = self._per_ray(rays_o, rays_d, parameters, S, step, u_off)
        sample = self._per_sample_grid(ray, rays_o, rays_d, parameters, S, step, u_sel)
        return {
            **self._assemble_grid(ray, sample, rays_d, parameters, S, step),
            "overflow_hits": ray["overflow_hits"],
            "overflow_steps": ray["overflow_steps"],
        }

    def render_grid_sorted(self, rays_o, rays_d, parameters, n_samples, step_size, shade_block,
                           key, extra=(), empty_block=None):
        """Occupancy-sorted render.  shade_block(inst_block, extra_block,
        key) and empty_block(ray_tables_block, extra_block) return tuples of
        [Rb, ...] tensors; empty_block serves the sorted blocks in which
        every ray has zero marching steps.  The offsets and pick uniforms
        are the JAX package's draws under ``key`` (a jax_rng key): with
        bkey = fold_in(fold_in(key, 0x7FFFFFFF), b), sorted block b draws
        uniform(split(bkey)[0], (Rb, S_bucket)) and uses its first S_b
        columns, and shade_block gets split(bkey)[1], with the width
        S_bucket of JAX's [Rb, S_bucket] grid as inst_block["draw_width"]
        (a draw over that grid keeps its first S_b columns).  Returns
        (tuple of [R, ...], aux = {hit [R], overflow_hits,
        overflow_steps})."""
        rays_o, rays_d, parameters, u_off, extra, r, block = self._prepare(
            rays_o, rays_d, parameters, key, extra)
        step = float(step_size)
        cap = min(int(n_samples), self.max_steps_per_ray)
        n_rows = rays_o.shape[0]
        n_blocks = n_rows // block

        # 1. per-ray tables, blocked in ray order (the culls bound each
        # original block's ray fan).
        per_block = [self._per_ray(rays_o[i:i + block], rays_d[i:i + block],
                                   parameters[i:i + block], cap, step, u_off[i:i + block])
                     for i in range(0, n_rows, block)]
        with trace.span("instancer.sort"):
            overflow_hits = sum(t["overflow_hits"] for t in per_block)
            overflow_steps = sum(t["overflow_steps"] for t in per_block)
            tables = {k: None if v is None else torch.cat([t[k] for t in per_block])
                      for k, v in per_block[0].items() if not k.startswith("overflow")}
            hit = tables["hit"]

            # 2. occupancy sort, descending and stable.
            order = torch.argsort(tables["n_steps"], descending=True, stable=True)
            tables_s = {k: None if v is None else v[order] for k, v in tables.items()}
            rays_o_s, rays_d_s, prm_s = rays_o[order], rays_d[order], parameters[order]
            extra_s = tuple(e[order] for e in extra)

            # 3. each sorted block at its own maximum step count (its first
            # ray's) and, for K >= 64, at the JAX package's hit tier: valid
            # hits are a prefix of the K slots, so the [.., K] tables cut to
            # the smallest tier that holds the block's hits; the pick counts
            # the trailing slots of that width, as JAX does.
            K = tables["tk0"].shape[-1]
            k_tiers = sorted({min(K, 8), max(1, K // 4), K}) if K >= 64 else [K]
            block_hits = tables_s["kvalid"].sum(-1).reshape(n_blocks, block).max(-1).values
            with trace.host_read("block_table"):
                block_max, block_hits = torch.stack(
                    [tables_s["n_steps"][::block].long(), block_hits]).tolist()
        # JAX's step-capacity buckets: a block's pick uniforms are drawn at
        # its bucket's width.
        buckets = sorted({min(cap, 8), *(max(1, cap * q // 8) for q in range(1, 9)), cap})
        # Sorted block b draws its pick uniforms from sample_keys' row b and
        # shades under shade_keys' row b.
        k_sorted = jax_rng.fold_in(key, _SORTED_FOLD)
        sample_keys = None
        if self.ds.instance_sampling_method != "nearest":
            sample_keys = jax_rng.block_keys(k_sorted, n_blocks)
        shade_keys = jax_rng.block_keys(k_sorted, n_blocks, index=1)
        outs = []
        for b, (s_max, n_hits) in enumerate(zip(block_max, block_hits)):
            with trace.span("instancer.block"):
                trace.count("blocks")
                sl = slice(b * block, (b + 1) * block)
                ray = {k: (None if v is None else v[sl]) for k, v in tables_s.items()}
                ext = tuple(e[sl] for e in extra_s)
                if s_max == 0 and empty_block is not None:
                    trace.count("blocks.empty")
                    outs.append(empty_block(ray, ext))
                    continue
                K_b = k_tiers[bisect.bisect_left(k_tiers, n_hits)]
                if K_b < K:
                    ray = _slice_hits(ray, K_b)
                S_b = max(int(s_max), 1)
                trace.count("grid.samples", block * S_b)
                width = buckets[bisect.bisect_left(buckets, s_max)]
                k_sample = None if sample_keys is None else sample_keys[b]
                u_sel = self._draw_u_sel((block, S_b), k_sample, full_width=width)
                sample = self._per_sample_grid(ray, rays_o_s[sl], rays_d_s[sl], prm_s[sl], S_b,
                                               step, u_sel)
                inst = self._assemble_grid(ray, sample, rays_d_s[sl], prm_s[sl], S_b, step)
                inst["draw_width"] = width
                outs.append(shade_block(inst, ext, shade_keys[b]))

        # 4. back to ray order, padding dropped.
        inv_order = torch.empty_like(order)
        inv_order[order] = torch.arange(n_rows, device=order.device)
        result = tuple(torch.cat(parts)[inv_order][:r] for parts in zip(*outs))
        aux = {"hit": hit[:r], "overflow_hits": overflow_hits, "overflow_steps": overflow_steps}
        return result, aux

    # -- per-ray stage ----------------------------------------------------

    @trace.span("instancer.per_ray")
    def _per_ray(self, rays_o, rays_d, parameters, S, step, u_off):
        ds = self.ds
        P = parameters.shape[-1]
        # The culls, mesh hit, slab intervals, top-K and event walk
        # (kernels.per_ray: its kernels on the card, the eager chain on the
        # CPU).  The kernels choose each cull's branch on the card; their
        # fit and full counts are read with the tracer's other counts.
        ray = per_ray(ds, rays_o, rays_d, u_off, min(self.max_hits, ds.n_instances), S, step,
                      self.cull_budget, self.tri_cull_budget, self.matmul_precision)
        if ray["cull"] is not None and trace.is_recording():
            trace.count("cull.fit", ray["cull"][2])
            trace.count("cull.full", ray["cull"][3])

        light_dir_w = shadow_blocked = None
        if ds.light_dir_idx >= 0 and P > ds.light_dir_idx + 2:
            light_dir_w = parameters[:, ds.light_dir_idx:ds.light_dir_idx + 3]
            if ds.cast_shadow_rays:
                with trace.span("per_ray.shadow"):
                    shadow_blocked = self._shadow_blocked_sparse(
                        rays_o, rays_d, light_dir_w, ray["cum_incl"], ray["cum_excl"],
                        ray["times_s"], ray["total"])

        # terminator: an opaque mesh, black unless an aux mesh is shaded
        color_last = ray["color_last"]
        if ds.n_tris > 0 and ds.n_meshes > 1:
            with trace.span("per_ray.terminator"):
                color_last = self._shade_terminator(
                    rays_o, rays_d, ray["t_mesh"], ray["tri"], ray["tri_u"], ray["tri_v"],
                    torch.isfinite(ray["t_mesh"]), light_dir_w)[:, None, :]
        return {
            **{k: ray[k] for k in ("tk0", "tk1", "inst_idx", "kvalid", "sel_a", "sel_b",
                                   "cum_incl", "arc_corr", "total", "n_steps", "t_offset",
                                   "tiny")},
            "color_last": color_last, "alpha_last": ray["alpha_last"], "hit": ray["hit"],
            "light_dir_w": light_dir_w, "shadow_blocked": shadow_blocked,
            "overflow_hits": ray["overflow_hits"], "overflow_steps": ray["overflow_steps"],
        }

    # -- shadows -----------------------------------------------------------

    def _shadow_blocked_sparse(self, rays_o, rays_d, light_dir, cum_incl, cum_excl, times_s,
                               total):
        """Occlusion toward the light at ``shadow_samples`` points spread
        uniformly over each ray's inside arc: blocked [Rb, Ssh].  Rays with
        no arc are invalid rows whose (unused) results are not-blocked."""
        n_sh = self.shadow_samples
        frac = (torch.arange(n_sh, device=total.device) + 0.5) / n_sh
        s_sh = frac[None, :] * total[:, None]                                # [Rb,Ssh]
        j = torch.clamp(torch.searchsorted(cum_incl, s_sh, right=True), max=cum_incl.shape[-1] - 1)
        t_sh = times_s.gather(1, j) + (s_sh - cum_excl.gather(1, j))
        pts = rays_o[:, None, :] + rays_d[:, None, :] * t_sh[..., None]
        valid = (total > 0) & torch.isfinite(times_s[:, 0])
        return self._occlusion_branched(pts, light_dir[:, None, :], valid[:, None])

    @trace.span("instancer.shadow")
    def _occlusion_branched(self, pts, light_dir, pt_valid):
        """The shadow query (kernels/shadow_query.py) through the exact 3-way
        block branch, chosen on the host: no valid point -> nothing is
        blocked; the swept-cone keep sets of the valid points' bounding
        sphere fit the shadow budgets -> the query over those candidates
        only; otherwise -> the full query.  pts [..., 3]; light_dir
        broadcastable to pts; pt_valid broadcastable to pts[..., 0]."""
        ds = self.ds
        C = self.shadow_cull_budget
        C = C if (C and C < ds.n_instances) else 0
        TC = self.shadow_tri_cull_budget
        TC = TC if (TC and 0 < TC < ds.n_tris) else 0
        shape = pts.shape[:-1]
        flat_p = pts.reshape(-1, 3)
        flat_l = light_dir.expand(pts.shape).reshape(-1, 3)
        fvalid = pt_valid.expand(shape).reshape(-1)

        fits = torch.zeros((), dtype=torch.bool, device=pts.device)
        keep_i = keep_t = None
        if C or TC:
            c, r = _point_bound(flat_p, fvalid)
            u_l, tan_a, wide = _light_cone(flat_l, fvalid)
            fits = ~wide
            if C:
                keep_i = _swept_keep(c, r, u_l, tan_a, ds.inst_center, ds.inst_radius)
                fits = fits & (keep_i.sum() <= C)
            if TC:
                keep_t = _swept_keep(c, r, u_l, tan_a, ds.tri_center, ds.tri_radius)
                fits = fits & (keep_t.sum() <= TC)
        with trace.host_read("shadow_branch"):
            any_valid, fits = torch.stack([fvalid.any(), fits]).tolist()
        trace.count("shadow.full" if any_valid and not fits else
                    "shadow.culled" if any_valid else "shadow.skip")
        if not any_valid:
            return torch.zeros(shape, dtype=torch.bool, device=pts.device)
        inst_sel = tri_sel = None
        if fits:
            inst_sel = None if keep_i is None else keep_to_candidates(keep_i, C)
            tri_sel = None if keep_t is None else keep_to_candidates(keep_t, TC)
        tris = (ds.tri_v0, ds.tri_e1, ds.tri_e2, ds.tri_ng) if ds.n_tris > 0 else None
        return shadow_query(flat_p.contiguous(), flat_l.contiguous(), (ds.inv_rot, ds.inv_trans),
                            tris, (ds.b_0, ds.b_1), inst_sel, tri_sel).reshape(shape)

    # -- terminator shading ------------------------------------------------

    def _shade_terminator(self, rays_o, rays_d, t_mesh, tri, u, v, mesh_hit, light_dir):
        """Color [Rb, 3] of each ray's terminator: Lambert plus 0.2 ambient
        over the albedo (bilinear in the mesh texture, 0.8 gray without
        one) for auxiliary meshes, shadowed when cast_shadow_rays; the base
        mesh renders black, misses 0."""
        ds = self.ds
        bary = torch.stack([1 - u - v, u, v], -1)                           # [Rb,3]
        n = torch.sum(bary[..., None] * ds.tri_n[tri], 1)
        n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-12)
        uv = torch.sum(bary[..., None] * ds.tri_uv[tri], 1)
        mid = ds.tri_mesh_id[tri]

        if ds.mesh_tex is not None:
            w, h = ds.mesh_tex.shape[1], ds.mesh_tex.shape[2]
            x = torch.clamp(uv[:, 0], 0, 1) * (w - 1)
            y = torch.clamp(uv[:, 1], 0, 1) * (h - 1)
            x0 = torch.clamp(torch.floor(x).long(), 0, max(w - 2, 0))
            y0 = torch.clamp(torch.floor(y).long(), 0, max(h - 2, 0))
            fx = (x - x0)[:, None]
            fy = (y - y0)[:, None]
            x1 = torch.clamp(x0 + 1, max=w - 1)
            y1 = torch.clamp(y0 + 1, max=h - 1)
            tex = ds.mesh_tex
            albedo = (tex[mid, x0, y0] * (1 - fx) * (1 - fy) + tex[mid, x0, y1] * (1 - fx) * fy
                      + tex[mid, x1, y0] * fx * (1 - fy) + tex[mid, x1, y1] * fx * fy)
            albedo = torch.where(albedo < 0, 0.8, albedo)        # -1 padding: untextured gray
        else:
            albedo = torch.full((rays_o.shape[0], 3), 0.8, device=rays_o.device)

        hit_pt = rays_o + torch.where(mesh_hit, t_mesh, 0.0)[:, None] * rays_d
        diffuse = torch.zeros(rays_o.shape[0], device=rays_o.device)
        is_aux = mid > 0
        if light_dir is not None:
            ld = light_dir / torch.clamp(torch.linalg.norm(light_dir, dim=-1, keepdim=True),
                                         min=1e-12)
            diffuse = torch.clamp(torch.sum(n * ld, -1), min=0.0)
            if ds.cast_shadow_rays:
                # Only aux-mesh terminator pixels read the occlusion, so the
                # branched query skips blocks without them.
                blocked = self._occlusion_branched(hit_pt + n * 1e-6, light_dir,
                                                   mesh_hit & is_aux)
                diffuse = torch.where(blocked, 0.0, diffuse)

        shade = torch.clamp(diffuse + 0.2, max=1.0)[:, None] * albedo
        color = torch.where(is_aux[:, None], shade, 0.0)
        return torch.where(mesh_hit[:, None], color, 0.0)

    # -- per-sample stage, dense [Rb, S] grid ------------------------------

    @trace.span("instancer.per_sample")
    def _per_sample_grid(self, ray, rays_o, rays_d, parameters, S, step, u_sel=None):
        ds = self.ds
        K = ray["tk0"].shape[-1]
        i_grid = torch.arange(S, dtype=torch.float32, device=rays_o.device)[None, :]
        s_arc = i_grid * step + ray["t_offset"][:, None]                  # [Rb,S]

        # Arc length -> world t: corr[clip(#(cum_incl <= s), 0, 2K-1)].
        j = torch.searchsorted(ray["cum_incl"], s_arc, right=True)
        j = torch.clamp(j, max=2 * K - 1)
        t_mu = s_arc + ray["arc_corr"].gather(1, j)
        t_pt = mean_distance(t_mu, step) if ds.use_mean_distance else t_mu
        pts_w = rays_o[:, None, :] + rays_d[:, None, :] * t_pt[..., None]  # [Rb,S,3]

        sel_k, weight = self._pick(
            [ray[k] for k in ("tk0", "tk1", "kvalid", "sel_a", "sel_b")], t_pt, u_sel,
            ray["n_steps"])
        inst = ray["inst_idx"].gather(1, sel_k.long())                    # [Rb,S]
        return self._per_sample_grid_tail(ray, rays_d, parameters, inst, weight, s_arc, t_mu,
                                          pts_w)

    def _pick(self, tables, t_pt, u_sel, n_steps=None):
        """The overlap pick over the K hit slots of ``tables`` (tk0, tk1,
        kvalid, sel_a, sel_b [Rb, K]) at t_pt [Rb, S] (the kernel; its plain
        [Rb, S, K] chain for CPU tensors) and the pick's density weight:
        the active count (random), 1 (nearest) or 1 / p_sel (nearest_blend),
        and 1 where one slot is active.  Returns (sel_k, weight) [Rb, S].
        Given the rays' n_steps [Rb], a recording tracer counts
        ``pick.blend``: the valid samples (the MLP's mask, each ray's first
        n_steps slots) whose blended pick weighed two or more active
        slots, summed on the device and read with the other counts."""
        method = self.ds.instance_sampling_method
        sel_k, p_sel, n_active = selk_resolve(*tables, t_pt, u_sel, method=method,
                                              blend_range=self.ds.nearest_blend_range)
        if n_steps is not None and method == "nearest_blend" and trace.is_recording():
            valid = torch.arange(t_pt.shape[1], device=t_pt.device)[None, :] < n_steps[:, None]
            trace.count("pick.blend", (valid & (n_active > 1)).sum())
        if method == "random":
            weight = n_active.to(torch.float32)
        elif method == "nearest":
            weight = torch.ones_like(t_pt)
        else:
            weight = 1.0 / torch.clamp(p_sel, min=1e-20)
        return sel_k, torch.where(n_active == 1, 1.0, weight)

    def _per_sample(self, ray, rays_o, rays_d, parameters, ray_idx, i_idx, step, u_sel):
        """The per-sample stage over M compacted samples (ray_idx, i_idx
        [M] into the block's rays and steps): the arc-to-t step, the
        overlap pick through kernels.selk_resolve over the gathered [M, K]
        hit tables with t and u as [M, 1] planes, then the grid tail on
        [M, 1] planes.  Returns the tail's outputs as [M, ...]."""
        ds = self.ds
        K = ray["tk0"].shape[-1]
        s_arc = i_idx.to(torch.float32) * step + ray["t_offset"][ray_idx]      # [M]
        j = torch.searchsorted(ray["cum_incl"][ray_idx], s_arc[:, None], right=True)[:, 0]
        t_mu = s_arc + ray["arc_corr"][ray_idx, torch.clamp(j, max=2 * K - 1)]
        t_pt = mean_distance(t_mu, step) if ds.use_mean_distance else t_mu
        pts_w = rays_o[ray_idx] + rays_d[ray_idx] * t_pt[:, None]              # [M,3]

        tables = [None if ray[k] is None else ray[k][ray_idx]
                  for k in ("tk0", "tk1", "kvalid", "sel_a", "sel_b")]
        sel_k, weight = self._pick(tables, t_pt[:, None],
                                   None if u_sel is None else u_sel[:, None])
        sel_k, weight = sel_k[:, 0].long(), weight[:, 0]
        inst = ray["inst_idx"][ray_idx, sel_k]                                 # [M]

        per_ray = {k: None if ray[k] is None else ray[k][ray_idx]
                   for k in ("light_dir_w", "shadow_blocked", "total")}
        out = self._per_sample_grid_tail(
            per_ray, rays_d[ray_idx], parameters[ray_idx], inst[:, None], weight[:, None],
            s_arc[:, None], t_mu[:, None], pts_w[:, None, :])
        return {k: v[:, 0] for k, v in out.items()}

    def _per_sample_grid_tail(self, ray, rays_d, parameters, inst, weight, s_arc, t_mu, pts_w):
        """Downstream of the overlap pick of instance ``inst`` [Rb, S]: its
        local frame, texture-driven parameters and the light direction.
        ``ray`` needs light_dir_w, shadow_blocked and total [Rb, ...]."""
        ds = self.ds
        Rb, S = inst.shape
        P = parameters.shape[-1]

        vals = self.inst_table[inst]                                      # [Rb,S,D]
        rot = vals[..., 0:9].reshape(Rb, S, 3, 3)
        pts_l = torch.sum(rot * pts_w[..., None, :], -1) + vals[..., 9:12]
        d0 = 12
        if ds.uniform_scale is not None:
            dinv = rot * ds.uniform_scale
        else:
            dinv = vals[..., d0:d0 + 9].reshape(Rb, S, 3, 3)
            d0 += 9
        dirs_l = torch.sum(dinv * rays_d[:, None, None, :], -1)

        params_out = parameters[:, None, :].expand(Rb, S, P).clone()
        uv = None
        if self.use_jac:
            a_uv = vals[..., d0:d0 + 2]
            jac = vals[..., d0 + 2:d0 + 8].reshape(Rb, S, 2, 3)
            rel = pts_w - vals[..., d0 + 8:d0 + 11]
            uv = torch.clamp(a_uv + torch.sum(jac * rel[..., None, :], -1), 0.0, 1.0)
        elif ds.texture_parameter_idxs and ds.tri_candidates is not None:
            uv = self._closest_uv(inst, pts_w)
        if uv is not None:
            uv = uv.contiguous()
            for i, slot in enumerate(ds.texture_parameter_idxs):
                texel = sample_channel(ds.tex_channels[i], uv, ds.tex_quads[i])
                params_out[..., slot] = params_out[..., slot] * texel

        if ray["light_dir_w"] is not None:
            li = ds.light_dir_idx
            light = ray["light_dir_w"][:, None, :]                          # [Rb,1,3]
            # A point light's slots hold its position: each sample looks
            # toward it.
            vec = light - pts_w if ds.light_strength_idx >= 0 else light
            vec_n = vec / torch.clamp(torch.linalg.norm(vec, dim=-1, keepdim=True), min=1e-12)
            local_l = torch.sum(dinv * vec_n[..., None, :], -1)
            blocked = ray.get("shadow_blocked")
            if blocked is not None:
                # A sample takes the shadow sample of its arc-length bucket;
                # shadowed samples see the light straight from below.
                n_sh = blocked.shape[-1]
                bucket = torch.floor(
                    s_arc / torch.clamp(ray["total"][:, None], min=1e-12) * n_sh).long()
                shadowed = blocked.gather(1, torch.clamp(bucket, 0, n_sh - 1))
                local_l = torch.where(shadowed[..., None], self._light_down, local_l)
            params_out[..., li:li + 3] = local_l
            if ds.light_strength_idx >= 0:
                # Inverse-square falloff of the point light's strength.
                si = ds.light_strength_idx
                d2l = torch.sum((light - pts_w) ** 2, -1)
                params_out[..., si] = parameters[:, si, None] / (4 * math.pi * d2l + 1e-6)

        return {
            "pts": pts_l,
            "dirs": dirs_l,
            "parameters": params_out,
            "t": t_mu,
            "weight": weight,
            "instance_id": inst.to(torch.int32),
        }

    def _closest_uv(self, inst, pts_w):
        """The uv [..., 2] of the closest point to each sample pts_w [..., 3]
        over its instance's k_tri candidate triangles (the first of equal
        distances)."""
        ds = self.ds
        cand = ds.tri_candidates[inst]                                    # [..., Kt]
        a = ds.tri_v0[cand]
        b = a + ds.tri_e1[cand]
        c = a + ds.tri_e2[cand]
        p = pts_w[..., None, :]
        bary = _closest_point_tri(p, a, b, c)                             # [..., Kt, 3]
        cp = fma(bary[..., 2:3], c, fma(bary[..., 1:2], b, bary[..., 0:1] * a))
        best = torch.argmin(dot3(cp - p, cp - p), -1, keepdim=True)
        tri = cand.gather(-1, best)[..., 0]
        bary_sel = bary.gather(-2, best[..., None].expand(*best.shape, 3))[..., 0, :]
        return torch.sum(bary_sel[..., None] * ds.tri_uv[tri], -2)

    @trace.span("instancer.assemble")
    def _assemble_grid(self, ray, sample, rays_d, parameters, S, step):
        """Mask the per-sample outputs into the dense [Rb, S] model input
        (invalid slots get benign values).  Every ray of the block must
        have n_steps <= S."""
        Rb = rays_d.shape[0]
        P = parameters.shape[-1]
        valid = torch.arange(S, device=rays_d.device)[None, :] < ray["n_steps"][:, None]
        emit = valid[..., None]
        return {
            "rays_d": torch.where(emit, sample["dirs"], rays_d[:, None, :].expand(Rb, S, 3)),
            "pts": torch.where(emit, sample["pts"], 0.0),
            "t": torch.where(valid, sample["t"], 0.0),
            "dists": _dists_grid(ray["n_steps"], ray["total"], ray["tiny"], S, step),
            "color_last": ray["color_last"],
            "alpha_last": ray["alpha_last"],
            "alpha_weight": torch.where(valid, sample["weight"], 1.0),
            "instance_id": torch.where(valid, sample["instance_id"], 0).to(torch.int32),
            "hit": ray["hit"],
            "parameters": torch.where(emit, sample["parameters"],
                                      parameters[:, None, :].expand(Rb, S, P)),
        }
