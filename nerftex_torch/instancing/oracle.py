"""Host reference implementation of the instancer's per-ray sampling.

The port's own copy of nerftex_tpu/instancing/oracle.py: a numpy
re-derivation of C_Instancer::GetModelInput (instancer.cpp:751-1037), the
independent test oracle of the device instancer.  It runs on the host
only (numpy; no torch op, no kernel), so it stays apart from the code it
checks.  Differences from the reference are deliberate and documented:

  - ray/box events come from slab tests against each instance's local unit
    box instead of an Embree BVH (identical event sets for t in (0, 100));
  - texture parameters and shadows are evaluated exactly at every sample
    instead of sparsely-with-interpolation (the reference interpolates only
    when n_*_samples < n_pts; exact evaluation is at least as accurate);
  - RNG streams differ (np.RandomState here vs std::mt19937) — all random
    choices (sample offset, overlap selection) are seeded and reproducible
    within this framework.

The slab tests of ``ray_box_events`` and the box faces of ``is_shadowed``
run over all instances at once, each instance's arithmetic the JAX
oracle's (the same float32 ``@`` on the same [3, 3] views, elementwise
after); the per-sample walk of ``get_model_input`` stays a loop.
"""

import numpy as np

from nerftex_torch.instancing.scene import Scene, sample_texture
from nerftex_torch.ops.volume import mean_distance

T_FAR = 100.0


def _to_local(scene: Scene, p):
    """Every instance's local frame of point or direction p [3]:
    (rotated [N, 3], translation [N, 3])."""
    inv = np.asarray(scene.inverse, np.float32).reshape(-1, 4, 4)
    return inv[:, :3, :3] @ p, inv[:, :3, 3]


def ray_box_events(scene: Scene, ray_o, ray_d):
    """Per-instance [t_in, t_out] clipped to (0, T_FAR); entry/exit events."""
    events = []  # (t, kind, instID); kind 0 = entry, 1 = exit
    intervals = {}
    if scene.n_instances() == 0:
        return events, intervals
    rot_o, trans = _to_local(scene, ray_o)
    o = rot_o + trans
    d = _to_local(scene, ray_d)[0]
    with np.errstate(divide="ignore", invalid="ignore"):
        t_a = (scene.b_0 - o) / d
        t_b = (scene.b_1 - o) / d
    t0s = np.minimum(t_a, t_b).max(-1)
    t1s = np.maximum(t_a, t_b).min(-1)
    for inst in np.nonzero(t0s < t1s)[0].tolist():
        t0, t1 = float(t0s[inst]), float(t1s[inst])
        # Embree reports face-crossing events with t in (tnear=0, tfar):
        if 0 < t0 < T_FAR:
            events.append((t0, 0, inst))
        if 0 < t1 < T_FAR:
            events.append((t1, 1, inst))
        if t1 > 0:
            intervals[inst] = (max(t0, 0.0), min(t1, T_FAR))
    return events, intervals


def mesh_first_hit(mesh, ray_o, ray_d, t_max=T_FAR):
    """Möller–Trumbore first hit: (t, tri, bary) or None."""
    V, F = mesh.V, mesh.F
    if len(F) == 0:
        return None
    v0 = V[F[:, 0]]
    e1 = V[F[:, 1]] - v0
    e2 = V[F[:, 2]] - v0
    pvec = np.cross(ray_d, e2)
    det = np.sum(e1 * pvec, -1)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv_det = 1.0 / det
        tvec = ray_o - v0
        u = np.sum(tvec * pvec, -1) * inv_det
        qvec = np.cross(tvec, e1)
        v = np.sum(ray_d * qvec, -1) * inv_det
        t = np.sum(e2 * qvec, -1) * inv_det
    ok = (np.abs(det) > 1e-12) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-6) & (t < t_max)
    if not ok.any():
        return None
    t = np.where(ok, t, np.inf)
    tri = int(np.argmin(t))
    return float(t[tri]), tri, np.array([1 - u[tri] - v[tri], u[tri], v[tri]])


def is_shadowed(scene: Scene, pt, direction):
    """Occlusion query with the silhouette filter (instancer.cpp:544-554,
    593-602): blocked by a patch box's top face entered from above, its
    bottom face from either side, or any mesh front face."""
    d = np.asarray(direction, np.float32)
    if scene.n_instances():
        rot_p, trans = _to_local(scene, pt)
        o_l = rot_p + trans
        d_l = _to_local(scene, d)[0]
        # Top face: local z = b_1.z, outward normal +z.
        steep = np.abs(d_l[:, 2]) > 1e-12
        with np.errstate(divide="ignore", invalid="ignore"):
            for z_plane, is_top in ((scene.b_1[2], True), (scene.b_0[2], False)):
                t = (z_plane - o_l[:, 2]) / d_l[:, 2]
                p = o_l + t[:, None] * d_l
                face = (steep & (0 < t) & (t < T_FAR)
                        & (scene.b_0[0] <= p[:, 0]) & (p[:, 0] <= scene.b_1[0])
                        & (scene.b_0[1] <= p[:, 1]) & (p[:, 1] <= scene.b_1[1]))
                if is_top:
                    face &= d_l[:, 2] < 0
                if face.any():
                    return True
    meshes = ([scene.base_mesh] if scene.base_mesh is not None else []) + list(scene.aux_meshes)
    for mesh in meshes:
        hit = mesh_first_hit(mesh, np.asarray(pt, np.float32), d)
        if hit is not None:
            t, tri, bary = hit
            v = mesh.V[mesh.F[tri]]
            ng = np.cross(v[1] - v[0], v[2] - v[0])
            if np.dot(d, ng) < 0:
                return True
    return False


def shade_mesh(scene: Scene, mesh, pt, tri, bary, light_dir, diffuse=1.0, ambient=0.2):
    """Lambert + ambient with textured albedo (instancer.cpp:716-743)."""
    f = mesh.F[tri]
    n = bary @ mesh.N[f]
    n = n / max(np.linalg.norm(n), 1e-12)

    if not mesh.textures:
        albedo = np.array([0.8, 0.8, 0.8], np.float32)
    else:
        uv = bary @ mesh.UV[f]
        vals = np.array([sample_texture(ch, uv[None])[0] for ch in mesh.textures], np.float32)
        albedo = vals if len(vals) == 3 else np.full(3, vals[0], np.float32)

    if light_dir is not None and not (
        scene.cast_shadow_rays and is_shadowed(scene, pt + n * 1e-6, light_dir)
    ):
        ld = np.asarray(light_dir, np.float32)
        diffuse *= max(float(n @ (ld / max(np.linalg.norm(ld), 1e-12))), 0.0)
    else:
        diffuse = 0.0

    return albedo * min(diffuse + ambient, 1.0)


def _select_instance(scene: Scene, active, pt, rng):
    """Overlap resolution (instancer.cpp:670-713)."""
    active = sorted(active)
    if len(active) == 1:
        return active[0], 1.0
    method = scene.instance_sampling_method
    if method == "random":
        return active[int(rng.randint(len(active)))], float(len(active))
    dists = np.array([np.linalg.norm(pt - scene.origins[i]) for i in active])
    if method == "nearest":
        return active[int(np.argmin(dists))], 1.0
    # nearest_blend
    transition = 0.2 * scene.patch_scale
    w = np.maximum(transition + dists.min() - dists, 0.0)
    p = w / w.sum()
    idx = int(rng.choice(len(active), p=p))
    return active[idx], float(1.0 / p[idx])


def get_model_input(scene: Scene, rays_o, rays_d, parameters, n_pts, step_size, rng=None):
    """Numpy mirror of GetModelInput.  rays_o/rays_d [R,3] (d normalized),
    parameters [R,P].  Returns a dict of the reference's ten outputs."""
    if rng is None:
        rng = np.random.RandomState(0)
    R = rays_o.shape[0]
    P = parameters.shape[1] if parameters.ndim == 2 else 0

    out = {
        "rays_d": np.repeat(rays_d[:, None, :], n_pts, 1).astype(np.float32),
        "pts": np.zeros((R, n_pts, 3), np.float32),
        "t": np.zeros((R, n_pts), np.float32),
        "dists": np.zeros((R, n_pts), np.float32),
        "color_last": np.zeros((R, 1, 3), np.float32),
        "alpha_last": np.zeros((R, 1), np.float32),
        "alpha_weight": np.ones((R, n_pts), np.float32),
        "instance_id": np.zeros((R, n_pts), np.int32),
        "hit": np.zeros(R, bool),
        "parameters": np.repeat(parameters[:, None, :], n_pts, 1).astype(np.float32),
    }

    meshes = []
    if scene.base_mesh is not None:
        meshes.append(("base", scene.base_mesh))
    for m in scene.aux_meshes:
        meshes.append(("aux", m))

    for r in range(R):
        o, d = rays_o[r], rays_d[r]
        _, intervals = ray_box_events(scene, o, d)

        # First mesh hit across base + aux.
        mesh_hit = None
        for kind, mesh in meshes:
            h = mesh_first_hit(mesh, o, d)
            if h is not None and (mesh_hit is None or h[0] < mesh_hit[1]):
                mesh_hit = (kind, h[0], mesh, h[1], h[2])

        if not intervals and mesh_hit is None:
            continue
        out["hit"][r] = True

        t_mesh = mesh_hit[1] if mesh_hit is not None else np.inf

        # Union-of-intervals segments, cut at the mesh hit (equivalent to the
        # reference's active-set event walk, instancer.cpp:801-827).
        ivs = sorted(
            (t0, min(t1, t_mesh))
            for t0, t1 in intervals.values()
            if min(t1, t_mesh) > t0
        )
        segments = []
        for t0, t1 in ivs:
            if segments and t0 <= segments[-1][1]:
                segments[-1] = (segments[-1][0], max(segments[-1][1], t1))
            else:
                segments.append((t0, t1))

        total = sum(t1 - t0 for t0, t1 in segments)

        default_params = out["parameters"][r, 0].copy()
        light_dir = None
        light_str = None
        if scene.light_dir_idx >= 0 and P:
            light_dir = default_params[scene.light_dir_idx : scene.light_dir_idx + 3].copy()
        if scene.light_strength_idx >= 0 and P:
            light_str = float(default_params[scene.light_strength_idx])

        if total > 0:
            necessary = int(total / step_size)
            n_steps = min(necessary, n_pts)
            if n_steps == 0:
                out["dists"][r, 0] = total
                t_offset = rng.uniform(0, 1) * total
                n_steps = 1
                arc = [t_offset]
            else:
                out["dists"][r, : n_steps - 1] = step_size
                out["dists"][r, n_steps - 1] = step_size + total - n_steps * step_size
                t_offset = rng.uniform(0, 1) * step_size
                arc = [i * step_size + t_offset for i in range(n_steps)]

            # Map arc-length positions into world t via the segments.
            cleared = 0.0
            seg_idx = 0
            for i, s in enumerate(arc):
                while seg_idx < len(segments) and s >= cleared + (
                    segments[seg_idx][1] - segments[seg_idx][0]
                ):
                    cleared += segments[seg_idx][1] - segments[seg_idx][0]
                    seg_idx += 1
                if seg_idx >= len(segments):
                    break
                t_mu = segments[seg_idx][0] + (s - cleared)
                t_pt = mean_distance(t_mu, step_size) if scene.use_mean_distance else t_mu
                pt = o + t_pt * d
                out["t"][r, i] = t_mu

                active_insts = [
                    inst
                    for inst, (t0, t1) in intervals.items()
                    if t0 <= t_pt < t1 and t0 < t_mesh
                ]
                if not active_insts:
                    # Sample fell on a boundary; keep nearest interval owner.
                    active_insts = [
                        min(intervals, key=lambda j: abs(intervals[j][0] - t_pt))
                    ]
                inst, weight = _select_instance(scene, active_insts, pt, rng)
                out["alpha_weight"][r, i] = weight
                out["instance_id"][r, i] = inst

                params_i = (scene.get_parameters(pt, default_params)
                            if scene.texture_parameter_idxs else default_params.copy())

                if scene.light_dir_idx >= 0:
                    shadowed = scene.cast_shadow_rays and is_shadowed(scene, pt, light_dir)
                    if shadowed:
                        local_l = np.array([0, 0, -1.0], np.float32)
                    else:
                        if scene.light_strength_idx >= 0:
                            vec = light_dir - pt
                        else:
                            vec = light_dir
                        vec_n = vec / max(np.linalg.norm(vec), 1e-12)
                        local_l = scene.dir_inverse[inst] @ vec_n
                    params_i[scene.light_dir_idx : scene.light_dir_idx + 3] = local_l

                if scene.light_strength_idx >= 0:
                    eps = 1e-6
                    d2 = float(np.sum((light_dir - pt) ** 2))
                    params_i[scene.light_strength_idx] = light_str / (4 * np.pi * d2 + eps)

                out["parameters"][r, i] = params_i
                inv = scene.inverse[inst]
                out["pts"][r, i] = inv[:3, :3] @ pt + inv[:3, 3]
                out["rays_d"][r, i] = scene.dir_inverse[inst] @ d

        # Terminator sample (instancer.cpp:1018-1033).
        if mesh_hit is not None:
            kind, t_hit, mesh, tri, bary = mesh_hit
            if kind == "base":
                out["color_last"][r, 0] = 0.0
            else:
                out["color_last"][r, 0] = shade_mesh(
                    scene, mesh, o + t_hit * d, tri, bary, light_dir
                )
            out["alpha_last"][r, 0] = 1.0

    return out
