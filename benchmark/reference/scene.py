"""The instanced scene as the reference derives it from the files.

A configuration names a mesh, its anchor points, the patch box, a scale,
the rotation jitter and the parameter channels (texture, light).  This
module works out, in numpy and without the program, what the program's
scene compiler derives from them: one local frame per anchor (the
anchor's closest point on the mesh, the normal and UV tangent there,
turned about the normal by a seeded angle), each instance's UV at its
anchor with the 2x3 world-to-UV Jacobian of its closest triangle, the
triangle soup with its normals, and the texture channels.  The placement
follows the upstream instancer (DistributeInstancesOnMesh and its
closest-point and tangent-frame rules), as the program's does.
"""

import os

import numpy as np

from benchmark.reference.ply import read_ply

# Anchors per vectorised closest-point query ([chunk, triangles] planes).
_CHUNK = 64


def _normalize(v):
    return v / max(np.linalg.norm(v), 1e-12)


def closest_points(points, a, b, c):
    """For each point [M, 3] its closest point over the triangles a, b, c
    [T, 3]: (triangle [M], barycentrics [M, 3]), the first of equal
    distances (the exact point-triangle test, region by region)."""
    tris = np.empty(len(points), np.int64)
    barys = np.empty((len(points), 3), np.float32)
    for i in range(0, len(points), _CHUNK):
        p = np.asarray(points[i:i + _CHUNK], np.float32)[:, None, :]
        ab, ac, ap = b - a, c - a, p - a
        d1, d2 = np.sum(ab * ap, -1), np.sum(ac * ap, -1)
        bp = p - b
        d3, d4 = np.sum(ab * bp, -1), np.sum(ac * bp, -1)
        cp = p - c
        d5, d6 = np.sum(ab * cp, -1), np.sum(ac * cp, -1)
        vc = d1 * d4 - d3 * d2
        vb = d5 * d2 - d1 * d6
        va = d3 * d6 - d5 * d4
        eps = 1e-20
        denom = 1.0 / np.maximum(va + vb + vc, eps)
        v_in, w_in = vb * denom, vc * denom
        v_ab = d1 / np.where(d1 - d3 == 0, eps, d1 - d3)
        v_ac = d2 / np.where(d2 - d6 == 0, eps, d2 - d6)
        v_bc = (d4 - d3) / np.where((d4 - d3) + (d5 - d6) == 0, eps, (d4 - d3) + (d5 - d6))
        zero = np.zeros_like(v_bc)
        bary = np.stack([1 - v_in - w_in, v_in, w_in], -1)
        bary = np.where(((va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0))[..., None],
                        np.stack([zero, 1 - v_bc, v_bc], -1), bary)
        bary = np.where(((vb <= 0) & (d2 >= 0) & (d6 <= 0))[..., None],
                        np.stack([1 - v_ac, zero, v_ac], -1), bary)
        bary = np.where(((vc <= 0) & (d1 >= 0) & (d3 <= 0))[..., None],
                        np.stack([1 - v_ab, v_ab, zero], -1), bary)
        bary = np.where(((d6 >= 0) & (d5 <= d6))[..., None], np.array([0, 0, 1.0]), bary)
        bary = np.where(((d3 >= 0) & (d4 <= d3))[..., None], np.array([0, 1.0, 0]), bary)
        bary = np.where(((d1 <= 0) & (d2 <= 0))[..., None], np.array([1.0, 0, 0]), bary)
        bary = np.clip(bary, 0, 1)
        bary = bary / np.maximum(bary.sum(-1, keepdims=True), eps)
        pts = bary[..., :1] * a + bary[..., 1:2] * b + bary[..., 2:3] * c
        best = np.argmin(np.linalg.norm(pts - p, axis=-1), -1)
        tris[i:i + _CHUNK] = best
        barys[i:i + _CHUNK] = bary[np.arange(len(best)), best]
    return tris, barys


def texture_channels(path):
    """A PNG's channels as [W, H] float32 arrays, v from the bottom."""
    from PIL import Image

    arr = np.asarray(Image.open(path), np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[..., None]
    return [np.ascontiguousarray(arr[::-1, :, c].T) for c in range(arr.shape[-1])]


def _tangent_frames(V, F, N, UV):
    """Per-vertex (T, B, N) from the UV gradients of the faces."""
    N = N / np.maximum(np.linalg.norm(N, axis=-1, keepdims=True), 1e-12)
    T = np.zeros_like(V)
    e0 = V[F[:, 1]] - V[F[:, 0]]
    e1 = V[F[:, 2]] - V[F[:, 0]]
    uv0 = UV[F[:, 1]] - UV[F[:, 0]]
    uv1 = UV[F[:, 2]] - UV[F[:, 0]]
    denom = uv0[:, 0] * uv1[:, 1] - uv0[:, 1] * uv1[:, 0]
    r = 1.0 / np.where(np.abs(denom) < 1e-20, 1e-20, denom)
    t_face = (e0 * uv1[:, 1:2] - e1 * uv0[:, 1:2]) * r[:, None]
    for k in range(3):
        np.add.at(T, F[:, k], t_face)
    T = T - N * np.sum(N * T, -1, keepdims=True)
    norms = np.linalg.norm(T, axis=-1, keepdims=True)
    fallback = np.cross(N, np.array([0.0, 0.0, 1.0]))
    fb_bad = np.linalg.norm(fallback, axis=-1, keepdims=True) < 1e-6
    fallback = np.where(fb_bad, np.cross(N, np.array([1.0, 0.0, 0.0])), fallback)
    T = np.where(norms < 1e-12, fallback, T)
    T = T / np.maximum(np.linalg.norm(T, axis=-1, keepdims=True), 1e-12)
    return T, np.cross(N, T), N


class SceneTables:
    """Everything the reference renderer needs of one configuration's scene,
    as numpy arrays (see the module docstring)."""

    def __init__(self, instancer: dict, root: str):
        self.b_0 = np.asarray(instancer["b_0"], np.float32)
        self.b_1 = np.asarray(instancer["b_1"], np.float32)
        self.cast_shadow_rays = bool(instancer.get("cast_shadow_rays", False))
        self.method = instancer.get("instance_sampling_method", "random")
        self.use_mean_distance = bool(instancer.get("use_mean_distance", False))

        # Parameter slots: a texture scales its slot; "light" holds a
        # direction (3 slots), "point" a strength then a position (4).
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
        Nv = np.asarray(ply.N, np.float32)
        UV = np.asarray(ply.UV, np.float32)
        scale = float(instancer["patch_scale"])
        self.patch_scale = scale
        a, b, c = V[F[:, 0]], V[F[:, 1]], V[F[:, 2]]
        T, _, Nn = _tangent_frames(V, F, Nv, UV)
        anchors = np.asarray(read_ply(os.path.join(root, instancer["patch_origins_path"])).V,
                             np.float32)
        tris, barys = closest_points(anchors, a, b, c)
        rng = np.random.RandomState(int(instancer.get("seed", 0)))
        jitter = float(instancer.get("jitter_amount", 0.0))
        forward = []
        for p, tri, bary in zip(anchors, tris, barys):
            f = F[tri]
            nrm = _normalize(bary @ Nn[f])
            tan = _normalize(bary @ T[f])
            bit = np.cross(nrm, tan)
            if jitter > 0:
                angle = jitter * rng.uniform(0, np.pi)
                bit = (bit * np.cos(angle) + np.cross(nrm, bit) * np.sin(angle)
                       + nrm * np.dot(nrm, bit) * (1 - np.cos(angle)))
            tan = np.cross(bit, nrm)
            m = np.eye(4, dtype=np.float32)
            m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = tan * scale, bit * scale, nrm * scale, p
            forward.append(m)
        self.forward = np.stack(forward)
        self.inverse = np.stack([np.linalg.inv(m).astype(np.float32) for m in forward])
        dinv = self.forward[:, :3, :3].transpose(0, 2, 1).copy()
        self.dir_inverse = (dinv / np.linalg.norm(dinv, axis=-1, keepdims=True)).astype(
            np.float32)
        self.origins = self.forward[:, :3, 3].copy()

        # The anchor's UV and the UV Jacobian of its closest triangle, whose
        # null space is the triangle's normal.
        n_inst = len(anchors)
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

        # A uniformly scaled frame lets a direction go through the inverse
        # rotation times the scale.
        scales = np.linalg.norm(self.forward[:, :3, 0], axis=-1)
        from_inv = self.inverse[:, :3, :3] * scales[:, None, None]
        self.uniform_scale = None
        if (np.abs(scales - scales[0]) < 1e-5 * max(scales[0], 1e-9)).all() and \
                np.abs(from_inv - self.dir_inverse).max() < 1e-4:
            self.uniform_scale = float(scales[0])

    @property
    def n_instances(self) -> int:
        return len(self.forward)
