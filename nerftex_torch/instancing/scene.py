"""Host-side scene compiler: mesh + anchors -> per-patch transforms and
baked textures, ready to move to the device once per scene.

The port's own copy of nerftex_tpu/instancing/scene.py (texture and light
parameter slots, tangent frames, anchor placement by closest-point queries
with rotation jitter, the per-instance UV Jacobian bake, auxiliary meshes,
transform export, and the host oracle's exact closest-point texture
lookup, ``get_parameters`` over ``sample_texture``).  Numpy only: it runs once per scene, never in the
render loop, and its tables equal the JAX package's on the same inputs.
"""

import json

import numpy as np

from nerftex_torch.instancing import native
from nerftex_torch.instancing.ply import read_ply
from nerftex_torch.tools.gen_assets import vertex_normals


class SceneMesh:
    """Triangle mesh with per-vertex normals/UVs and baked texture channels."""

    def __init__(self, V, F, N=None, UV=None, textures=()):
        self.V = np.asarray(V, np.float32)
        self.F = np.asarray(F, np.int32)
        self.N = np.asarray(N, np.float32) if N is not None else vertex_normals(self.V, self.F)
        self.UV = np.asarray(UV, np.float32) if UV is not None else np.zeros((len(self.V), 2), np.float32)
        self.textures = list(textures)  # list of [W, H] channel arrays (u, v-from-bottom)


def load_texture_channels(path: str):
    """PNG -> per-channel [W, H] arrays with v=0 at the bottom, matching the
    reference's stb load + rowwise reverse (instancer.cpp:34-50)."""
    from PIL import Image

    img = Image.open(path)
    arr = np.asarray(img, np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[..., None]
    # arr[y_from_top, x, c] -> channel[x, y_from_bottom]
    return [np.ascontiguousarray(arr[::-1, :, c].T) for c in range(arr.shape[-1])]


def sample_texture(channel, uv):
    """Bilinear fetch of one [W, H] channel at uv [N, 2]
    (instancer.cpp:605-637)."""
    w, h = channel.shape
    x = np.clip(uv[..., 0], 0, 1) * (w - 1)
    y = np.clip(uv[..., 1], 0, 1) * (h - 1)
    x0 = np.clip(np.floor(x).astype(np.int32), 0, w - 2) if w > 1 else np.zeros_like(x, np.int32)
    y0 = np.clip(np.floor(y).astype(np.int32), 0, h - 2) if h > 1 else np.zeros_like(y, np.int32)
    fx = x - x0
    fy = y - y0
    x1 = np.minimum(x0 + 1, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    return (
        channel[x0, y0] * (1 - fx) * (1 - fy)
        + channel[x0, y1] * (1 - fx) * fy
        + channel[x1, y0] * fx * (1 - fy)
        + channel[x1, y1] * fx * fy
    )


def closest_point_triangles(p, a, b, c):
    """Vectorized exact point-triangle closest point (instancer.cpp:154-198).
    p [3], a/b/c [M,3] -> (points [M,3], bary [M,3])."""
    ab = b - a
    ac = c - a
    ap = p - a

    d1 = np.sum(ab * ap, -1)
    d2 = np.sum(ac * ap, -1)
    bp = p - b
    d3 = np.sum(ab * bp, -1)
    d4 = np.sum(ac * bp, -1)
    cp = p - c
    d5 = np.sum(ab * cp, -1)
    d6 = np.sum(ac * cp, -1)

    vc = d1 * d4 - d3 * d2
    vb = d5 * d2 - d1 * d6
    va = d3 * d6 - d5 * d4

    eps = 1e-20
    denom = 1.0 / np.maximum(va + vb + vc, eps)
    v_in = vb * denom
    w_in = vc * denom

    v_ab = d1 / np.where(d1 - d3 == 0, eps, d1 - d3)
    v_ac = d2 / np.where(d2 - d6 == 0, eps, d2 - d6)
    v_bc = (d4 - d3) / np.where((d4 - d3) + (d5 - d6) == 0, eps, (d4 - d3) + (d5 - d6))

    # Region selection mirrors the branch ladder in the reference.
    bary = np.stack([1 - v_in - w_in, v_in, w_in], -1)
    bary = np.where(((va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0))[:, None],
                    np.stack([np.zeros_like(v_bc), 1 - v_bc, v_bc], -1), bary)
    bary = np.where(((vb <= 0) & (d2 >= 0) & (d6 <= 0))[:, None],
                    np.stack([1 - v_ac, np.zeros_like(v_ac), v_ac], -1), bary)
    bary = np.where(((vc <= 0) & (d1 >= 0) & (d3 <= 0))[:, None],
                    np.stack([1 - v_ab, v_ab, np.zeros_like(v_ab)], -1), bary)
    bary = np.where(((d6 >= 0) & (d5 <= d6))[:, None],
                    np.array([0, 0, 1.0])[None], bary)
    bary = np.where(((d3 >= 0) & (d4 <= d3))[:, None],
                    np.array([0, 1.0, 0])[None], bary)
    bary = np.where(((d1 <= 0) & (d2 <= 0))[:, None],
                    np.array([1.0, 0, 0])[None], bary)

    bary = np.clip(bary, 0, 1)
    bary = bary / np.maximum(bary.sum(-1, keepdims=True), eps)
    pts = bary[:, :1] * a + bary[:, 1:2] * b + bary[:, 2:3] * c
    return pts, bary


def closest_point_on_mesh(p, mesh: SceneMesh):
    """(triangle id, barycentric, distance) of the closest surface point."""
    a = mesh.V[mesh.F[:, 0]]
    b = mesh.V[mesh.F[:, 1]]
    c = mesh.V[mesh.F[:, 2]]
    pts, bary = closest_point_triangles(np.asarray(p, np.float32), a, b, c)
    d = np.linalg.norm(pts - p, axis=-1)
    tri = int(np.argmin(d))
    return tri, bary[tri], float(d[tri])


def closest_points_on_mesh(points, mesh: SceneMesh):
    """Batched closest-point queries -> (tri [N], bary [N,3], dist [N]).
    Uses the native library (native/scene_compiler.cpp) when it builds
    here, else the numpy path, as the JAX package does."""
    points = np.ascontiguousarray(points, np.float32)
    a = mesh.V[mesh.F[:, 0]]
    b = mesh.V[mesh.F[:, 1]]
    c = mesh.V[mesh.F[:, 2]]
    result = native.closest_points(points, a, b, c)
    if result is not None:
        return result

    tris = np.empty(len(points), np.int32)
    barys = np.empty((len(points), 3), np.float32)
    dists = np.empty(len(points), np.float32)
    for i, p in enumerate(points):
        tris[i], barys[i], dists[i] = closest_point_on_mesh(p, mesh)
    return tris, barys, dists


def _rotate_about_axis(v, axis, angle):
    """Rodrigues rotation (matches instancer.cpp:330-333's expansion)."""
    return (
        v * np.cos(angle)
        + np.cross(axis, v) * np.sin(angle)
        + axis * np.dot(axis, v) * (1 - np.cos(angle))
    )


class Scene:
    """Compiled scene: everything the device instancer needs, as numpy."""

    def __init__(
        self,
        b_0,
        b_1,
        cast_shadow_rays=False,
        textures=(),
        min_shadow_samples=4,
        n_shadow_samples=512,
        min_texture_samples=4,
        n_texture_samples=512,
        jitter_amount=0.0,
        instance_sampling_method="random",
        use_mean_distance=False,
        seed=0,
    ):
        self.b_0 = np.asarray(b_0, np.float32)
        self.b_1 = np.asarray(b_1, np.float32)
        self.cast_shadow_rays = cast_shadow_rays
        self.min_shadow_samples = min_shadow_samples
        self.n_shadow_samples = n_shadow_samples
        self.min_texture_samples = min_texture_samples
        self.n_texture_samples = n_texture_samples
        self.jitter_amount = jitter_amount
        self.instance_sampling_method = instance_sampling_method
        self.use_mean_distance = use_mean_distance
        self.rng = np.random.RandomState(seed)

        self.patch_scale = 1.0
        self.patch_max_extent = float(np.linalg.norm(np.maximum(self.b_0, self.b_1)))

        # Parameter slot layout (instancer.cpp:76-92): flat channel list;
        # texture_parameter_idxs[i] is scaled by channel i at lookup time.
        self.n_parameters = 0
        self.light_dir_idx = -1
        self.light_strength_idx = -1
        self.texture_parameter_idxs = []
        self.texture_channels = []
        for entry in textures:
            if entry == "light":
                self.light_dir_idx = self.n_parameters
                self.n_parameters += 3
            elif entry == "point":
                self.light_strength_idx = self.n_parameters
                self.light_dir_idx = self.n_parameters + 1
                self.n_parameters += 4
            elif entry != "":
                channels = load_texture_channels(entry)
                self.texture_channels.extend(channels)
                self.texture_parameter_idxs.append(self.n_parameters)
                self.n_parameters += len(channels)
            else:
                self.n_parameters += 1

        # Instances.
        self.forward = []       # [4,4] local->world
        self.inverse = []       # [4,4] world->local
        self.dir_inverse = []   # [3,3] world dir -> local frame (rows T,B,N)
        self.origins = []

        self.base_mesh: SceneMesh = None
        self.aux_meshes = []

    # -- instance management (AddInstance, instancer.cpp:124-141) --------

    def add_instance(self, transformation) -> None:
        m = np.asarray(transformation, np.float32).reshape(4, 4)
        self.forward.append(m)
        self.origins.append(m[:3, 3].copy())
        self.inverse.append(np.linalg.inv(m).astype(np.float32))
        d = m[:3, :3].T.copy()
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        self.dir_inverse.append(d.astype(np.float32))

    def n_instances(self) -> int:
        return len(self.forward)

    # -- placement (DistributeInstancesOnMesh, instancer.cpp:233-390) ----

    def distribute_instances_on_mesh(self, mesh_path, scale, patch_origins_path=""):
        ply = read_ply(mesh_path)
        mesh = SceneMesh(ply.V, ply.F, ply.N, ply.UV)
        self.base_mesh = mesh

        edges = np.concatenate(
            [mesh.V[mesh.F[:, 1]] - mesh.V[mesh.F[:, 0]],
             mesh.V[mesh.F[:, 2]] - mesh.V[mesh.F[:, 1]],
             mesh.V[mesh.F[:, 0]] - mesh.V[mesh.F[:, 2]]]
        )
        avg_edge_length = float(np.linalg.norm(edges, axis=-1).mean())
        if scale <= 0:
            scale = avg_edge_length
        self.patch_scale = float(scale)
        self.patch_max_extent *= scale

        T, B, N = self._tangent_frames(mesh)

        anchors = None
        if patch_origins_path:
            try:
                anchors = read_ply(patch_origins_path).V
            except (OSError, ValueError):
                anchors = None

        if anchors is not None:
            tris, barys, _ = closest_points_on_mesh(anchors, mesh)
            for p, tri, bary in zip(anchors, tris, barys):
                f = mesh.F[tri]
                n = _normalize(bary @ N[f])
                t = _normalize(bary @ T[f])
                b = np.cross(n, t)
                if self.jitter_amount > 0:
                    angle = self.jitter_amount * self.rng.uniform(0, np.pi)
                    b = _rotate_about_axis(b, n, angle)
                t = np.cross(b, n)
                self._add_frame_instance(t, b, n, p, scale)
        else:
            seen = set()
            for i in range(len(mesh.V)):
                key = mesh.V[i].tobytes()
                if key in seen:
                    continue
                seen.add(key)
                t, b, n = T[i].copy(), B[i].copy(), N[i].copy()
                if self.jitter_amount > 0:
                    angle = self.jitter_amount * self.rng.uniform(0, np.pi)
                    b = _rotate_about_axis(b, n, angle)
                    t_cross = np.cross(n, b)
                    t = np.sign(np.dot(t, t_cross) or 1.0) * t_cross
                self._add_frame_instance(t, b, n, mesh.V[i], scale)

        # Bake per-instance anchor UV + candidate triangles for fast
        # closest-point parameter lookups on device.
        self._bake_instance_mesh_links()

    def _add_frame_instance(self, t, b, n, origin, scale):
        m = np.eye(4, dtype=np.float32)
        m[:3, 0] = t * scale
        m[:3, 1] = b * scale
        m[:3, 2] = n * scale
        m[:3, 3] = origin
        self.add_instance(m)

    def _tangent_frames(self, mesh: SceneMesh):
        """Per-vertex (T, B, N) from UV gradients (instancer.cpp:249-275)."""
        V, F, UV = mesh.V, mesh.F, mesh.UV
        N = mesh.N / np.maximum(np.linalg.norm(mesh.N, axis=-1, keepdims=True), 1e-12)

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
        # Degenerate UVs: fall back to any tangent orthogonal to N.
        fallback = np.cross(N, np.array([0.0, 0.0, 1.0]))
        fb_bad = np.linalg.norm(fallback, axis=-1, keepdims=True) < 1e-6
        fallback = np.where(fb_bad, np.cross(N, np.array([1.0, 0.0, 0.0])), fallback)
        T = np.where(norms < 1e-12, fallback, T)
        T = T / np.maximum(np.linalg.norm(T, axis=-1, keepdims=True), 1e-12)
        B = np.cross(N, T)
        return T, B, N

    def _bake_instance_mesh_links(self, k_tris: int = 16):
        """Bake per-instance surface links for device-side parameter lookups:

        - the k nearest base-mesh triangles (candidate set for exact
          closest-point UV lookups, `texture_lookup='closest'`);
        - the anchor's UV + a 2x3 world->UV Jacobian from its closest
          triangle (`texture_lookup='jacobian'`, the default): uv(p) =
          uv_anchor + J (p - anchor).  J's null space is the triangle
          normal, so off-surface sample points project onto the surface
          exactly like the reference's closest-point query does on the
          anchor triangle (instancer.cpp:640-667), at O(1) cost per sample.
        """
        mesh = self.base_mesh
        centroids = mesh.V[mesh.F].mean(1)
        origins = np.asarray(self.origins, np.float32)
        k = min(k_tris, len(centroids))
        d2 = ((origins[:, None, :] - centroids[None]) ** 2).sum(-1)
        self.instance_tri_candidates = np.argsort(d2, axis=1)[:, :k].astype(np.int32)

        n = len(origins)
        self.anchor_uv = np.zeros((n, 2), np.float32)
        self.uv_jacobian = np.zeros((n, 2, 3), np.float32)
        tris, barys, _ = closest_points_on_mesh(origins, mesh)
        for i, (p, tri, bary) in enumerate(zip(origins, tris, barys)):
            f = mesh.F[tri]
            self.anchor_uv[i] = bary @ mesh.UV[f]
            v0, v1, v2 = mesh.V[f]
            uv0, uv1, uv2 = mesh.UV[f]
            e1, e2 = v1 - v0, v2 - v0
            nrm = np.cross(e1, e2)
            nn = np.linalg.norm(nrm)
            if nn < 1e-12:
                continue
            A = np.stack([e1, e2, nrm / nn])
            try:
                A_inv = np.linalg.inv(A)
            except np.linalg.LinAlgError:
                continue
            for r in range(2):
                rhs = np.array([uv1[r] - uv0[r], uv2[r] - uv0[r], 0.0])
                self.uv_jacobian[i, r] = A_inv @ rhs

    # -- aux meshes (AddMesh, instancer.cpp:393-417) ----------------------

    def add_mesh(self, mesh_path, texture_path=""):
        """An auxiliary mesh: it terminates rays and casts shadows like the
        base mesh, and its terminator is shaded (DeviceInstancer
        ``_shade_terminator``) with its albedo texture, if any."""
        ply = read_ply(mesh_path)
        textures = load_texture_channels(texture_path) if texture_path else []
        self.aux_meshes.append(SceneMesh(ply.V, ply.F, ply.N, ply.UV, textures))

    # -- queries of the host oracle (instancing/oracle.py) -----------------

    def get_parameters(self, pt, parameters):
        """Scale texture-driven parameter slots by the base-mesh texture at
        the closest surface point (instancer.cpp:640-667)."""
        out = np.array(parameters, np.float32)
        if self.base_mesh is None or not self.texture_parameter_idxs:
            return out
        tri, bary, d = closest_point_on_mesh(pt, self.base_mesh)
        uv = bary @ self.base_mesh.UV[self.base_mesh.F[tri]]
        for i, slot in enumerate(self.texture_parameter_idxs):
            out[slot] *= sample_texture(self.texture_channels[i], uv[None])[0]
        return out

    def export_transformations(self, file_path):
        """Dump forward transforms as JSON (instancer.cpp:1040-1061)."""
        root = [np.linalg.inv(inv).tolist() for inv in self.inverse]
        with open(file_path, "w") as f:
            json.dump(root, f, indent=4)
        print(file_path)


def _normalize(v):
    return v / max(np.linalg.norm(v), 1e-12)
