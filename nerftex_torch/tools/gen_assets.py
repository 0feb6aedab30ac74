"""Procedural substitute assets (the port's own copy of
nerftex_tpu/tools/gen_assets.py).

The reference repo's meshes/ are git-LFS stubs (SURVEY.md "Assets"), so the
actual geometry is not available.  This generates equivalent assets under the
same filenames so the shipped render configs run unchanged; seed 0 writes
the bytes committed under meshes/:

  cloth_mesh.ply / cloth_anchor_points.ply     wavy UV-mapped cloth grid
  terrain_mesh.ply / terrain_anchor_points.ply rolling heightfield
  stanford_bunny.ply                           deformed icosphere blob
  checkerboard.png / smooth_checkerboard.png   parameter textures
  cloth10k_anchor_points.ply                   generate_scale_anchors(n=10000)

    python -m nerftex_torch.tools.gen_assets --out meshes [--seed 0]
"""

import os

import numpy as np

from nerftex_torch.instancing.ply import write_ply
from nerftex_torch.utils.image import encode_png


def _grid_mesh(n, extent, height_fn):
    """Regular (n x n) grid over [-extent, extent]^2 with z = height_fn(x, y)."""
    xs = np.linspace(-extent, extent, n)
    gx, gy = np.meshgrid(xs, xs, indexing="ij")
    gz = height_fn(gx, gy)
    V = np.stack([gx, gy, gz], -1).reshape(-1, 3).astype(np.float32)
    UV = np.stack([(gx + extent) / (2 * extent), (gy + extent) / (2 * extent)], -1).reshape(-1, 2)

    F = []
    for i in range(n - 1):
        for j in range(n - 1):
            a = i * n + j
            b = a + 1
            c = a + n
            d = c + 1
            F.append([a, c, b])
            F.append([b, c, d])
    F = np.asarray(F, np.int32)
    return V, F, UV.astype(np.float32)


def vertex_normals(V, F):
    """Area-weighted vertex normals of the triangles F over the vertices V."""
    N = np.zeros_like(V)
    e1 = V[F[:, 1]] - V[F[:, 0]]
    e2 = V[F[:, 2]] - V[F[:, 0]]
    fn = np.cross(e1, e2)
    for k in range(3):
        np.add.at(N, F[:, k], fn)
    norm = np.linalg.norm(N, axis=-1, keepdims=True)
    return N / np.maximum(norm, 1e-12)


def cloth(n=48, extent=1.0):
    def height(x, y):
        return 0.12 * np.sin(2.5 * x) * np.cos(2.0 * y) + 0.05 * np.sin(5.0 * (x + y))

    V, F, UV = _grid_mesh(n, extent, height)
    return V, F, vertex_normals(V, F), UV


def terrain(n=48, extent=1.0):
    def height(x, y):
        return (
            0.18 * np.sin(1.7 * x + 0.5) * np.sin(1.3 * y)
            + 0.1 * np.cos(3.1 * x) * np.sin(2.3 * y + 1.0)
            + 0.05 * np.sin(6.0 * x * y)
        )

    V, F, UV = _grid_mesh(n, extent, height)
    return V, F, vertex_normals(V, F), UV


def bunny_blob(n_theta=40, n_phi=40, scale=0.48):
    """Deformed sphere standing in for the Stanford bunny (LFS stub):
    body blob plus two ear lobes and a tail bump so the silhouette reads
    as the bunny in demo renders."""
    thetas = np.linspace(1e-3, np.pi - 1e-3, n_theta)
    phis = np.linspace(0, 2 * np.pi, n_phi, endpoint=False)
    t, p = np.meshgrid(thetas, phis, indexing="ij")
    r = 1.0 + 0.18 * np.sin(3 * t) * np.cos(2 * p) + 0.1 * np.cos(4 * p) * np.sin(2 * t)

    # Ears: two elongated gaussian lobes near the pole, offset in phi.
    def lobe(t0, p0, st, sp, amp):
        dp = np.angle(np.exp(1j * (p - p0)))
        return amp * np.exp(-((t - t0) ** 2) / (2 * st**2) - dp**2 / (2 * sp**2))

    # Amplitudes sized so the ear tips stay inside the plush configs'
    # instancer box ([-1.1, 1.1]^2 x [-0.2, 1.1]) at scale 0.48.
    r = r + lobe(0.35, 2.35, 0.2, 0.35, 0.7) + lobe(0.35, 3.95, 0.2, 0.35, 0.7)
    # Tail bump low on the back.
    r = r + lobe(2.35, 0.0, 0.25, 0.45, 0.3)

    x = r * np.sin(t) * np.cos(p)
    y = r * np.sin(t) * np.sin(p)
    z = r * np.cos(t) * 1.15
    V = (np.stack([x, y, z], -1).reshape(-1, 3) * scale).astype(np.float32)
    V[:, 2] += 0.1
    UV = np.stack([p / (2 * np.pi), 1 - t / np.pi], -1).reshape(-1, 2).astype(np.float32)

    F = []
    for i in range(n_theta - 1):
        for j in range(n_phi):
            a = i * n_phi + j
            b = i * n_phi + (j + 1) % n_phi
            c = a + n_phi
            d = b + n_phi
            F.append([a, c, b])
            F.append([b, c, d])
    F = np.asarray(F, np.int32)
    return V, F, vertex_normals(V, F), UV


def poisson_like_anchors(V, F, n_anchors, seed=0):
    """Anchor points on the surface: area-weighted face sampling + jitter-free
    barycentric draws, then greedy spacing (approximate blue noise)."""
    rs = np.random.RandomState(seed)
    e1 = V[F[:, 1]] - V[F[:, 0]]
    e2 = V[F[:, 2]] - V[F[:, 0]]
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
    prob = area / area.sum()

    n_cand = n_anchors * 8
    faces = rs.choice(len(F), n_cand, p=prob)
    u = rs.rand(n_cand)
    v = rs.rand(n_cand)
    flip = u + v > 1
    u[flip], v[flip] = 1 - u[flip], 1 - v[flip]
    pts = V[F[faces, 0]] + u[:, None] * e1[faces] + v[:, None] * e2[faces]

    chosen = [0]
    d2 = np.sum((pts - pts[0]) ** 2, -1)
    for _ in range(n_anchors - 1):
        idx = int(np.argmax(d2))
        chosen.append(idx)
        d2 = np.minimum(d2, np.sum((pts - pts[idx]) ** 2, -1))
    return pts[chosen].astype(np.float32)


def checkerboard_png(size=256, cells=8, smooth=False):
    xs = np.arange(size) / size * cells
    gx, gy = np.meshgrid(xs, xs, indexing="ij")
    if smooth:
        img = 0.5 + 0.45 * np.sin(np.pi * gx) * np.sin(np.pi * gy)
    else:
        img = ((np.floor(gx) + np.floor(gy)) % 2).astype(np.float32)
        img = 0.25 + 0.5 * img
    return encode_png(img[..., None].astype(np.float32))


def generate_scale_anchors(out_dir="meshes", n=10000, seed=0):
    """Dense anchor set for the instance-count scale bench (SURVEY §2.2
    sizes instance counts at 10^2-10^4; every shipped scene runs ~900).
    Writes cloth<n>k anchor points over the SAME cloth mesh so the scale
    config (configs/config_carpet10k_render.py) differs from the carpet
    north-star only in instance count and patch scale."""
    os.makedirs(out_dir, exist_ok=True)
    V, F, _, _ = cloth()
    anchors = poisson_like_anchors(V, F, n, seed)
    path = os.path.join(out_dir, f"cloth{n // 1000}k_anchor_points.ply")
    write_ply(path, anchors)
    return path


def generate(out_dir="meshes", seed=0):
    os.makedirs(out_dir, exist_ok=True)

    V, F, N, UV = cloth()
    write_ply(os.path.join(out_dir, "cloth_mesh.ply"), V, F, N, UV)
    anchors = poisson_like_anchors(V, F, 900, seed)
    write_ply(os.path.join(out_dir, "cloth_anchor_points.ply"), anchors)

    V, F, N, UV = terrain()
    write_ply(os.path.join(out_dir, "terrain_mesh.ply"), V, F, N, UV)
    anchors = poisson_like_anchors(V, F, 900, seed + 1)
    write_ply(os.path.join(out_dir, "terrain_anchor_points.ply"), anchors)

    V, F, N, UV = bunny_blob()
    write_ply(os.path.join(out_dir, "stanford_bunny.ply"), V, F, N, UV)

    with open(os.path.join(out_dir, "checkerboard.png"), "wb") as f:
        f.write(checkerboard_png(smooth=False))
    with open(os.path.join(out_dir, "smooth_checkerboard.png"), "wb") as f:
        f.write(checkerboard_png(smooth=True))

    return out_dir


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="Generate substitute mesh/texture assets.")
    ap.add_argument("--out", default="meshes")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    print(generate(args.out, args.seed))
