"""Ray geometry shared by the device instancer and the shadow query kernel's
plain chain: the far clip and Moller-Trumbore over a triangle soup."""

import torch

T_FAR = 100.0


def moller_trumbore(o, d, v0, e1, e2, t_max=T_FAR):
    """First-hit distance of each ray [R,3] to each triangle [T,3] and the
    barycentrics: (t [R,T], inf where missed; u; v)."""
    ox, oy, oz = (o[:, c, None] for c in range(3))
    dx, dy, dz = (d[:, c, None] for c in range(3))
    e2x, e2y, e2z = e2.unbind(-1)
    e1x, e1y, e1z = e1.unbind(-1)
    v0x, v0y, v0z = v0.unbind(-1)

    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv_det = 1.0 / torch.where(det.abs() < 1e-12, 1e-12, det)

    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det

    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det

    ok = (det.abs() > 1e-12) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-6) & (t < t_max)
    return torch.where(ok, t, float("inf")), u, v
