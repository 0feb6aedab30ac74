"""Ray geometry shared by the device instancer, the per-ray kernels' and the
shadow query kernel's plain chains: the far clip, Moller-Trumbore over a
triangle soup, 3-term dots as XLA contracts them, and a ray block's fan
with its conservative sphere culls."""

import math

import torch

from nerftex_torch.utils import trace

T_FAR = 100.0
# The unit roundoff of bfloat16 (8 significant bits, to nearest).
BF16_UNIT = 2.0**-8


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


def fma(a, b, c):
    """a * b + c rounded once to float32, as XLA contracts a multiply-add:
    exact in float64 (a product of float32 values is exact there) but for
    a double rounding once in ~2^29 cases."""
    return (a.double() * b.double() + c.double()).float()


def dot3(a, b):
    """sum(a * b, -1) over 3 components as XLA evaluates it:
    fma(a2, b2, fma(a1, b1, a0 b0))."""
    return fma(a[..., 2], b[..., 2], fma(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def block_fan(rays_o, rays_d):
    """Anisotropic bound of a ray block: origin sphere (o_c, r_o), mean
    direction u, principal in-fan axis w (power iteration), fan normal,
    out-of-plane sine bound and in-plane half-angle."""
    eps = 1e-12
    o_c = rays_o.mean(0)
    r_o = torch.sqrt(torch.clamp(torch.max(torch.sum((rays_o - o_c) ** 2, -1)), min=0.0))
    d_n = rays_d / torch.clamp(torch.linalg.norm(rays_d, dim=-1, keepdim=True), min=eps)
    u = d_n.mean(0)
    u = u / torch.clamp(torch.linalg.norm(u), min=eps)

    resid = d_n - (d_n @ u)[:, None] * u
    cov = resid.T @ resid
    with trace.host_read("fan"):
        # A 0-d index tensor is read back to the host as an int.
        w = cov[:, torch.argmax(torch.diagonal(cov))] + 1e-20
    for _ in range(3):
        w = cov @ w
        w = w / torch.clamp(torch.linalg.norm(w), min=eps)
    w = w - (w @ u) * u
    w = w / torch.clamp(torch.linalg.norm(w), min=eps)
    nrm = torch.linalg.cross(u, w)
    nrm = nrm / torch.clamp(torch.linalg.norm(nrm), min=eps)

    sin_perp = torch.max(torch.abs(d_n @ nrm)) + 1e-6
    s_in = torch.max(torch.atan2(torch.abs(d_n @ w), d_n @ u)) + 1e-6
    return o_c, r_o, u, w, nrm, sin_perp, s_in


def slab_kappa(inv_rot):
    """max over instances of ||R||_F / sigma_min(R) (R: inv_rot [N, 3, 3]),
    the factor by which rounding R's entries by a relative u moves a local
    point, measured in world units, per unit of its world distance from the
    origin (slab_pad)."""
    r = torch.as_tensor(inv_rot, dtype=torch.float64).cpu().reshape(-1, 3, 3)
    if not len(r):
        return 0.0
    return float((torch.linalg.matrix_norm(r) / torch.linalg.svdvals(r)[:, -1]).max())


def slab_pad(kappa, matmul_precision):
    """(a, b), the coefficients of the pad that keeps the instance cull
    conservative when the slab test rounds its operands (None at float32).

    The slab test of a ray (o, d) against a box takes R~ = R + E and
    o~ = o + e_o, d~ = d + e_d, each entry rounded by at most u relative,
    so a point of the rounded ray inside the box, at parameter t, lies
    err <= u kappa |x| + u (1 + u kappa) (|o| + t |d|) from the exact ray's
    point x = o + t d (kappa: slab_kappa).  For a sphere (c, rho) about the
    box and a block fan about o_c of radius r_o at distance dist from c,
    |x| <= |c| + rho + err and |o| + t |d| <= |o_c| + dist + 2 r_o + rho +
    err, so every box the rounded test can hit lies within the sphere of
    radius rho + a (|c| + rho) + b (|o_c| + dist + 2 r_o + rho)
    (fan_keep's ``pad``).  The coefficients carry a 1e-3 margin for the
    float32 evaluation of the pad."""
    if matmul_precision != "bfloat16":
        return None
    u = BF16_UNIT
    den = 1.0 - u * kappa - u * (1.0 + u * kappa)
    return (u * kappa / den * (1 + 1e-3), u * (1.0 + u * kappa) / den * (1 + 1e-3))


def fan_keep(fan, centers, radii, pad=None):
    """Conservative sphere-vs-fan test: True for every sphere that can
    intersect a ray of the block; with ``pad`` (slab_pad's coefficients)
    each sphere is widened to hold every box that a slab test over rounded
    operands can hit."""
    o_c, r_o, u, w, nrm, sin_perp, s_in = fan
    v = centers - o_c
    dist = torch.linalg.norm(v, dim=-1)
    if pad is not None:
        a, b = pad
        radii = radii + (a * (torch.linalg.norm(centers, dim=-1) + radii)
                         + b * (torch.linalg.norm(o_c) + dist + 2.0 * r_o + radii))
    reach = radii + r_o
    inside = dist <= reach
    out_ok = torch.abs(v @ nrm) <= (dist + reach) * sin_perp + reach
    va = v @ u
    vb = v @ w
    pd = torch.sqrt(va**2 + vb**2)
    theta = torch.atan2(torch.abs(vb), va)
    dtheta = torch.clamp(torch.clamp(theta - s_in, min=0.0), max=math.pi / 2)
    in_ok = (theta <= s_in) | (pd * torch.sin(dtheta) <= reach)
    return inside | (out_ok & in_ok)


def keep_to_candidates(keep, C):
    """The first C kept ids in ascending order and their validity."""
    n = keep.shape[0]
    idx = torch.arange(n, device=keep.device)
    prio = torch.sort(torch.where(keep, idx, n + idx)).values[:C]
    cand_valid = prio < n
    return torch.where(cand_valid, prio, 0), cand_valid
