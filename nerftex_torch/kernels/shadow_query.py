"""The shadow query: whether anything blocks each point toward its light,
as a CUDA kernel and its plain version.

Source note.  This kernel replaces no Pallas kernel: it replaces the eager
chain of nerftex_tpu/instancing/device.py:2180 ``_shadow_query``, which XLA
fuses into one any-reduction on the TPU and which PyTorch ran as about 130
elementwise launches over [points, columns] planes for each chunk of
points (``shadow_query_plain`` below is that chain, moved here unchanged).
It is bound by float32 operations (about 60 a point-column test, a few
bytes a point), not by bytes; csrc/shadow_query.cu keeps every
[points, columns] value in registers, reduces in a flag per thread, leaves
each test at its first failing condition and each point at its first
blocking column, and stops a CTA once all its points are blocked.  It is
bit-equal to the plain chain.

For each point [M, 3] and its light direction [M, 3], over the instance
boxes and the mesh triangles (or their candidate subsets):

  box       the ray from the point along the light, in the instance's local
            frame, crosses the top face (z = b_1z) going down or the bottom
            face (z = b_0z), at 0 < t < T_FAR, inside the face;
  triangle  Moller-Trumbore with a finite t, front faces only (l . ng < 0);

padding candidates (valid False) never block.  ``shadow_query`` runs
``shadow_query_plain`` for CPU tensors and the kernel for CUDA tensors;
it counts ``shadow.points`` for every point that enters it and
``shadow.kernel`` for those the kernel answered.
"""

import torch

from nerftex_torch.instancing.geometry import T_FAR, moller_trumbore
from nerftex_torch.kernels import build
from nerftex_torch.utils import trace

# The plain chain runs in chunks of points so that each [points, columns]
# float32 plane stays at or under 2^24 elements (64 MiB); the box and
# triangle tests hold about 15 such planes at once (~1 GiB).  One plush
# block's full query would be [65536, 3120] per plane (0.8 GiB).
_SHADOW_PLANE = 1 << 24


def shadow_query_plain(pts, light_dir, boxes, tris, bounds, inst_sel=None, tri_sel=None):
    """The query as the eager [points, columns] chain, in chunks of points
    so that no plane exceeds _SHADOW_PLANE elements.  Arguments as for
    ``shadow_query``."""
    inv_rot, inv_trans = boxes
    if inst_sel is not None:
        rot, trans = inv_rot[inst_sel[0]], inv_trans[inst_sel[0]]
        col_valid = inst_sel[1]
    else:
        rot, trans, col_valid = inv_rot, inv_trans, None
    if tris is not None:
        if tri_sel is not None:
            tris = (*(x[tri_sel[0]] for x in tris), tri_sel[1])
        else:
            tris = (*tris, None)
    n_cols = max(rot.shape[0], 0 if tris is None else tris[0].shape[0], 1)
    m = max(1, _SHADOW_PLANE // n_cols)
    return torch.cat([_shadow_chunk(pts[i:i + m], light_dir[i:i + m], rot, trans, col_valid,
                                    bounds, tris)
                      for i in range(0, pts.shape[0], m)])


def _shadow_chunk(p, l, rot, trans, col_valid, bounds, tris):
    b_0, b_1 = bounds

    def row(c, v):
        return (v[:, 0, None] * rot[:, c, 0] + v[:, 1, None] * rot[:, c, 1]
                + v[:, 2, None] * rot[:, c, 2])

    # Local-frame rays as broadcast multiply-adds, [m, N] per component.
    o_lx = row(0, p) + trans[:, 0]
    o_ly = row(1, p) + trans[:, 1]
    o_lz = row(2, p) + trans[:, 2]
    d_lx, d_ly, dz = row(0, l), row(1, l), row(2, l)
    safe_dz = torch.where(dz.abs() < 1e-12, 1e-12, dz)
    dz_ok = dz.abs() > 1e-12

    def face(z_plane):
        t = (z_plane - o_lz) / safe_dz
        px = o_lx + t * d_lx
        py = o_ly + t * d_ly
        return ((t > 0) & (t < T_FAR) & (px >= b_0[0]) & (px <= b_1[0])
                & (py >= b_0[1]) & (py <= b_1[1]) & dz_ok)

    face_ok = (face(b_1[2]) & (dz < 0)) | face(b_0[2])
    if col_valid is not None:
        face_ok = face_ok & col_valid
    blocked = face_ok.any(-1)

    if tris is not None:
        v0, e1, e2, ng, tri_valid = tris
        t_hit = moller_trumbore(p, l, v0, e1, e2)[0]
        front = (l[:, 0, None] * ng[:, 0] + l[:, 1, None] * ng[:, 1]
                 + l[:, 2, None] * ng[:, 2]) < 0
        tri_ok = torch.isfinite(t_hit) & front
        if tri_valid is not None:
            tri_ok = tri_ok & tri_valid
        blocked = blocked | tri_ok.any(-1)
    return blocked


def _check(pts, light_dir, boxes, tris, bounds, inst_sel, tri_sel):
    """Raise unless the kernel takes these inputs: each one's dtype, shape
    and contiguity, then all on the CUDA device of ``pts``."""
    def rows(x):
        return x.shape[0] if x.dim() else -1

    m = rows(pts)
    named = {"pts": (pts, torch.float32, (m, 3)), "light_dir": (light_dir, torch.float32, (m, 3)),
             "inv_rot": (boxes[0], torch.float32, (rows(boxes[0]), 3, 3)),
             "inv_trans": (boxes[1], torch.float32, (rows(boxes[0]), 3)),
             "b_0": (bounds[0], torch.float32, (3,)), "b_1": (bounds[1], torch.float32, (3,))}
    if tris is not None:
        named.update({k: (x, torch.float32, (rows(tris[0]), 3))
                      for k, x in zip(("v0", "e1", "e2", "ng"), tris)})
    for kind, sel in (("inst", inst_sel), ("tri", tri_sel)):
        if sel is not None:
            named[f"{kind}_ids"] = (sel[0], torch.int64, (rows(sel[0]),))
            named[f"{kind}_valid"] = (sel[1], torch.bool, (rows(sel[0]),))
    for name, (x, dtype, shape) in named.items():
        if x.dtype != dtype:
            raise TypeError(f"shadow_query: {name} has dtype {x.dtype}, not {dtype}")
        if tuple(x.shape) != shape or not 0 <= x.numel() < 2**31:
            raise ValueError(f"shadow_query: {name} must be {list(shape)} (under 2^31 "
                             f"elements), got {list(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"shadow_query: {name} is not contiguous")
    for name, (x, _, _) in named.items():
        if x.device.type != "cuda" or x.device != pts.device:
            raise ValueError(f"shadow_query needs every input on one CUDA device: {name} is on "
                             f"{x.device}, pts on {pts.device}")


def shadow_query(pts, light_dir, boxes, tris, bounds, inst_sel=None, tri_sel=None):
    """Whether anything blocks each point toward its light: blocked [M]
    bool.

    pts, light_dir [M, 3]; boxes (inv_rot [N, 3, 3], inv_trans [N, 3]), the
    instances' world-to-local transforms; tris (v0, e1, e2, ng), each
    [T, 3], or None for no mesh; bounds (b_0, b_1), each [3], the patch
    box; inst_sel / tri_sel: (ids [C] int64, valid [C] bool) candidate
    subsets, or None for every column.  CPU tensors run the plain chain;
    CUDA tensors the kernel, or raise."""
    m = pts.shape[0]
    trace.count("shadow.points", m)
    if pts.device.type == "cpu":
        return shadow_query_plain(pts, light_dir, boxes, tris, bounds, inst_sel, tri_sel)
    _check(pts, light_dir, boxes, tris, bounds, inst_sel, tri_sel)
    out = torch.empty(m, dtype=torch.bool, device=pts.device)
    if m == 0:
        return out

    def cols(tables, sel):
        """Table pointers (None when empty), ids, valid flags, column count."""
        n = tables[0].shape[0] if sel is None else sel[0].shape[0]
        ids, valid = (None, None) if sel is None else (sel[0].data_ptr(), sel[1].data_ptr())
        return [x.data_ptr() if n else None for x in tables], ids, valid, n

    box_ptrs, box_ids, box_valid, n_box = cols(boxes, inst_sel)
    tri_ptrs, tri_ids, tri_valid, n_tri = cols(tris, tri_sel) if tris is not None else (
        [None] * 4, None, None, 0)
    rc = build.entry("shadow_query")(
        pts.data_ptr(), light_dir.data_ptr(), m, *box_ptrs, box_ids, box_valid, n_box,
        *tri_ptrs, tri_ids, tri_valid, n_tri, bounds[0].data_ptr(), bounds[1].data_ptr(),
        out.data_ptr(), torch.cuda.current_stream(pts.device).cuda_stream)
    build.check("shadow_query", rc)
    shadow_query.launches += 1
    trace.count("shadow.kernel", m)
    return out


shadow_query.launches = 0
