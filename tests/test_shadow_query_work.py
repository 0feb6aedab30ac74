"""chip_smoke.shadow_query_work, the float operations the shadow query
kernel's bound counts: each point walks the boxes, then the triangles, up to
and including its first blocking column, and each test is counted to the
exit it takes.  Exact counts on hand-made scenes; on random ones, the walk
blocks what kernels/shadow_query.py's plain chain blocks, whatever the
chunking, and its count lies between every walked test's first exit and
every test run to its end."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from nerftex_torch.kernels import shadow_query as sq

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()
BOX = sum(cs.SHADOW_BOX_STEPS)                         # o and d in the local frame
FACE = sum(cs.SHADOW_FACE_OPS)                         # a face crossed in range
TRI = sum(cs.SHADOW_TRI_STEPS)                         # a triangle to its end
FIRST = cs.SHADOW_BOX_STEPS[0]                         # the first exit of either kind
assert FIRST == cs.SHADOW_TRI_STEPS[0]

BOUNDS = (torch.tensor([-0.5, -0.5, -0.5]), torch.tensor([0.5, 0.5, 0.5]))
# A triangle in the plane z = 0 under the point (0, 0, 2), its front face up.
TRIANGLE = tuple(torch.tensor([v], dtype=torch.float32) for v in
                 ([-1.0, -1.0, 0.0], [3.0, 0.0, 0.0], [0.0, 3.0, 0.0], [0.0, 0.0, 9.0]))

# name: (light, box x offsets, boxes padded, triangle, operations, blocked)
CASES = {
    "the first box's top face blocks; the second is not walked":
        ((0, 0, -1), (0, 10), False, False, BOX + FACE, True),
    "light away from both boxes: no face toward the point":
        ((0, 0, 1), (0, 10), False, False, 2 * sum(cs.SHADOW_BOX_STEPS[:2]), False),
    "light parallel to the faces: |dz| floor":
        ((1, 0, 0), (0, 10), False, False, 2 * FIRST, False),
    "padding columns are zeros":
        ((0, 0, -1), (0, 10), True, False, 2 * FIRST, False),
    "both faces crossed in range, outside the box":
        ((1, 0, -1), (0, 10), False, False, 2 * (BOX + 2 * FACE), False),
    "the box's faces are crossed beside it, then the triangle blocks":
        ((0, 0, -1), (10,), False, True, BOX + 2 * FACE + TRI, True),
    "a box blocks: the triangle is not walked":
        ((0, 0, -1), (0,), False, True, BOX + FACE, True),
    "the triangle's back face":
        ((0, 0, 1), (), False, True, FIRST, False),
}


def _scene(light, offsets, padded, triangle):
    pts = torch.tensor([[0.0, 0.0, 2.0]])
    light = torch.tensor([light], dtype=torch.float32)
    n = len(offsets)
    inv_rot = torch.eye(3).repeat(n, 1, 1)
    inv_trans = torch.tensor([[float(x), 0.0, 0.0] for x in offsets]).reshape(n, 3)
    inst_sel = (torch.arange(n), torch.zeros(n, dtype=torch.bool)) if padded else None
    return (pts, light, (inv_rot, inv_trans), TRIANGLE if triangle else None, BOUNDS, inst_sel,
            None)


@pytest.mark.parametrize("case", sorted(CASES))
def test_each_test_is_counted_to_its_exit(case):
    *scene, ops, blocked = CASES[case]
    args = _scene(*scene)
    got_ops, got_blocked = cs.shadow_query_work(args)
    assert got_ops == ops
    assert got_blocked.tolist() == [blocked] == sq.shadow_query_plain(*args).tolist()


def _random(seed, m=300, n_box=40, n_tri=30):
    rs = np.random.RandomState(seed)

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32))

    rot = np.linalg.qr(rs.normal(size=(n_box, 3, 3)))[0]
    pts = f32(rs.uniform(-1.5, 1.5, (m, 3)))
    light = f32(rs.normal(size=(m, 3)) + [0, 0, -0.5])
    boxes = (f32(rot), f32(rs.uniform(-1.5, 1.5, (n_box, 3))))
    v0 = rs.uniform(-1.5, 1.5, (n_tri, 3))
    e1, e2 = rs.normal(scale=0.6, size=(2, n_tri, 3))
    tris = (f32(v0), f32(e1), f32(e2), f32(np.cross(e1, e2)))
    bounds = (f32([-0.3, -0.3, -0.1]), f32([0.3, 0.3, 0.4]))
    inst_sel = (torch.tensor(rs.randint(0, n_box, 24)), torch.tensor(rs.uniform(size=24) < 0.8))
    tri_sel = (torch.tensor(rs.randint(0, n_tri, 16)), torch.tensor(rs.uniform(size=16) < 0.8))
    return pts, light, boxes, tris, bounds, inst_sel, tri_sel


@pytest.mark.parametrize("branch", ["culled", "full"])
@pytest.mark.parametrize("seed", [0, 1])
def test_the_walk_blocks_what_the_plain_chain_blocks(seed, branch):
    args = _random(seed)
    if branch == "full":
        args = args[:5] + (None, None)
    ops, blocked = cs.shadow_query_work(args)
    want = sq.shadow_query_plain(*args)
    assert torch.equal(blocked, want)
    assert 0 < int(want.sum()) < want.numel()
    chunked = cs.shadow_query_work(args, plane=97)
    assert chunked[0] == ops and torch.equal(chunked[1], want)
    n_box = args[2][0].shape[0] if args[5] is None else args[5][0].shape[0]
    n_tri = args[3][0].shape[0] if args[6] is None else args[6][0].shape[0]
    m = want.numel()
    # An unblocked point walks every column; a blocked one at least one.
    least = FIRST * ((m - int(want.sum())) * (n_box + n_tri) + int(want.sum()))
    most = m * (n_box * (BOX + 2 * FACE) + n_tri * TRI)
    assert least <= ops < most
