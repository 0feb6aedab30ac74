"""kernels/per_ray.py on the CPU: the wrapper's refusals (on meta tensors,
before any launch), the CPU path (the plain chain: no launch, only
``per_ray.rays`` counted), the culls as exact speed tiers of the plain
chain on carpet and grass blocks (under bfloat16 slab operands too, with
geometry.slab_pad's widened spheres), and the tracer's counts read from the
device.  The kernels themselves are held to the plain chain on the card
(tests/test_torch_cuda.py, marked gpu)."""

import types

import pytest
import torch

from nerftex_torch.kernels import per_ray as pr
from nerftex_torch.utils import trace

RB, N, T = 64, 40, 30


def _scene(device="meta", n=N, t=T, **override):
    """Scene tables of the shapes per_ray takes (values unused on meta)."""
    def f(*shape):
        return torch.zeros(shape, device=device)

    tables = dict(n_instances=n, n_tris=t, inv_rot=f(n, 3, 3), inv_trans=f(n, 3),
                  origins=f(n, 3), inst_center=f(n, 3), inst_radius=f(n), b_0=f(3), b_1=f(3),
                  tri_v0=f(t, 3), tri_e1=f(t, 3), tri_e2=f(t, 3), tri_center=f(t, 3),
                  tri_radius=f(t), slab_kappa=3**0.5)
    tables.update(override)
    return types.SimpleNamespace(**tables)


def _args(device="meta", K=16, **override):
    rays = {"rays_o": torch.zeros(RB, 3, device=device),
            "rays_d": torch.zeros(RB, 3, device=device),
            "u_off": torch.zeros(RB, device=device)}
    scene_kw = {k: v for k, v in override.items() if k not in rays}
    rays.update({k: v for k, v in override.items() if k in rays})
    return (_scene(device, **scene_kw), rays["rays_o"], rays["rays_d"], rays["u_off"], K, 320,
            0.002)


BAD_INPUTS = {
    "meta_tensors": ((), ValueError),
    "k_above_the_largest_list": ((("K", pr.MAX_HITS + 1),), ValueError),
    "k_of_zero": ((("K", 0),), ValueError),
    "k_above_the_instances": ((("K", N + 1),), ValueError),
    "rays_d_of_other_rows": ((("rays_d", torch.zeros(RB + 1, 3, device="meta")),), ValueError),
    "u_off_of_other_rows": ((("u_off", torch.zeros(RB - 1, device="meta")),), ValueError),
    "rays_of_four_columns": ((("rays_o", torch.zeros(RB, 4, device="meta")),), ValueError),
    "inv_trans_of_other_rows": ((("inv_trans", torch.zeros(N - 1, 3, device="meta")),),
                                ValueError),
    "inv_rot_of_other_shape": ((("inv_rot", torch.zeros(N, 9, device="meta")),), ValueError),
    "tri_radius_of_other_rows": ((("tri_radius", torch.zeros(T + 2, device="meta")),),
                                 ValueError),
    "float64_origins": ((("origins", torch.zeros(N, 3, dtype=torch.float64,
                                                  device="meta")),), TypeError),
    "strided_offsets": ((("u_off", torch.zeros(RB, 2, device="meta")[:, 0]),), ValueError),
}


@pytest.mark.parametrize("name", sorted(BAD_INPUTS))
def test_per_ray_refuses_what_the_kernels_cannot_take(name):
    """On meta tensors, so that the refusal comes before any launch: a meta
    block with good shapes is refused for its device, and every other case
    for its own fault, whatever the device."""
    changes, error = BAD_INPUTS[name]
    kw = dict(changes)
    K = kw.pop("K", 16)
    before = pr.per_ray.launches
    with pytest.raises(error):
        pr.per_ray(*_args(K=K, **kw))
    assert pr.per_ray.launches == before


def test_strided_rays_pass_the_checks():
    """Rays at any strides (one origin expanded over the block) reach the
    device check, the last one."""
    pose = torch.zeros(4, 4, device="meta")
    args = _args(rays_o=pose[:3, 3].expand(RB, 3))
    with pytest.raises(ValueError, match="CUDA device"):
        pr.per_ray(*args)


@pytest.fixture(scope="module")
def frames():
    """chip_smoke.per_ray_setup of carpet and grass on the CPU."""
    import chip_smoke

    return {name: chip_smoke.per_ray_setup(name, "cpu") for name in ("carpet", "grass")}


def _block(frames, name, rays=256):
    """``rays`` rays across the middle of the frame's 0.6 mark: a block
    narrower than the scene's, whose keep sets fit its budgets (carpet's
    middle blocks overrun them)."""
    dev, rays_o, rays_d, params, S, step = frames[name]
    row = 512 * int(0.6 * rays_o.shape[0] / 512)
    start = row + (512 - rays) // 2
    sl = slice(start, start + rays)
    return dev, rays_o[sl], rays_d[sl], params[sl], S, step


@pytest.mark.parametrize("name", ["carpet", "grass"])
def test_cpu_per_ray_launches_nothing_and_counts_its_rays(frames, name):
    dev, rays_o, rays_d, params, S, step = _block(frames, name)
    before = pr.per_ray.launches
    trace.reset()
    with trace.recording():
        ray = dev._per_ray(rays_o, rays_d, params, S, step, torch.full((256,), 0.5))
    totals = trace.totals()
    trace.reset()
    assert pr.per_ray.launches == before
    assert totals["per_ray.rays"] == 256 and "per_ray.kernel" not in totals
    # The plain chain still reads each cull's count on the host.
    assert totals.get("cull.fit", 0) + totals.get("cull.full", 0) == 2
    assert ray["kvalid"].any() and ray["n_steps"].max() > 0


@pytest.mark.parametrize("name", ["carpet", "grass"])
def test_culled_and_full_branches_give_equal_tables(frames, name):
    """The plain chain with the culls on (this block's keep sets fit) and
    off: every table equal, the hit slots' anchor terms and ids in the
    valid slots (an invalid slot holds a column the branch did not keep)
    and the first triangle and its barycentrics where the mesh is hit (a
    miss names the branch's first column)."""
    dev, rays_o, rays_d, _, S, step = _block(frames, name)
    args = (dev.ds, rays_o, rays_d, torch.full((256,), 0.5), min(dev.max_hits,
                                                                 dev.ds.n_instances), S, step)
    trace.reset()
    with trace.recording():
        culled = pr.per_ray(*args, dev.cull_budget, dev.tri_cull_budget, dev.matmul_precision)
    assert trace.totals()["cull.fit"] == 2
    trace.reset()
    full = pr.per_ray(*args, 0, 0, dev.matmul_precision)
    valid, mesh = full["kvalid"], torch.isfinite(full["t_mesh"])
    assert valid.any() and mesh.any() and torch.equal(culled["kvalid"], valid)
    for k, v in full.items():
        if v is None or k == "cull":
            assert culled[k] is None, k
        elif k in ("inst_idx", "sel_a", "sel_b"):
            assert torch.equal(culled[k][valid], v[valid]), k
        elif k in ("tri", "tri_u", "tri_v"):
            assert torch.equal(culled[k][mesh], v[mesh]), k
        else:
            assert torch.equal(culled[k], v), k


def test_bf16_pad_keeps_the_column_a_bare_sphere_drops(frames):
    """Carpet's ray block 166 (bf16 slab operands) gives column 188 a valid
    interval beyond that box's bounding sphere: the bare fan test drops it
    while the set fits, so the culled tables would differ from the full
    ones.  The padded test (geometry.slab_pad) keeps it and every other hit
    column, the set still fits, and the culled and full tables are equal."""
    import chip_smoke

    from nerftex_torch.instancing import geometry

    dev, rays_o, rays_d, _, S, step = frames["carpet"]
    rb = dev.ray_block
    sl = slice(166 * rb, 167 * rb)
    args = chip_smoke.per_ray_args(dev, rays_o[sl], rays_d[sl], S, step)
    ds, K = dev.ds, args[4]
    assert dev.matmul_precision == "bfloat16"
    C, _ = pr.budgets(ds, K, dev.cull_budget, dev.tri_cull_budget)
    fan = geometry.block_fan(rays_o[sl], rays_d[sl])
    hits = torch.as_tensor(chip_smoke.per_ray_hit_columns(args)[0])
    bare = geometry.fan_keep(fan, ds.inst_center, ds.inst_radius)
    padded = geometry.fan_keep(fan, ds.inst_center, ds.inst_radius,
                               pr.inst_pad(ds, C, "bfloat16"))
    assert int(bare.sum()) <= C and not bare[188] and bool(hits.eq(188).any())
    assert bool(padded[hits].all()) and int(padded.sum()) <= C
    assert bool((padded | ~bare).all())
    trace.reset()
    with trace.recording():
        culled = pr.per_ray(*args)
    assert trace.totals()["cull.fit"] == 2
    trace.reset()
    full = pr.per_ray(*args[:7], 0, 0, "bfloat16")
    valid = full["kvalid"]
    assert torch.equal(culled["kvalid"], valid)
    for k in ("tk0", "tk1", "times_s", "cum_incl", "total", "n_steps", "hit"):
        assert torch.equal(culled[k], full[k]), k
    assert torch.equal(culled["inst_idx"][valid], full["inst_idx"][valid])


def test_slab_pad_holds_every_box_a_rounded_slab_test_hits():
    """Random boxes (turned, scaled 0.02-0.2 unevenly, within 2 of the
    origin) and rays from 20-40 away toward them, the slab test over
    bfloat16-rounded operands as per_ray_plain runs it: about a fifth of the
    valid intervals put the exact ray's point at the interval's middle
    outside the box's bounding sphere, and none outside the sphere widened
    by slab_pad's pad; float32 has no pad."""
    import numpy as np

    from nerftex_torch.instancing import geometry
    from nerftex_torch.models.encodings import round_operand

    assert geometry.slab_pad(1.7, "float32") is None
    rs = np.random.RandomState(5)
    n, m = 400, 2000
    rot = np.linalg.qr(rs.normal(size=(n, 3, 3)))[0]
    fwd = rot * rs.uniform(0.02, 0.2, (n, 1, 3))
    pos = rs.uniform(-2, 2, (n, 3))
    inv = np.linalg.inv(fwd)
    corners = np.array([[x, y, z] for x in (-.5, .5) for y in (-.5, .5) for z in (-.5, .5)])
    wc = np.einsum("nij,kj->nki", fwd, corners) + pos[:, None]
    cen = wc.mean(1)
    rad = np.linalg.norm(wc - cen[:, None], axis=-1).max(1)
    o = rs.normal(size=(m, 3))
    o *= rs.uniform(20, 40, (m, 1)) / np.linalg.norm(o, axis=1, keepdims=True)
    d = pos[rs.randint(0, n, m)] + rs.normal(0, 0.1, (m, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)

    f32 = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    inv_rot, inv_trans = f32(inv), f32(-np.einsum("nij,nj->ni", inv, pos))
    a, b = geometry.slab_pad(geometry.slab_kappa(inv_rot), "bfloat16")
    t0, t1 = torch.full((m, n), -float("inf")), torch.full((m, n), float("inf"))
    o_r, d_r = round_operand(f32(o), "bfloat16"), round_operand(f32(d), "bfloat16")
    for c in range(3):
        rot_c = round_operand(inv_rot[:, c, :].T, "bfloat16")
        o_lc, d_lc = o_r @ rot_c + inv_trans[:, c], d_r @ rot_c
        inv_dl = 1.0 / torch.where(d_lc.abs() < 1e-12, 1e-12, d_lc)
        t_a, t_b = (-0.5 - o_lc) * inv_dl, (0.5 - o_lc) * inv_dl
        t0 = torch.maximum(t0, torch.minimum(t_a, t_b))
        t1 = torch.minimum(t1, torch.maximum(t_a, t_b))
    r, col = ((t0 < t1) & (t1 > 0)).nonzero(as_tuple=True)
    t_mid = ((t0[r, col].clamp(min=0) + t1[r, col]) / 2).double()
    o64, d64, cen64, rho = (torch.tensor(x) for x in (o[r], d[r], cen[col], rad[col]))
    off = (o64 + t_mid[:, None] * d64 - cen64).norm(dim=-1)
    pad = a * (cen64.norm(dim=-1) + rho) + b * (o64.norm(dim=-1) + (cen64 - o64).norm(dim=-1)
                                                + rho)
    assert len(r) > 1000
    assert int((off > rho).sum()) > len(r) // 10
    assert bool((off <= rho + pad).all())


def test_a_tensor_count_is_read_with_the_counts():
    """A 0-d tensor counted while recording is added when the counts are
    read, under the span and unit it was counted in; reset drops it."""
    trace.reset()
    with trace.recording():
        with trace.span("outer"):
            trace.count("flags", torch.tensor(3, dtype=torch.int32))
            trace.count("flags", 2)
            trace.count("flags", torch.tensor(4))
    snap = trace.snapshot()
    assert trace.totals(snap)["flags"] == 9
    assert [c["span"] for c in snap["counts"]] == ["outer"]
    assert trace.totals()["flags"] == 9
    with trace.recording():
        trace.count("flags", torch.tensor(5))
    trace.reset()
    assert trace.totals() == {}
    trace.count("flags", torch.tensor(1))       # not recording: nothing kept
    assert trace.totals() == {}
