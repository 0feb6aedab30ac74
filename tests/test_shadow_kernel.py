"""nerftex_torch/kernels/shadow_query.py on the CPU: its plain chain equals
the JAX package's ``DeviceInstancer._shadow_query`` on the shadow points of
a block of the grass and of the plush frame (the cameras of
tests/torch_grass_inputs.npz and tests/torch_plush_inputs.npz, each scene
at its operating point's shadow budgets), over the culled candidates and
over every column; the wrapper refuses what the kernel cannot take before
any launch; and a CPU query never launches the kernel.  The kernel itself
is held bit-equal to the plain chain on the card (tests/test_torch_cuda.py)."""

import importlib
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerftex_tpu.utils import util as jax_util
from nerftex_torch import operating_points
from nerftex_torch.instancing import device as device_module
from nerftex_torch.kernels import shadow_query as sq
from nerftex_torch.ops.rays import frame_rays
from nerftex_torch.utils import trace
from nerftex_torch.utils.util import instantiate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# A 32-ray block of a 64 x 64 frame (32 shadow points a ray) keeps the JAX
# side's [points, columns] planes small; at row 40 both scenes' swept-cone
# candidates fit their budgets (grass 396 of 900 instances and 1,132 of
# 4,418 triangles, plush 607 of 1,600 and 1,094 of 3,120), so the block
# takes the culled branch.
H = W = 64
BLOCK = 32
START = 40 * W


def _instancer_config(scene):
    cfg = importlib.import_module(f"configs.config_{scene}_render").config
    inst = dict(cfg["renderer_config"]["instancer_config"])
    for k in ("mesh_path", "patch_origins_path"):
        if inst.get(k):
            inst[k] = os.path.join(ROOT, inst[k])
    inst["textures"] = [os.path.join(ROOT, t) if t.endswith(".png") else t
                        for t in inst["textures"]]
    point = operating_points.resolve(scene)["instancer"]
    inst.update(ray_block=BLOCK, shadow_cull_budget=point["shadow_cull_budget"],
                shadow_tri_cull_budget=point["shadow_tri_cull_budget"])
    return cfg, inst


@pytest.fixture(scope="module", params=["grass", "plush"])
def captured(request):
    """The scene's JAX DeviceInstancer and the port's shadow query inputs
    (points, light directions, tables, candidates) of one ray block."""
    scene = request.param
    cfg, inst = _instancer_config(scene)
    jd = jax_util.instantiate(jax_util.EasyDict(inst)).device
    td = instantiate(dict(inst, device="cpu")).device_instancer
    npz = np.load(os.path.join(ROOT, "tests", f"torch_{scene}_inputs.npz"))
    angle = float(npz["angle"])
    proxy = cfg["test_dataset_config"]["proxy_config"]
    data = frame_rays(H, W, npz["eye"], angle, npz["parameters"], proxy["b_0"], proxy["b_1"],
                      focal=W / math.tan(angle / 2) / 2)
    rows = slice(START, START + BLOCK)
    o = torch.tensor(data["rays_o"][0][rows])
    d = torch.tensor(data["rays_d"][0][rows])
    p = torch.tensor(np.repeat(data["parameters"], BLOCK, 0))
    calls = []
    real = device_module.shadow_query

    def spy(*args):
        calls.append(args)
        return real(*args)

    device_module.shadow_query = spy
    try:
        td._per_ray(o, d, p, 1024, 0.001, torch.full((BLOCK,), 0.5))
    finally:
        device_module.shadow_query = real
    assert len(calls) == 1, f"{scene}: the block's shadow query ran {len(calls)} times"
    return scene, jd, calls[0]


@pytest.mark.parametrize("branch", ["culled", "full"])
def test_plain_query_equals_the_jax_query(captured, branch):
    scene, jd, (pts, light, boxes, tris, bounds, inst_sel, tri_sel) = captured
    assert inst_sel is not None and tri_sel is not None, f"{scene}: the block took the full branch"
    if branch == "full":
        inst_sel = tri_sel = None
    got = sq.shadow_query_plain(pts, light, boxes, tris, bounds, inst_sel, tri_sel)

    def jax_sel(sel):
        return None if sel is None else (jnp.asarray(sel[0].numpy()), jnp.asarray(sel[1].numpy()))

    want = np.asarray(jd._shadow_query(jnp.asarray(pts.numpy()), jnp.asarray(light.numpy()),
                                       jax_sel(inst_sel), jax_sel(tri_sel)))
    assert got.shape == (BLOCK * 32,) and got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    # Some of the block's points are shadowed, not all.
    assert 0 < int(got.sum()) < got.numel(), (scene, int(got.sum()))
    if branch == "culled":
        # The culled branch is exact: equal to the query over every column.
        assert torch.equal(got, sq.shadow_query_plain(pts, light, boxes, tris, bounds))


def _request(**bad):
    """A query on meta tensors (shapes and dtypes, no data), with ``bad``
    replacing one of its inputs."""
    meta = dict(device="meta")
    args = {"pts": torch.empty(100, 3, **meta), "light_dir": torch.empty(100, 3, **meta),
            "inv_rot": torch.empty(7, 3, 3, **meta), "inv_trans": torch.empty(7, 3, **meta),
            "v0": torch.empty(5, 3, **meta), "b_0": torch.empty(3, **meta),
            "inst_ids": torch.empty(4, dtype=torch.int64, **meta),
            "inst_valid": torch.empty(4, dtype=torch.bool, **meta)}
    args.update(bad)
    tris = (args["v0"],) + tuple(torch.empty(5, 3, **meta) for _ in range(3))
    return (args["pts"], args["light_dir"], (args["inv_rot"], args["inv_trans"]), tris,
            (args["b_0"], torch.empty(3, **meta)), (args["inst_ids"], args["inst_valid"]), None)


REFUSED = {
    "float64 points": (TypeError, dict(pts=torch.empty(100, 3, dtype=torch.float64,
                                                       device="meta"))),
    "int32 ids": (TypeError, dict(inst_ids=torch.empty(4, dtype=torch.int32, device="meta"))),
    "uint8 valid": (TypeError, dict(inst_valid=torch.empty(4, dtype=torch.uint8,
                                                           device="meta"))),
    "light of other rows": (ValueError, dict(light_dir=torch.empty(99, 3, device="meta"))),
    "flat rotations": (ValueError, dict(inv_rot=torch.empty(7, 9, device="meta"))),
    "translations of other rows": (ValueError, dict(inv_trans=torch.empty(6, 3, device="meta"))),
    "triangles of four coordinates": (ValueError, dict(v0=torch.empty(5, 4, device="meta"))),
    "a box of two bounds": (ValueError, dict(b_0=torch.empty(2, device="meta"))),
    "valid of other length": (ValueError, dict(inst_valid=torch.empty(5, dtype=torch.bool,
                                                                      device="meta"))),
    "strided points": (ValueError, dict(pts=torch.empty(3, 100, device="meta").T)),
    "strided light": (ValueError, dict(light_dir=torch.empty(100, 6, device="meta")[:, :3])),
    "no CUDA device": (ValueError, {}),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_the_wrapper_refuses_what_the_kernel_cannot_take(case):
    """Meta tensors stand in for a CUDA request: the checks of dtype, shape,
    contiguity and device come before any build or launch."""
    error, bad = REFUSED[case]
    before = sq.shadow_query.launches
    with pytest.raises(error):
        sq.shadow_query(*_request(**bad))
    assert sq.shadow_query.launches == before


def test_a_cpu_query_runs_the_plain_chain_and_launches_nothing():
    rs = np.random.RandomState(0)
    pts = torch.tensor(rs.uniform(-1, 1, (50, 3)).astype(np.float32))
    light = torch.tensor(rs.normal(size=(50, 3)).astype(np.float32))
    boxes = (torch.tensor(np.tile(np.eye(3, dtype=np.float32), (3, 1, 1))),
             torch.tensor(rs.uniform(-1, 1, (3, 3)).astype(np.float32)))
    tris = tuple(torch.tensor(rs.uniform(-1, 1, (4, 3)).astype(np.float32)) for _ in range(4))
    bounds = (torch.tensor([-0.5, -0.5, -0.5]), torch.tensor([0.5, 0.5, 0.5]))
    trace.reset()
    with trace.recording():
        got = sq.shadow_query(pts, light, boxes, tris, bounds)
    totals = trace.totals()
    trace.reset()
    assert sq.shadow_query.launches == 0
    assert torch.equal(got, sq.shadow_query_plain(pts, light, boxes, tris, bounds))
    assert totals["shadow.points"] == 50 and "shadow.kernel" not in totals
