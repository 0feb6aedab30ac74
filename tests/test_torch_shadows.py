"""nerftex_torch's shadow pass against the JAX DeviceInstancer on the plush
scene (meshes/stanford_bunny.ply with vertex anchors, 1600 patches, the
checkerboard slot, a directional light, shadow rays): the scene tables are
equal, and the per-ray shadow_blocked table equals JAX's on rays of the
plush camera for each branch of the exact occlusion branch (skip, culled,
full), culled equal to full."""

import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerftex_tpu.instancing.device import DeviceInstancer as JaxDeviceInstancer
from nerftex_tpu.instancing.device import DeviceScene as JaxDeviceScene
from nerftex_tpu.instancing.scene import Scene as JaxScene
from nerftex_torch.instancing.instancer import Instancer
from nerftex_torch.ops.rays import frame_rays
from nerftex_torch.utils import jax_rng, trace

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _jax_reference import recorded  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULE = "test_torch_shadows"
MESH = os.path.join(ROOT, "meshes", "stanford_bunny.ply")
SCENE_KW = dict(
    b_0=[-1.1, -1.1, -0.2], b_1=[1.1, 1.1, 1.1], cast_shadow_rays=True,
    textures=["", os.path.join(ROOT, "meshes", "checkerboard.png"), "light"],
    jitter_amount=0.3, instance_sampling_method="nearest_blend", seed=0,
)
# The plush operating point's budgets at a 64-ray block.
DEV_KW = dict(max_hits=32, ray_block=64, max_steps_per_ray=1280, cull_budget=384,
              tri_cull_budget=1024, shadow_cull_budget=768, shadow_tri_cull_budget=1536)
STEP = 0.0005
BLOCK = 64


def plush_rays(h, w):
    """The plush frame's camera (tests/torch_plush_inputs.npz) at h x w."""
    inp = np.load(os.path.join(ROOT, "tests", "torch_plush_inputs.npz"))
    angle = float(inp["angle"])
    return frame_rays(h, w, inp["eye"], angle, inp["parameters"], (-0.9, -0.6, -0.8),
                      (0.9, 0.8, 0.9), focal=w / math.tan(angle / 2) / 2)


def _jax_scene():
    js = JaxScene(**SCENE_KW)
    js.distribute_instances_on_mesh(MESH, 0.04, "")
    return js


def _rays():
    """Four 64-ray blocks of a 32x32 plush frame: two rows of sky (no arc:
    the skip branch) and three across the bunny."""
    data = plush_rays(32, 32)
    idx = np.concatenate([np.arange(b * BLOCK, (b + 1) * BLOCK) for b in (0, 4, 7, 10)])
    o, d = data["rays_o"][0][idx], data["rays_d"][0][idx]
    p = np.repeat(data["parameters"], len(idx), 0)
    return o, d, p


@pytest.fixture(scope="module")
def setup():
    inst = Instancer(mesh_path=MESH, patch_scale=0.04, device="cpu", **SCENE_KW, **DEV_KW)
    return _jax_scene(), inst, _rays()


def test_vertex_anchor_scene_tables_equal(setup):
    js, inst, _ = setup
    ts = inst.scene
    assert ts.n_instances() == js.n_instances() == 1600
    for k in ("forward", "inverse", "dir_inverse", "origins", "anchor_uv", "uv_jacobian",
              "texture_channels"):
        np.testing.assert_array_equal(np.asarray(getattr(ts, k)), np.asarray(getattr(js, k)),
                                      err_msg=k)
    jds, tds = JaxDeviceScene(js), inst.device_instancer.ds
    for k in ("inv_rot", "inv_trans", "origins", "tri_v0", "tri_e1", "tri_e2", "tri_center",
              "tri_radius", "inst_center", "inst_radius"):
        np.testing.assert_array_equal(getattr(tds, k).numpy(), np.asarray(getattr(jds, k)),
                                      err_msg=k)
    assert tds.n_tris == jds.n_tris == 3120
    assert tds.cast_shadow_rays and tds.nearest_blend_range == jds.nearest_blend_range


def _jax_shadow_blocked():
    """The JAX per-ray stage's shadow_blocked table of each 64-ray block."""
    jd = JaxDeviceInstancer(_jax_scene(), **DEV_KW)
    o, d, p = _rays()
    jax_per_ray = jax.jit(lambda o, d, p: jd._per_ray(o, d, p, 1280, STEP, jax.random.key(0)))
    return {f"block/{i}": np.asarray(jax_per_ray(jnp.asarray(o[i:i + BLOCK]),
                                                 jnp.asarray(d[i:i + BLOCK]),
                                                 jnp.asarray(p[i:i + BLOCK]))["shadow_blocked"])
            for i in range(0, len(o), BLOCK)}


def test_shadow_blocked_matches_jax_on_every_branch(setup):
    _, inst, (o, d, p) = setup
    td = inst.device_instancer
    recording = recorded(MODULE, "test_shadow_blocked_matches_jax_on_every_branch")
    branches = set()
    for i in range(0, len(o), BLOCK):
        sl = slice(i, i + BLOCK)
        want = recording[f"block/{i}"]
        args = (torch.tensor(o[sl]), torch.tensor(d[sl]), torch.tensor(p[sl]), 1280, STEP,
                torch.full((BLOCK,), 0.5))
        trace.reset()
        with trace.recording():
            culled = td._per_ray(*args)
        totals = trace.totals()
        taken = [k for k in ("skip", "culled", "full") if totals.get(f"shadow.{k}", 0)]
        budgets = (td.shadow_cull_budget, td.shadow_tri_cull_budget)
        td.shadow_cull_budget = td.shadow_tri_cull_budget = 0
        try:
            full = td._per_ray(*args)["shadow_blocked"]
        finally:
            td.shadow_cull_budget, td.shadow_tri_cull_budget = budgets
        got = culled["shadow_blocked"]
        assert got.shape == (BLOCK, td.shadow_samples) and got.dtype == torch.bool
        # The culled branch is exact: equal to the full query.
        assert torch.equal(got, full)
        np.testing.assert_array_equal(got.numpy(), want)
        assert len(taken) == 1 and (taken[0] == "skip") == (not (culled["total"] > 0).any())
        branches.add(taken[0])
    assert branches == {"skip", "culled", "full"}, branches
    assert 50 < int(got.sum()) < got.numel()


def _jax_dense_grid():
    """The JAX dense grid's model inputs under key(3) that the test reads."""
    jd = JaxDeviceInstancer(_jax_scene(), **DEV_KW)
    o, d, p = _rays()
    want = jd.get_model_input(o, d, p, 320, 4 * STEP, key=jax.random.key(3))
    return {k: np.asarray(want[k]) for k in ("hit", "dists", "instance_id", "alpha_weight")}


def test_dense_grid_with_a_key_matches_jax(setup):
    """The dense grid path under a key: block b's offsets and pick uniforms
    are JAX's (split(fold_in(key, b))), so instance picks agree except on
    nearest_blend cum knife edges, and the density weights 1 / p_sel agree
    where the picks do.  A blend weight cancels distances twice, so the
    last-ulp differences left between the two (world t, arc lengths) move
    a few: measured 0.17 % of samples beyond rtol 1e-3 (the JAX suite's
    blend-weight pin), none beyond 8.3e-3."""
    _, inst, (o, d, p) = setup
    want = recorded(MODULE, "test_dense_grid_with_a_key_matches_jax")
    # A coarser grid than plush's keeps the dense [Rb, S, K] planes small.
    got = inst.device_instancer.get_model_input(o, d, p, 320, 4 * STEP, key=jax_rng.key(3))
    valid = got["dists"].numpy() > 0
    assert valid.sum() > 1000
    np.testing.assert_array_equal(got["hit"].numpy(), np.asarray(want["hit"]))
    np.testing.assert_array_equal(valid, np.asarray(want["dists"]) > 0)
    same = got["instance_id"].numpy() == np.asarray(want["instance_id"])
    assert (~same[valid]).mean() < 1e-3
    ok = same & valid
    w_t, w_j = got["alpha_weight"].numpy()[ok], np.asarray(want["alpha_weight"])[ok]
    rel = np.abs(w_t - w_j) / np.abs(w_j)
    assert np.mean(rel > 1e-3) < 5e-3
    assert rel.max() < 2e-2


def test_sorted_hit_tiers_equal_the_dense_grid(setup):
    """With K >= 64 each sorted block runs at its hit tier (its tables cut
    to the first 8, K/4 or K slots, as the JAX package's render_grid_sorted
    does): the nearest picks, shadowed light directions and every other
    model input equal the dense grid's over all K slots."""
    _, _, (o, d, p) = setup
    inst = Instancer(mesh_path=MESH, patch_scale=0.04, device="cpu",
                     **dict(SCENE_KW, instance_sampling_method="nearest"),
                     **dict(DEV_KW, max_hits=64, deterministic_offset=True))
    td = inst.device_instancer
    keys = ("pts", "rays_d", "t", "dists", "parameters", "instance_id", "alpha_weight")
    def shade_block(blk, extra, key):
        valid = blk["dists"] > 0
        out = []
        for k in keys:
            m = valid if blk[k].dim() == 2 else valid[..., None]
            v = torch.where(m, blk[k], torch.zeros_like(blk[k]))
            out.append(torch.nn.functional.pad(v, [0, 0] * (v.dim() - 2) + [0, 320 - v.shape[1]]))
        return tuple(out)

    # A coarser grid than plush's keeps the dense [Rb, S, K] planes small.
    sorted_out, _ = td.render_grid_sorted(o, d, p, 320, 4 * STEP, shade_block,
                                          key=jax_rng.key(3))
    dense = td.get_model_input(o, d, p, 320, 4 * STEP, key=jax_rng.key(3))
    valid = dense["dists"] > 0
    for k, got in zip(keys, sorted_out):
        m = valid if dense[k].dim() == 2 else valid[..., None]
        assert torch.equal(got, torch.where(m, dense[k], torch.zeros_like(dense[k]))), k
    # The sorted blocks that shade run at more than one tier.
    ray = td._per_ray(torch.tensor(o), torch.tensor(d), torch.tensor(p), 320, 4 * STEP,
                      torch.full((len(o),), 0.5))
    order = torch.argsort(ray["n_steps"], descending=True, stable=True)
    hits = ray["kvalid"].sum(-1)[order].reshape(-1, BLOCK).max(-1).values
    steps = ray["n_steps"][order].reshape(-1, BLOCK)[:, 0]
    tiers = {min(t for t in (8, 16, 64) if t >= h) for h, s in zip(hits.tolist(), steps.tolist())
             if s > 0}
    assert len(tiers) > 1, tiers


JAX_CASES = {
    "test_shadow_blocked_matches_jax_on_every_branch": _jax_shadow_blocked,
    "test_dense_grid_with_a_key_matches_jax": _jax_dense_grid,
}
