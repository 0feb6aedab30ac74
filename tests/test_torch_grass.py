"""The grass frame through nerftex_torch against the JAX package: its rays
(tests/torch_grass_inputs.npz's camera) equal the JAX test dataset's first
item; a small sorted frame of the grass scene (a point light whose
position the shadow pass takes as a direction, shadow rays, nearest picks,
a narrow ParamNerf with the same weights) rendered with the same key
matches JAX's; the point light's per-sample slots (direction toward the
light, inverse-square strength) and an auxiliary mesh's shaded terminator
(with and without shadow rays) match the JAX device instancer's."""

import importlib
import math
import os
import sys
import tempfile

import jax
import numpy as np
import pytest

import nerftex_tpu.models.mlp as jax_mlp
from nerftex_tpu.instancing.device import DeviceInstancer as JaxInstancer
from nerftex_tpu.instancing.scene import Scene as JaxScene
from nerftex_tpu.instancing.scene import SceneMesh as JaxMesh
from nerftex_tpu.tools import gen_assets
from nerftex_tpu.utils import rng
from nerftex_tpu.utils import util as jax_util
from nerftex_torch.instancing.device import DeviceInstancer
from nerftex_torch.instancing.scene import Scene, SceneMesh
from nerftex_torch.ops.rays import frame_rays
from nerftex_torch.render.checkpoint import flatten_params, load_jax_params
from nerftex_torch.utils import jax_rng, trace
from nerftex_torch.utils.util import instantiate

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _jax_reference import group, recorded  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULE = "test_torch_grass"
INPUTS = os.path.join(ROOT, "tests", "torch_grass_inputs.npz")
H = W = 24


def _rays(h, w):
    inp = np.load(INPUTS)
    angle = float(inp["angle"])
    proxy = importlib.import_module("configs.config_grass_render").config[
        "test_dataset_config"]["proxy_config"]
    return frame_rays(h, w, inp["eye"], angle, inp["parameters"], proxy["b_0"], proxy["b_1"],
                      focal=w / math.tan(angle / 2) / 2)


def test_grass_rays_equal_the_jax_dataset():
    cfg = importlib.import_module("configs.config_grass_render").config
    ds = jax_util.instantiate(jax_util.EasyDict(cfg["test_dataset_config"]))
    want = next(iter(ds))
    inp = np.load(INPUTS)
    assert (int(inp["height"]), int(inp["width"])) == (ds.height, ds.width) == (512, 512)
    got = _rays(512, 512)
    for k in ("rays_o", "rays_d", "t", "cone_scale", "parameters"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


def _model_cfg():
    def ff(n):
        return {"module": "network.model.FourierFeatures", "n_freq_bands": n}

    return {"module": "network.model.ParamNerf", "pos_embedding": ff(10),
            "dir_embedding": ff(4), "param_embedding": ff(4), "n_parameters": [1, 4],
            "depth": 3, "width": 64, "skips": [1]}


def _renderer_cfg():
    """configs/config_grass_render.py's renderer and instancer at the grass
    operating point, cut to 64-ray blocks and max_hits 32 (one hit tier)."""
    cfg = importlib.import_module("configs.config_grass_render").config["renderer_config"]
    inst = dict(cfg["instancer_config"],
                mesh_path=os.path.join(ROOT, cfg["instancer_config"]["mesh_path"]),
                patch_origins_path=os.path.join(ROOT,
                                                cfg["instancer_config"]["patch_origins_path"]),
                ray_block=64, max_hits=32, max_steps_per_ray=1024, cull_budget=512,
                tri_cull_budget=1024, shadow_cull_budget=512, shadow_tri_cull_budget=2048)
    return dict(cfg, instancer_config=inst, render_chunk=4096, net_chunk=8192,
                sorted_blocks=True)


def _jax_frame():
    """A narrow ParamNerf's JAX weights and the JAX frame of the rays with
    key(1)."""
    data = _rays(H, W)
    rng.set_seed(0)
    jax_mlp._INIT_COUNTER[0] = 0
    jm = jax_util.instantiate(jax_util.EasyDict(_model_cfg()))["model"]
    jr = jax_util.instantiate(jax_util.EasyDict(dict(_renderer_cfg(), model=jm)))
    out = jr(**data, training=False, key=jax.random.key(1))
    return {**{f"weights/{k}": v for k, v in flatten_params(
                jax.tree.map(np.asarray, jm.params)).items()},
            "color": np.asarray(out["color_pred"]), "alpha": np.asarray(out["alpha_pred"])}


@pytest.fixture(scope="module")
def frame():
    data = _rays(H, W)
    want = recorded(MODULE, "frame")
    tm = instantiate(_model_cfg(), device="cpu")
    load_jax_params(tm, group(want, "weights/"))
    return data, tm, (want["color"], want["alpha"])


def test_grass_frame_matches_jax_with_the_same_key(frame):
    data, tm, (c_j, a_j) = frame
    renderer = instantiate(dict(_renderer_cfg(), model=tm, device="cpu"))
    trace.reset()
    with trace.recording():
        out = renderer(**data, key=jax_rng.key(1))
    c_t, a_t = out["color_pred"].numpy(), out["alpha_pred"].numpy()
    assert renderer.instancer.device_instancer.ds.light_strength_idx == 1
    totals = trace.totals()
    assert sum(totals.get(f"shadow.{k}", 0) for k in ("skip", "culled", "full")) > 0
    assert c_t.shape == c_j.shape == (1, H * W, 3) and a_t.shape == a_j.shape == (1, H * W)
    assert a_j.max() > 0.5 and (a_j > 0.1).mean() > 0.1
    # tests/test_torch_plush.py's gates (float32 roundings and nearest
    # knife edges, see tests/test_torch_render.py).  Measured here: 104.0 dB,
    # no pixel above 1e-3, max error 2.2e-4.
    err = np.maximum(np.abs(c_t - c_j).max(-1), np.abs(a_t - a_j))
    mse = np.mean(np.concatenate([c_t - c_j, (a_t - a_j)[..., None]], -1) ** 2)
    assert 10 * np.log10(1 / mse) >= 60
    assert np.mean(err > 1e-3) <= 0.02
    assert err.max() <= 3e-2


def test_shadowed_samples_see_the_light_from_below_with_no_read(frame, monkeypatch):
    """The grass frame's sorted blocks: every sample whose arc-length
    bucket the shadow pass found blocked takes exactly [0, 0, -1] as its
    local light direction, the others their own, and no block reads the
    host for it (no sync.light_down span)."""
    import torch

    data, tm, _ = frame
    renderer = instantiate(dict(_renderer_cfg(), model=tm, device="cpu"))
    real = DeviceInstancer._per_sample_grid_tail
    seen = []

    def tail(self, ray, rays_d, parameters, inst, weight, s_arc, t_mu, pts_w):
        out = real(self, ray, rays_d, parameters, inst, weight, s_arc, t_mu, pts_w)
        blocked = ray["shadow_blocked"]
        bucket = torch.floor(s_arc / torch.clamp(ray["total"][:, None], min=1e-12)
                             * blocked.shape[-1]).long()
        shadowed = blocked.gather(1, torch.clamp(bucket, 0, blocked.shape[-1] - 1))
        li = self.ds.light_dir_idx
        seen.append((shadowed, out["parameters"][..., li:li + 3]))
        return out

    monkeypatch.setattr(DeviceInstancer, "_per_sample_grid_tail", tail)
    trace.reset()
    with trace.recording():
        renderer(**data, key=jax_rng.key(1))
    names = {s["name"] for s in trace.snapshot()["spans"]}
    trace.reset()
    assert seen and "sync.light_down" not in names and "sync.shadow_branch" in names
    shadowed = torch.cat([sh.reshape(-1) for sh, _ in seen])
    light = torch.cat([lt.reshape(-1, 3) for _, lt in seen])
    assert 0 < int(shadowed.sum()) < shadowed.numel()
    down = torch.tensor([0.0, 0.0, -1.0])
    assert (light[shadowed] == down).all()
    assert not (light[~shadowed] == down).all(-1).all()


def _jax_model_input(scene, rays_o, rays_d, params, n_samples, step, max_hits, ray_block):
    """get_model_input of the JAX device instancer under key(3)."""
    want = JaxInstancer(scene, max_hits=max_hits, ray_block=ray_block).get_model_input(
        rays_o, rays_d, params, n_samples, step, jax.random.key(3))
    return {k: np.asarray(v) for k, v in want.items()}


def _port_model_input(scene, rays_o, rays_d, params, n_samples, step, max_hits, ray_block):
    """get_model_input of the port's device instancer with the same key."""
    got = DeviceInstancer(scene, "cpu", max_hits=max_hits, ray_block=ray_block
                          ).get_model_input(rays_o, rays_d, params, n_samples, step,
                                            key=jax_rng.key(3))
    return {k: v.numpy() if hasattr(v, "numpy") else v for k, v in got.items()}


def _point_light_scene(scene_cls):
    scene = scene_cls(b_0=[-0.5, -0.5, -0.5], b_1=[0.5, 0.5, 0.5], textures=["point"])
    scene.add_instance(np.eye(4, dtype=np.float32))
    return scene


def _point_light_rays():
    rays_o = np.array([[0.0, 0.0, 5.0], [0.2, -0.1, 5.0]], np.float32)
    rays_d = np.tile(np.array([0, 0, -1.0], np.float32), (2, 1))
    params = np.array([[10.0, 0, 0, 3.0], [4.0, 0.3, 0.2, 2.0]], np.float32)
    return rays_o, rays_d, params


def _jax_point_light():
    want = _jax_model_input(_point_light_scene(JaxScene), *_point_light_rays(), 32, 0.1, 4, 2)
    return {k: want[k] for k in ("dists", "t", "parameters")}


def test_point_light_slots_match_jax():
    """tests/test_device_instancer.py's point-light scene: one box, a ray
    straight down, params [strength, light position]; the strength slot
    (10 / (4 pi d^2 + 1e-6)) and the light direction agree within 1e-5."""
    want = recorded(MODULE, "test_point_light_slots_match_jax")
    got = _port_model_input(_point_light_scene(Scene), *_point_light_rays(), 32, 0.1, 4, 2)
    n = (want["dists"] > 0).sum(-1)
    assert (n > 5).all()
    np.testing.assert_array_equal((got["dists"] > 0).sum(-1), n)
    valid = want["dists"] > 0
    np.testing.assert_allclose(got["t"][valid], want["t"][valid], rtol=0, atol=1e-5)
    # Measured: 1.5e-8 (the strength slot), the direction slots equal.
    np.testing.assert_allclose(got["parameters"][valid], want["parameters"][valid], rtol=0,
                               atol=1e-5)
    # The first ray: strength 10 / (4 pi d^2) toward the light at z = 3.
    z = 5.0 - want["t"][0, :n[0]]
    np.testing.assert_allclose(got["parameters"][0, :n[0], 0],
                               10.0 / (4 * np.pi * (3.0 - z) ** 2 + 1e-6), rtol=1e-4)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    out = tmp_path_factory.mktemp("meshes")
    gen_assets.generate(str(out), seed=0)
    return str(out)


def _aux_rays():
    rs = np.random.RandomState(0)
    rays_o = np.concatenate([rs.uniform(-0.9, 0.9, (16, 2)), np.full((16, 1), 5.0)],
                            -1).astype(np.float32)
    rays_d = np.tile(np.array([0, 0, -1.0], np.float32), (16, 1))
    params = np.tile(np.array([0.2, 0.1, 1.0], np.float32), (16, 1))
    return rays_o, rays_d, params


def _jax_aux_mesh(shadows):
    """The JAX device instancer's terminator color and alpha on the
    aux-mesh scene."""
    with tempfile.TemporaryDirectory() as assets:
        gen_assets.generate(assets, seed=0)
        want = _jax_model_input(_aux_scene(JaxScene, JaxMesh, assets, shadows), *_aux_rays(),
                                32, 0.1, 4, 8)
    return {k: want[k] for k in ("alpha_last", "color_last")}


def _aux_scene(scene_cls, mesh_cls, assets, shadows):
    scene = scene_cls(b_0=[-0.5, -0.5, -0.5], b_1=[0.5, 0.5, 0.5], textures=["light"],
                      cast_shadow_rays=shadows)
    scene.add_instance(np.eye(4, dtype=np.float32))
    scene.base_mesh = mesh_cls(
        np.array([[-9, -9, -9], [9, -9, -9], [9, 9, -9], [-9, 9, -9]], np.float32),
        np.array([[0, 1, 2], [0, 2, 3]], np.int32))
    scene.add_mesh(os.path.join(assets, "cloth_mesh.ply"),
                   os.path.join(assets, "checkerboard.png"))
    scene.aux_meshes[0].V[:, 2] -= 2.0
    return scene


@pytest.mark.parametrize("shadows", [False, True])
def test_aux_mesh_terminator_matches_jax(assets, shadows):
    """tests/test_device_instancer.py's aux-mesh setup (a patch box over a
    textured auxiliary cloth mesh 2 below, the base mesh far away): the
    terminator's color and alpha agree within 1e-5, with the occlusion
    query of aux-mesh terminator pixels when shadows are on (the box
    shadows some of the floor the rays see, not all of it)."""
    rays_o, rays_d, params = _aux_rays()
    want = recorded(MODULE, f"test_aux_mesh_terminator_matches_jax[{shadows}]")
    got = _port_model_input(_aux_scene(Scene, SceneMesh, assets, shadows), rays_o, rays_d,
                            params, 32, 0.1, 4, 8)
    assert (want["alpha_last"] == 1).all() and (want["color_last"] > 0).all()
    np.testing.assert_allclose(got["alpha_last"], want["alpha_last"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["color_last"], want["color_last"], rtol=0, atol=1e-5)
    if shadows:
        lit = DeviceInstancer(_aux_scene(Scene, SceneMesh, assets, False), "cpu", max_hits=4,
                              ray_block=8).get_model_input(rays_o, rays_d, params, 32, 0.1,
                                                           key=jax_rng.key(3))["color_last"]
        dark = (got["color_last"] < lit.numpy() - 1e-3).all(-1)[:, 0]
        assert dark.any() and not dark.all()


JAX_CASES = {
    "frame": _jax_frame,
    "test_point_light_slots_match_jax": _jax_point_light,
    **{f"test_aux_mesh_terminator_matches_jax[{shadows}]":
       (lambda shadows=shadows: _jax_aux_mesh(shadows)) for shadows in (False, True)},
}
