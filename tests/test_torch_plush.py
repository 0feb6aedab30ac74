"""The plush frame through nerftex_torch against the JAX package: its rays
(tests/torch_plush_inputs.npz's camera) equal the JAX test dataset's first
item, and a small sorted frame of the plush scene (shadow rays,
nearest_blend, a narrow ParamNerf with the same weights) rendered with the
same key, matches JAX's (the JAX package with its plain pick chain; the
port's config keeps the plush operating point's pallas_selk, which the port
accepts and ignores)."""

import importlib
import math
import os
import sys

import jax
import numpy as np
import pytest

import nerftex_tpu.models.mlp as jax_mlp
from nerftex_tpu.utils import rng
from nerftex_tpu.utils import util as jax_util
from nerftex_torch.ops.rays import frame_rays
from nerftex_torch.render.checkpoint import flatten_params, load_jax_params
from nerftex_torch.utils import jax_rng, trace
from nerftex_torch.utils.util import instantiate

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _jax_reference import group, recorded  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULE = "test_torch_plush"
INPUTS = os.path.join(ROOT, "tests", "torch_plush_inputs.npz")
H = W = 24
PROXY = ((-0.9, -0.6, -0.8), (0.9, 0.8, 0.9))


def _rays(h, w):
    inp = np.load(INPUTS)
    angle = float(inp["angle"])
    return frame_rays(h, w, inp["eye"], angle, inp["parameters"], *PROXY,
                      focal=w / math.tan(angle / 2) / 2)


def test_plush_rays_equal_the_jax_dataset():
    cfg = importlib.import_module("configs.config_plush_render").config
    ds = jax_util.instantiate(jax_util.EasyDict(cfg["test_dataset_config"]))
    want = next(iter(ds))
    inp = np.load(INPUTS)
    assert (int(inp["height"]), int(inp["width"])) == (ds.height, ds.width) == (800, 800)
    got = _rays(800, 800)
    for k in ("rays_o", "rays_d", "t", "cone_scale", "parameters"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


def _model_cfg():
    def ff(n):
        return {"module": "network.model.FourierFeatures", "n_freq_bands": n}

    return {"module": "network.model.ParamNerf", "pos_embedding": ff(10),
            "dir_embedding": ff(4), "param_embedding": ff(4), "n_parameters": [1, 4],
            "depth": 3, "width": 64, "skips": [1]}


def _renderer_cfg(pallas_selk):
    """configs/config_plush_render.py's renderer and instancer at the plush
    operating point, cut to 64-ray blocks and max_hits 32 (one hit tier)."""
    return {
        "module": "network.renderer.InstanceRenderer",
        "n_samples": 1280, "render_chunk": 4096, "net_chunk": 8192, "step_size": 0.0005,
        "density_reweighting": True, "sorted_blocks": True,
        "instancer_config": {
            "module": "instancer.instancer.Instancer",
            "b_0": [-1.1, -1.1, -0.2], "b_1": [1.1, 1.1, 1.1], "cast_shadow_rays": True,
            "textures": ["", os.path.join(ROOT, "meshes", "checkerboard.png"), "light"],
            "mesh_path": os.path.join(ROOT, "meshes", "stanford_bunny.ply"),
            "patch_scale": 0.04, "jitter_amount": 0.3,
            "instance_sampling_method": "nearest_blend",
            "max_hits": 32, "ray_block": 64, "max_steps_per_ray": 1280,
            "cull_budget": 384, "tri_cull_budget": 1024, "shadow_cull_budget": 768,
            "shadow_tri_cull_budget": 1536, "pallas_selk": pallas_selk,
        },
    }


def _jax_frame():
    """A narrow ParamNerf's JAX weights and the JAX frame of the rays with
    key(1)."""
    data = _rays(H, W)
    rng.set_seed(0)
    jax_mlp._INIT_COUNTER[0] = 0
    jm = jax_util.instantiate(jax_util.EasyDict(_model_cfg()))["model"]
    jr = jax_util.instantiate(jax_util.EasyDict(dict(_renderer_cfg(False), model=jm)))
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


def test_plush_frame_matches_jax_with_the_same_key(frame):
    data, tm, (c_j, a_j) = frame
    renderer = instantiate(dict(_renderer_cfg(True), model=tm, device="cpu"))
    trace.reset()
    with trace.recording():
        out = renderer(**data, key=jax_rng.key(1))
    c_t, a_t = out["color_pred"].numpy(), out["alpha_pred"].numpy()
    totals = trace.totals()
    assert totals.get("shadow.culled", 0) > 0 and totals.get("shadow.skip", 0) > 0
    assert c_t.shape == c_j.shape == (1, H * W, 3) and a_t.shape == a_j.shape == (1, H * W)
    assert a_j.max() > 0.5 and (a_j > 0.1).mean() > 0.1
    # tests/test_torch_render.py's gates.  Both draw the same numbers; the
    # frames differ where float32 roundings differ (see there) and where a
    # nearest_blend pick sits on a cum knife edge.  Measured here:
    # 78.02 dB, 0.52 % of pixels above 1e-3, max error 2.2e-3.
    err = np.maximum(np.abs(c_t - c_j).max(-1), np.abs(a_t - a_j))
    mse = np.mean(np.concatenate([c_t - c_j, (a_t - a_j)[..., None]], -1) ** 2)
    assert 10 * np.log10(1 / mse) >= 60
    assert np.mean(err > 1e-3) <= 0.02
    assert err.max() <= 3e-2


JAX_CASES = {"frame": _jax_frame}
