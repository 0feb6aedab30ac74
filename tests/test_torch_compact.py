"""nerftex_torch's compact path (sample_budget_per_ray > 0) against the JAX
package's on the CPU, with the port's kernels on their plain versions:
DeviceInstancer.get_model_input_compact for the three overlap methods at a
covering and a dropping budget, with jacobian textures, a light and shadow
rays, and with the exact closest-point texture lookup; InstanceRenderer and
MipInstanceRenderer on the compact and sorted paths with density noise and
false colors; the compact frame against the port's own grid frame; and the
Instancer's reference API over keyless calls.

The scene is the carpet (cloth mesh, 900 patches, checkerboard, directional
light) on 64 rays of the bench view in 32-ray blocks at step 0.008: its two
blocks need 1,274 and 1,150 samples, so a budget of 40 per ray covers them
and 24 drops 1,274 - 768 + 1,150 - 768 deepest samples."""

import contextlib
import copy
import importlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerftex_tpu.models.mlp as jax_mlp
from nerftex_tpu.instancing.device import DeviceInstancer as JaxDeviceInstancer
from nerftex_tpu.instancing.instancer import Instancer as JaxInstancer
from nerftex_tpu.instancing.scene import Scene as JaxScene
from nerftex_tpu.utils import rng as jax_streams
from nerftex_tpu.utils import util as jax_util
from nerftex_torch.instancing.device import DeviceInstancer, _closest_point_tri
from nerftex_torch.instancing.instancer import Instancer
from nerftex_torch.models import mlp as port_mlp
from nerftex_torch.ops.rays import frame_rays
from nerftex_torch.render.checkpoint import flatten_params, load_jax_params
from nerftex_torch.utils import jax_rng, rng
from nerftex_torch.utils.util import instantiate

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _jax_reference import group, recorded  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULE = "test_torch_compact"
MESH = os.path.join(ROOT, "meshes", "cloth_mesh.ply")
ANCHORS = os.path.join(ROOT, "meshes", "cloth_anchor_points.ply")
SCENE_KW = dict(
    b_0=[-1.4, -1.2, -0.1], b_1=[1.2, 1.2, 1.8],
    textures=[os.path.join(ROOT, "meshes", "smooth_checkerboard.png"), "", "", "", "light"],
    jitter_amount=1.0, seed=0,
)
DEV_KW = dict(max_hits=16, ray_block=32, max_steps_per_ray=320, cull_budget=448,
              tri_cull_budget=384)
N_SAMPLES, STEP = 1024, 0.008
COVER, DROP = 40, 24
BLOCK_SAMPLES = (1274, 1150)
FRAME_TOL = 1e-5      # color and alpha, the port's renders vs the JAX package's


def _rays():
    """64 rays of the 512x512 bench view, an 8x8 grid over the carpet."""
    data = frame_rays(512, 512, np.array([0.47, -0.65, 0.6]) * 6.0, 0.55,
                      [1, 1, 1, 0.1, 0, 0, 1.0])
    rows, cols = np.meshgrid(np.arange(200, 328, 16), np.arange(180, 308, 16), indexing="ij")
    idx = (rows * 512 + cols).reshape(-1)
    o, d = data["rays_o"][0][idx], data["rays_d"][0][idx]
    return o, d, np.repeat(data["parameters"], len(idx), 0)


_INSTANCERS = {}


def _instancer(method="nearest", shadows=False, lookup="jacobian"):
    """The port's device instancer of the carpet scene (cached)."""
    key = (method, shadows, lookup)
    if key not in _INSTANCERS:
        kw = dict(SCENE_KW, instance_sampling_method=method, cast_shadow_rays=shadows)
        inst = Instancer(mesh_path=MESH, patch_scale=0.09, patch_origins_path=ANCHORS,
                         device="cpu", **kw, **DEV_KW)
        _INSTANCERS[key] = DeviceInstancer(inst.scene, torch.device("cpu"),
                                           texture_lookup=lookup, **DEV_KW)
    return _INSTANCERS[key]


def _jax_instancer(method="nearest", shadows=False, lookup="jacobian"):
    """The JAX package's device instancer of the carpet scene."""
    js = JaxScene(**dict(SCENE_KW, instance_sampling_method=method, cast_shadow_rays=shadows))
    js.distribute_instances_on_mesh(MESH, 0.09, ANCHORS)
    return JaxDeviceInstancer(js, texture_lookup=lookup, **DEV_KW)


def _jax_compact(method, budget, shadows=False, lookup="jacobian"):
    """JAX's get_model_input_compact of _rays() under key(0); with the
    closest lookup also its dense grid's model input ("grid/<name>") and
    the instancer's k_tri."""
    jd = _jax_instancer(method, shadows, lookup)
    o, d, p = _rays()
    out = {k: np.asarray(v) for k, v in jd.get_model_input_compact(
        o, d, p, N_SAMPLES, STEP, budget, key=jax.random.key(0)).items()}
    if lookup == "closest":
        jg = jd.get_model_input(o, d, p, N_SAMPLES, STEP, key=jax.random.key(0))
        out.update({f"grid/{k}": np.asarray(jg[k]) for k in ("instance_id", "parameters")})
        out["k_tri"] = np.asarray(jd.ds.k_tri)
    return out


def _assert_float(got, want, name, ulps=8, scale=None, mask=None):
    """Within ``ulps`` float32 ulps of ``scale`` (default: the largest
    magnitude in ``want``, at least 1), over ``mask``."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    if mask is not None:
        got, want = got[mask], want[mask]
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want), err_msg=name)
    fin = np.isfinite(want)
    if scale is None:
        scale = max(1.0, float(np.abs(want[fin]).max())) if fin.any() else 1.0
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=ulps * 2**-23 * scale,
                               err_msg=name)


def _blend_edges(td, o, d, ray_idx, t, u):
    """For compacted samples (global ray_idx, world t, pick uniform u): the
    distance of u from the nearest value of the nearest_blend pick's
    cumulative distribution over the active intervals, in float64."""
    ray = td._per_ray(torch.tensor(o), torch.tensor(d), torch.zeros(len(o), 7), 320, STEP,
                      torch.full((len(o),), 0.5))
    tk0, tk1 = ray["tk0"].double().numpy()[ray_idx], ray["tk1"].double().numpy()[ray_idx]
    kv = ray["kvalid"].numpy()[ray_idx]
    c = td.ds.origins.double().numpy()[ray["inst_idx"].numpy()[ray_idx]]
    p = o[ray_idx].astype(np.float64) + d[ray_idx].astype(np.float64) * t[:, None]
    active = kv & (tk0 <= t[:, None]) & (t[:, None] < tk1)
    dist = np.where(active, np.linalg.norm(p[:, None] - c, axis=-1), np.inf)
    w = np.where(active, np.maximum(td.ds.nearest_blend_range + dist.min(-1, keepdims=True)
                                    - dist, 0.0), 0.0)
    cum = np.cumsum(w / np.maximum(w.sum(-1, keepdims=True), 1e-20), -1)
    return np.abs(u[:, None] - cum).min(-1)


def _u_sel(budget, n_blocks, key):
    """The compact path's pick uniforms: uniform(split(fold_in(key, b))[1],
    (budget * 32,)) for each block b, as JAX draws them."""
    return np.concatenate([np.asarray(jax.random.uniform(
        jax.random.split(jax.random.fold_in(key, b))[1], (budget * 32,))) for b in range(n_blocks)])


def _compare_compact(jo, to, td, o, d, method, budget, ties=None):
    """Discrete outputs equal (nearest_blend's cum knife edges apart),
    floats within the grid path's ulp-scaled tolerances (the parameters
    not on samples flagged in ``ties``)."""
    for k in ("taken", "ray_idx", "i_idx", "hit"):
        np.testing.assert_array_equal(to[k].numpy(), np.asarray(jo[k]), err_msg=k)
    for k in ("overflow_hits", "overflow_steps"):
        assert int(to[k]) == int(jo[k]), k
    taken = to["taken"].numpy()
    got_id, want_id = to["instance_id"].numpy(), np.asarray(jo["instance_id"])
    mism = (got_id != want_id) & taken
    if method != "nearest_blend":
        assert not mism.any(), f"{method}: {mism.sum()} picks differ"
    elif mism.any():
        assert mism.sum() <= 1e-3 * taken.sum()
        u = _u_sel(budget, len(o) // 32, jax.random.key(0))
        edge = _blend_edges(td, o, d, to["ray_idx"].numpy()[mism],
                            np.asarray(jo["t"])[mism].astype(np.float64), u[mism])
        assert (edge <= 1e-4).all(), edge
    same = taken & ~mism
    t_scale = float(np.abs(np.asarray(jo["t"])).max())
    for k in ("t", "dists_c"):
        _assert_float(to[k].numpy(), jo[k], k, scale=t_scale, mask=taken)
    _assert_float(to["dists"].numpy(), jo["dists"], "dists", scale=t_scale)
    for k in ("color_last", "alpha_last"):
        _assert_float(to[k].numpy(), jo[k], k)
    # Local frames multiply world coordinates (|x| ~ 4) by 1/patch_scale.
    for k in ("pts", "rays_d", "parameters"):
        _assert_float(to[k].numpy(), jo[k], k, ulps=64,
                      mask=same if k != "parameters" or ties is None else same & ~ties)
    w_t, w_j = to["alpha_weight"].numpy()[same], np.asarray(jo["alpha_weight"])[same]
    if method == "nearest_blend":
        # 1 / p_sel: a blend weight cancels distances twice
        # (tests/test_torch_shadows.py's limits).
        rel = np.abs(w_t - w_j) / np.abs(w_j)
        assert np.mean(rel > 1e-3) < 5e-3 and rel.max() < 2e-2
    else:
        _assert_float(w_t, w_j, "alpha_weight")


@pytest.mark.parametrize("budget", [COVER, DROP])
@pytest.mark.parametrize("method", ["random", "nearest", "nearest_blend"])
def test_compact_model_input_matches_jax(method, budget):
    td = _instancer(method)
    o, d, p = _rays()
    jo = recorded(MODULE, f"test_compact_model_input_matches_jax[{method}-{budget}]")
    to = td.get_model_input_compact(o, d, p, N_SAMPLES, STEP, budget, key=jax_rng.key(0))
    _compare_compact(jo, to, td, o, d, method, budget)
    # Each block takes min(its samples, its budget); the rest are dropped.
    taken = to["taken"].reshape(2, budget * 32).sum(-1).tolist()
    assert taken == [min(n, budget * 32) for n in BLOCK_SAMPLES]
    assert int(to["overflow_steps"]) == sum(max(n - budget * 32, 0) for n in BLOCK_SAMPLES)


def test_compact_with_textures_light_and_shadows_matches_jax():
    """The jacobian texture lookup, the directional light and shadow rays
    (each sample takes its arc-length bucket's occlusion) on the compact
    path, as the JAX suite's test_compact_matches_dense_with_textures_and_light
    covers textures and light."""
    td = _instancer("nearest", shadows=True)
    o, d, p = _rays()
    jo = recorded(MODULE, "test_compact_with_textures_light_and_shadows_matches_jax")
    to = td.get_model_input_compact(o, d, p, N_SAMPLES, STEP, COVER, key=jax_rng.key(0))
    _compare_compact(jo, to, td, o, d, "nearest", COVER)
    # Some samples are shadowed: their light slots point straight down.
    down = (to["parameters"][:, 4:7] == torch.tensor([0.0, 0.0, -1.0])).all(-1) & to["taken"]
    assert 0 < int(down.sum()) < int(to["taken"].sum())


def test_closest_texture_lookup_matches_jax():
    """texture_lookup="closest": each sample's uv from the exact closest
    point over its instance's k nearest base-mesh triangles, on the dense
    grid and the compact path."""
    td = _instancer("nearest", lookup="closest")
    want = recorded(MODULE, "test_closest_texture_lookup_matches_jax")
    jo, jg = {k: v for k, v in want.items() if "/" not in k}, group(want, "grid/")
    assert not td.use_jac and td.ds.k_tri == int(want["k_tri"]) > 0
    o, d, p = _rays()
    to = td.get_model_input_compact(o, d, p, N_SAMPLES, STEP, COVER, key=jax_rng.key(0))
    ray = to["ray_idx"].numpy()
    ties = _closest_ties(td, o[ray] + d[ray] * to["t"].numpy()[:, None], to["instance_id"])
    _compare_compact(jo, to, td, o, d, "nearest", COVER, ties=ties)
    taken = to["taken"].numpy()
    _assert_tie_parameters(to["parameters"].numpy(), jo["parameters"], taken & ties, taken.sum())
    tg = td.get_model_input(o, d, p, N_SAMPLES, STEP, key=jax_rng.key(0))
    valid = tg["dists"].numpy() > 0
    np.testing.assert_array_equal(tg["instance_id"].numpy(), np.asarray(jg["instance_id"]))
    ties = _closest_ties(td, o[:, None] + d[:, None] * tg["t"].numpy()[..., None],
                         tg["instance_id"])
    _assert_float(tg["parameters"].numpy(), jg["parameters"], "parameters", ulps=64,
                  mask=valid & ~ties)
    _assert_tie_parameters(tg["parameters"].numpy(), jg["parameters"], valid & ties, valid.sum())
    # The lookup differs from the jacobian one: the texture slot moved.
    jac = _instancer("nearest").get_model_input(o, d, p, N_SAMPLES, STEP, key=jax_rng.key(0))
    assert (tg["parameters"][..., 0] != jac["parameters"][..., 0])[valid].any()


def _closest_ties(td, pts_w, inst):
    """Samples (world points pts_w [..., 3] in instance ``inst``) whose two
    nearest candidate triangles are equidistant up to float32 rounding:
    triangles meeting at the closest point, common for points above the
    mesh.  Which one the
    lookup takes turns on the last ulp of the distances; the two give the
    same point up to rounding, but a texel edge of the checkerboard (one
    full step in one texel) turns an ulp of uv into ~4e-5 of the texture
    slot (measured 4.2e-5)."""
    ds = td.ds
    cand = ds.tri_candidates[torch.as_tensor(inst).long()]
    a = ds.tri_v0[cand].double()
    b, c = a + ds.tri_e1[cand].double(), a + ds.tri_e2[cand].double()
    p = torch.as_tensor(pts_w, dtype=torch.float32)[..., None, :]
    bary = _closest_point_tri(p, a.float(), b.float(), c.float()).double()
    cp = bary[..., 0:1] * a + bary[..., 1:2] * b + bary[..., 2:3] * c
    d2 = torch.sort(((cp - p.double()) ** 2).sum(-1), -1).values
    return ((d2[..., 1] - d2[..., 0]) <= 1e-5 * d2[..., 0]).numpy()


def _assert_tie_parameters(got, want, ties, n_samples):
    """The parameters of samples on closest-lookup ties: within 64 ulps
    but for at most 1e-3 of the n_samples samples, each of those within
    1e-3 (an ulp or two of uv across a texel edge)."""
    err = np.abs(got[ties] - np.asarray(want)[ties]).max(-1)
    assert ties.sum() > 0 and (err > 64 * 2**-23).sum() <= 1e-3 * n_samples
    assert err.max() <= 1e-3


# -- renderers --------------------------------------------------------------------------


def _ff(n):
    return {"module": "network.model.FourierFeatures", "n_freq_bands": n}


def _reset(seed=0):
    """Both packages' seeds and model-init counters, as a fresh process has them."""
    jax_streams.set_seed(seed)
    rng.set_seed(seed)
    jax_mlp._INIT_COUNTER[0] = 0
    port_mlp._INIT_COUNTER[0] = 0


def _jax_model(cfg):
    _reset()
    return jax_util.instantiate(jax_util.EasyDict(cfg))["model"]


def _port_model(setup, cfg):
    """The port's model of ``cfg`` with the JAX init's weights (recorded
    under "setup[<setup>]")."""
    _reset()
    tm = instantiate(cfg, device="cpu")
    load_jax_params(tm, group(recorded(MODULE, f"setup[{setup}]"), "weights/"))
    return tm


def _carpet_setup(live=False, **renderer):
    """The carpet scene's renderer config at 12x12 rays of the bench view
    with a narrow ParamNerf (4/2/2 bands, depth 2, width 32)."""
    model = {"module": "network.model.ParamNerf", "pos_embedding": _ff(4),
             "dir_embedding": _ff(2), "param_embedding": _ff(2), "n_parameters": [1, 6],
             "depth": 2, "width": 32, "skips": [1]}
    cfg = {"module": "network.renderer.InstanceRenderer", "n_samples": N_SAMPLES,
           "render_chunk": 64, "net_chunk": 512, "step_size": STEP, **renderer,
           "instancer_config": {"module": "instancer.instancer.Instancer", "mesh_path": MESH,
                                "patch_origins_path": ANCHORS, "patch_scale": 0.09,
                                "instance_sampling_method": "nearest", **SCENE_KW, **DEV_KW}}
    data = frame_rays(12, 12, np.array([0.47, -0.65, 0.6]) * 6.0, 0.55,
                      [1, 1, 1, 0.1, 0, 0, 1.0])
    return model, cfg, data


def _mip_setup(live=False, **renderer):
    """configs/demo_grass_mip_render.py at 12x12 rays of its test dataset's
    last camera, with its ParamNerf cut to 4/2/2 bands, depth 2, width 32
    (as tests/test_torch_mip.py cuts it) and 32-ray blocks.  The rays are
    the JAX test dataset's: drawn when ``live``, else recorded."""
    cfg = copy.deepcopy(importlib.import_module("configs.demo_grass_mip_render").config)
    model = cfg["model_config"]
    model.update(depth=2, width=32, skips=[0])
    for k, n in (("pos_embedding", 4), ("dir_embedding", 2), ("param_embedding", 2)):
        model[k] = dict(model[k], n_freq_bands=n)
    cfg["test_dataset_config"]["data_loader_config"].update(height=12, width=12)
    if live:
        jax_streams.set_seed(0)
        data = {k: np.asarray(v) for k, v in
                list(jax_util.instantiate(jax_util.EasyDict(cfg["test_dataset_config"])))[-1]
                .items()}
    else:
        data = group(recorded(MODULE, "setup[mip]"), "data/")
    rcfg = dict(cfg["renderer_config"], render_chunk=64, net_chunk=512, **renderer)
    rcfg["instancer_config"] = dict(rcfg["instancer_config"], ray_block=32, max_hits=32)
    for k in ("mesh_path", "patch_origins_path"):
        rcfg["instancer_config"][k] = os.path.join(ROOT, rcfg["instancer_config"][k])
    return model, rcfg, data


SETUPS = {"instance": _carpet_setup, "mip": _mip_setup}


def _jax_setup(setup):
    """The JAX init's weights of ``setup``'s model, and the mip setup's rays."""
    model, _, data = SETUPS[setup](live=True)
    out = {f"weights/{k}": v for k, v in flatten_params(
        jax.tree.map(np.asarray, _jax_model(model).params)).items()}
    if setup == "mip":
        out.update({f"data/{k}": v for k, v in data.items()})
    return out


def _jax_render(setup, **renderer):
    """The JAX package's render of ``setup``'s rays under key(2), the
    renderer built under seed 0."""
    model, cfg, data = SETUPS[setup](live=True, **renderer)
    jm = _jax_model(model)
    _reset()
    jr = jax_util.instantiate(jax_util.EasyDict(dict(cfg, model=jm)))
    want = jr(**data, training=False, key=jax.random.key(2))
    return {"color": np.asarray(want["color_pred"]), "alpha": np.asarray(want["alpha_pred"])}


def _render_both(case, setup, **renderer):
    """The JAX package's render (recorded as ``case``) and the port's, of
    the same rays under key(2) with the same weights, both renderers built
    under seed 0."""
    model, cfg, data = SETUPS[setup](**renderer)
    tm = _port_model(setup, model)
    _reset()
    tr = instantiate(dict(cfg, model=tm, device="cpu"))
    got = tr(**data, key=jax_rng.key(2))
    want = recorded(MODULE, case)
    return ((got["color_pred"].numpy(), got["alpha_pred"].numpy()),
            (want["color"], want["alpha"]), tr)


def _assert_frames(got, want):
    (c_t, a_t), (c_j, a_j) = got, want
    assert c_t.shape == c_j.shape and a_t.shape == a_j.shape
    assert a_j.max() > 0.3
    np.testing.assert_allclose(c_t, c_j, rtol=0, atol=FRAME_TOL)
    np.testing.assert_allclose(a_t, a_j, rtol=0, atol=FRAME_TOL)


def _compact_kw(setup, false_color):
    extra = {"blur_idx": 3} if setup == "instance" else {}
    return dict(sample_budget_per_ray=24, raw_noise_std=0.1, false_color=false_color, **extra)


SORTED_KW = dict(raw_noise_std=0.1, false_color=True)


@pytest.mark.parametrize("false_color", [False, True])
@pytest.mark.parametrize("setup", ["instance", "mip"])
def test_compact_renderer_matches_jax(setup, false_color):
    """InstanceRenderer (blur_idx 3) and MipInstanceRenderer on the compact
    path at budget 24, with raw_noise_std 0.1 and with and without
    false_color: color and alpha within FRAME_TOL of the JAX renderers'."""
    got, want, tr = _render_both(f"test_compact_renderer_matches_jax[{setup}-{false_color}]",
                                 setup, **_compact_kw(setup, false_color))
    _assert_frames(got, want)
    if false_color:
        assert tr.instance_color.shape == (tr.instancer.n_instances(), 3)


@pytest.mark.parametrize("setup", ["instance", "mip"])
def test_sorted_renderer_with_noise_and_false_color_matches_jax(setup):
    """The sorted grid path with raw_noise_std 0.1 (each sorted block's
    noise drawn under its shade key over JAX's bucket width) and
    false_color: within FRAME_TOL of the JAX renderers'."""
    got, want, _ = _render_both(
        f"test_sorted_renderer_with_noise_and_false_color_matches_jax[{setup}]", setup,
        **SORTED_KW)
    _assert_frames(got, want)


def test_compact_frame_equals_grid_frame():
    """At a covering budget the compact frame is the sorted grid frame:
    the MLP's rows are independent and the unfilled slots composite exact
    zeros."""
    model, cfg, data = _carpet_setup()
    tm = _port_model("instance", model)
    frames = []
    for budget in (0, COVER):
        r = instantiate(dict(cfg, sample_budget_per_ray=budget, model=tm, device="cpu"))
        out = r(**data, key=jax_rng.key(2))
        frames.append((out["color_pred"].numpy(), out["alpha_pred"].numpy()))
    (c_g, a_g), (c_c, a_c) = frames
    assert a_g.max() > 0.3
    np.testing.assert_allclose(c_c, c_g, rtol=0, atol=FRAME_TOL)
    np.testing.assert_allclose(a_c, a_g, rtol=0, atol=FRAME_TOL)


# -- keys and the Instancer's reference API ----------------------------------------


def test_draw_keys_match_jax():
    """Key by key: the compact path's per-block ray and sample keys, the
    sorted blocks' shade keys, the renderer's instancer and noise keys, a
    keyless call's key and the noise drawn over a bucket's width."""
    key, tkey = jax.random.key(7), jax_rng.key(7)
    data = lambda k: np.asarray(jax.random.key_data(k))  # noqa: E731
    for b in (0, 3):
        want = jax.random.split(jax.random.fold_in(key, b))
        got = jax_rng.split(jax_rng.fold_in(tkey, b))
        np.testing.assert_array_equal(got.numpy(), data(want))
    k_sorted = jax.random.fold_in(key, 0x7FFFFFFF)
    for index in (0, 1):
        got = jax_rng.block_keys(jax_rng.fold_in(tkey, 0x7FFFFFFF), 4, index=index)
        want = [data(jax.random.split(jax.random.fold_in(k_sorted, b))[index]) for b in range(4)]
        np.testing.assert_array_equal(got.numpy(), np.stack(want))
    np.testing.assert_array_equal(jax_rng.split(tkey).numpy(), data(jax.random.split(key)))
    np.testing.assert_array_equal(jax_rng.fold_in(jax_rng.key(5), 2).numpy(),
                                  data(jax.random.fold_in(jax.random.key(5), 2)))
    want = np.asarray(jax.random.normal(key, (3, 40)))[:, :24]
    got = jax_rng.normal(tkey, (3, 24), full_width=40).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=4 * 2**-23 * np.abs(want).max())


REFERENCE_API_NAMES = ("rays_d", "pts", "t", "dists", "color_last", "alpha_last",
                       "alpha_weight", "instance_id", "hit_idxs", "parameters")


def _jax_reference_api():
    """The JAX Instancer's get_model_input over two keyless calls
    ("<call>/<name>"), then its get_model_input_dict without a key
    ("dict/<name>")."""
    ji = JaxInstancer(mesh_path=MESH, patch_scale=0.09, patch_origins_path=ANCHORS,
                      **dict(SCENE_KW, instance_sampling_method="nearest", seed=3), **DEV_KW)
    o, d, p = _rays()
    out = {}
    for call in range(2):
        want = ji.get_model_input(o, d, p, N_SAMPLES, STEP)
        assert len(want) == 10
        out.update({f"{call}/{name}": np.asarray(w) for name, w in zip(REFERENCE_API_NAMES, want)})
    want = ji.get_model_input_dict(o, d, p, N_SAMPLES, STEP)
    out.update({f"dict/{k}": np.asarray(want[k]) for k in ("t", "hit")})
    return out


def test_instancer_reference_api_matches_jax():
    """Instancer.get_model_input's ten outputs over two keyless calls in a
    row (each draws under fold_in(key(seed), call)), then
    get_model_input_dict without a key (the third call's key), against the
    JAX Instancer's."""
    kw = dict(SCENE_KW, instance_sampling_method="nearest", seed=3)
    recording = recorded(MODULE, "test_instancer_reference_api_matches_jax")
    ti = Instancer(mesh_path=MESH, patch_scale=0.09, patch_origins_path=ANCHORS, device="cpu",
                   **kw, **DEV_KW)
    o, d, p = _rays()
    names = REFERENCE_API_NAMES
    ts = []
    for call in range(2):
        want = [recording[f"{call}/{name}"] for name in names]
        got = ti.get_model_input(o, d, p, N_SAMPLES, STEP)
        assert len(got) == len(want) == 10
        out = dict(zip(names, got))
        valid = out["dists"].numpy() > 0
        t_scale = float(np.abs(np.asarray(want[2])).max())
        for name, g, w in zip(names, got, want):
            if name in ("instance_id", "hit_idxs"):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
            elif name in ("t", "dists"):
                _assert_float(g.numpy(), w, name, scale=t_scale)
            elif name in ("pts", "rays_d", "parameters"):
                _assert_float(g.numpy(), w, name, ulps=64, mask=valid)
            else:
                _assert_float(g.numpy(), w, name)
        assert out["hit_idxs"].shape[1] == 1 and len(out["hit_idxs"]) > 0
        ts.append(out["t"])
    # The two calls drew different offsets.
    assert not torch.equal(ts[0], ts[1])
    want = group(recording, "dict/")
    got = ti.get_model_input_dict(o, d, p, N_SAMPLES, STEP)
    _assert_float(got["t"].numpy(), want["t"], "t", scale=float(np.abs(np.asarray(want["t"])).max()))
    np.testing.assert_array_equal(got["hit"].numpy(), np.asarray(want["hit"]))


@contextlib.contextmanager
def _bf16_slab_dots():
    """While active, JAX traces the slab test's [Rb, 3] @ [3, N] products
    with bfloat16-rounded operands, as the TPU runs float32 dots and the
    port's matmul_precision="bfloat16" rounds them (XLA's CPU backend
    ignores the precision setting)."""
    import inspect

    from jax._src import core
    from jax._src.numpy import tensor_contractions

    # The descriptor itself (a staticmethod), restored as it was found.
    own = "_matmul" in vars(core.ShapedArray)
    real = inspect.getattr_static(core.ShapedArray, "_matmul")

    def matmul(a, b):
        if jnp.ndim(b) == 2 and jnp.shape(b)[0] == 3 and jnp.shape(b)[1] > 3:
            a, b = (jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32) for x in (a, b))
        return tensor_contractions.matmul(a, b)

    core.ShapedArray._matmul = staticmethod(matmul)
    try:
        # The patch reads a JAX internal: it must reach traced products.
        x = np.float32([[1.0 + 2**-12, 0, 0]])
        assert float(jax.jit(lambda a, b: a @ b)(x, np.eye(3, 4, dtype=np.float32))[0, 0]) == 1.0
        yield
    finally:
        if own:
            core.ShapedArray._matmul = real
        else:
            del core.ShapedArray._matmul


def _step_count_setup():
    """Ray block 137 of configs/config_carpet_render.py's first item at the
    carpet operating point: rays, parameters, scene and instancer
    settings."""
    import chip_smoke

    data, _, _ = chip_smoke.config_item("carpet")
    sl = slice(137 * 1024, 138 * 1024)
    o, d = data["rays_o"][0][sl], data["rays_d"][0][sl]
    p = np.repeat(np.asarray(data["parameters"], np.float32).reshape(1, -1), 1024, 0)
    kw = dict(SCENE_KW, instance_sampling_method="nearest", min_shadow_samples=8,
              n_shadow_samples=256, min_texture_samples=8, n_texture_samples=256)
    dev = dict(max_hits=48, ray_block=1024, max_steps_per_ray=320, cull_budget=448,
               tri_cull_budget=384)
    return o, d, p, kw, dev


def _jax_step_counts():
    """The JAX per-ray stage of the block with the golden's bf16 slab dots."""
    o, d, p, kw, dev = _step_count_setup()
    js = JaxScene(**kw)
    js.distribute_instances_on_mesh(MESH, 0.09, ANCHORS)
    jd = JaxDeviceInstancer(js, **dev)
    with _bf16_slab_dots():
        jr = jax.jit(lambda o, d, p: jd._per_ray(o, d, p, 320, 0.002, jax.random.key(0)))(
            jnp.asarray(o), jnp.asarray(d), jnp.asarray(p))
    # JAX's products are its own again.
    x = np.float32([[1.0 + 2**-12, 0, 0]])
    assert float(jax.jit(lambda a, b: a @ b)(x, np.eye(3, 4, dtype=np.float32))[0, 0]) == x[0, 0]
    return {k: np.asarray(jr[k]) for k in ("hit", "overflow_hits", "total", "tk1", "kvalid",
                                           "n_steps", "overflow_steps")}


def test_carpet_step_counts_match_jax_up_to_knife_edges():
    """The carpet frame's ray block 137 (configs/config_carpet_render.py's
    first item at the carpet operating point, the golden's bf16 slab dots)
    through the per-ray stage of both packages: hits and dropped intervals
    equal, and every ray's step count equal unless its arc length is a
    whole number of steps to within a few ulps of world t, where the last
    ulp of the arc's float32 sum decides floor(total / step).  Ray 141,186
    of the frame (row 898 here) is such a ray: 0.674 of arc, 337 steps of
    0.002, 337 in the JAX package on the CPU and 336 in the port; it is why
    the JAX package drops 576,101 samples of the frame on the CPU, 576,099
    on the TPU and the port 576,100 (ROADMAP Queue 3)."""
    o, d, p, kw, dev = _step_count_setup()
    jr = recorded(MODULE, "test_carpet_step_counts_match_jax_up_to_knife_edges")
    td = Instancer(mesh_path=MESH, patch_scale=0.09, patch_origins_path=ANCHORS, device="cpu",
                   matmul_precision="bfloat16", **kw, **dev).device_instancer
    tr = td._per_ray(torch.tensor(o), torch.tensor(d), torch.tensor(p), 320, 0.002,
                     torch.full((1024,), 0.5))
    np.testing.assert_array_equal(tr["hit"].numpy(), np.asarray(jr["hit"]))
    assert int(tr["overflow_hits"]) == int(jr["overflow_hits"]) > 0
    total_t, total_j = tr["total"].numpy(), np.asarray(jr["total"])
    t_scale = float(np.abs(np.asarray(jr["tk1"])[np.asarray(jr["kvalid"])]).max())
    np.testing.assert_allclose(total_t, total_j, rtol=0, atol=8 * 2**-23 * t_scale)
    necessary = [np.floor(t / np.float32(0.002)) for t in (total_t, total_j)]
    edge = necessary[0] != necessary[1]
    steps = total_j.astype(np.float64) / 0.002
    assert (np.abs(steps - np.round(steps))[edge] <= 8 * 2**-23 * t_scale / 0.002).all()
    assert (np.asarray(jr["n_steps"]) == tr["n_steps"].numpy())[~edge].all()
    # Row 898 is the one edge, past the step cap: one sample more dropped in JAX.
    assert np.nonzero(edge)[0].tolist() == [898]
    assert (necessary[1][898], necessary[0][898]) == (337, 336)
    assert int(jr["overflow_steps"]) == int(tr["overflow_steps"]) + 1


JAX_CASES = {
    "test_instancer_reference_api_matches_jax": _jax_reference_api,
    "test_carpet_step_counts_match_jax_up_to_knife_edges": _jax_step_counts,
    **{f"test_compact_model_input_matches_jax[{method}-{budget}]":
       (lambda method=method, budget=budget: _jax_compact(method, budget))
       for method in ("random", "nearest", "nearest_blend") for budget in (COVER, DROP)},
    "test_compact_with_textures_light_and_shadows_matches_jax":
        lambda: _jax_compact("nearest", COVER, shadows=True),
    "test_closest_texture_lookup_matches_jax":
        lambda: _jax_compact("nearest", COVER, lookup="closest"),
    **{f"setup[{setup}]": (lambda setup=setup: _jax_setup(setup)) for setup in SETUPS},
    **{f"test_compact_renderer_matches_jax[{setup}-{fc}]":
       (lambda setup=setup, fc=fc: _jax_render(setup, **_compact_kw(setup, fc)))
       for setup in SETUPS for fc in (False, True)},
    **{f"test_sorted_renderer_with_noise_and_false_color_matches_jax[{setup}]":
       (lambda setup=setup: _jax_render(setup, **SORTED_KW)) for setup in SETUPS},
}
