"""A small frame through nerftex_torch's config-built InstanceRenderer
against the JAX package's sorted InstanceRenderer: the bench view at 24x24
rays, the carpet scene, a narrow ParamNerf with the same weights, once with
deterministic offsets and once with the offsets JAX draws for the same key."""

import os
import sys

import jax
import numpy as np
import pytest

import nerftex_tpu.models.mlp as jax_mlp
from nerftex_tpu.utils import rng
from nerftex_tpu.utils import util as jax_util
from nerftex_torch.render.checkpoint import flatten_params, load_jax_params
from nerftex_torch.ops.rays import frame_rays
from nerftex_torch.utils import jax_rng
from nerftex_torch.utils.util import instantiate

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _jax_reference import group, recorded  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULE = "test_torch_render"

H = W = 24
RAY_BLOCK, RENDER_CHUNK = 64, 512


def _model_cfg():
    def ff(n):
        return {"module": "network.model.FourierFeatures", "n_freq_bands": n}

    return {"module": "network.model.ParamNerf", "pos_embedding": ff(10),
            "dir_embedding": ff(4), "param_embedding": ff(4), "n_parameters": [1, 6],
            "depth": 3, "width": 64, "skips": [1]}


def _renderer_cfg(deterministic, sorted_blocks=True):
    return {
        "module": "network.renderer.InstanceRenderer",
        "n_samples": 1024, "render_chunk": RENDER_CHUNK, "net_chunk": 4096,
        "step_size": 0.002, "sorted_blocks": sorted_blocks,
        "instancer_config": {
            "module": "instancer.instancer.Instancer",
            "b_0": [-1.4, -1.2, -0.1], "b_1": [1.2, 1.2, 1.8],
            "cast_shadow_rays": False,
            "textures": [os.path.join(ROOT, "meshes", "smooth_checkerboard.png"), "", "", "",
                         "light"],
            "mesh_path": os.path.join(ROOT, "meshes", "cloth_mesh.ply"),
            "patch_origins_path": os.path.join(ROOT, "meshes", "cloth_anchor_points.ply"),
            "patch_scale": 0.09, "jitter_amount": 1.0, "instance_sampling_method": "nearest",
            "max_hits": 16, "ray_block": RAY_BLOCK, "max_steps_per_ray": 320,
            "cull_budget": 448, "tri_cull_budget": 384,
            "deterministic_offset": deterministic,
        },
    }


def _frame_rays():
    return frame_rays(H, W, np.array([0.47, -0.65, 0.6]) * 6.0, 0.55, [1, 1, 1, 0.1, 0, 0, 1.0])


def _jax_model():
    rng.set_seed(0)
    jax_mlp._INIT_COUNTER[0] = 0
    return jax_util.instantiate(jax_util.EasyDict(_model_cfg()))["model"]


def _jax_weights():
    return {f"weights/{k}": v
            for k, v in flatten_params(jax.tree.map(np.asarray, _jax_model().params)).items()}


@pytest.fixture(scope="module")
def frame():
    data = _frame_rays()
    tm = instantiate(_model_cfg(), device="cpu")
    load_jax_params(tm, group(recorded(MODULE, "frame"), "weights/"))
    return data, tm


def _jax_render(deterministic, key):
    """The JAX sorted InstanceRenderer's frame of the rays under key(key)."""
    r = jax_util.instantiate(jax_util.EasyDict(dict(_renderer_cfg(deterministic),
                                                    model=_jax_model())))
    out = r(**_frame_rays(), training=False, key=jax.random.key(key))
    return {"color": np.asarray(out["color_pred"]), "alpha": np.asarray(out["alpha_pred"])}


def _recorded_render(case):
    want = recorded(MODULE, case)
    return want["color"], want["alpha"]


def _torch_render(data, tm, deterministic, sorted_blocks=True, **kw):
    r = instantiate(dict(_renderer_cfg(deterministic, sorted_blocks), model=tm, device="cpu"))
    out = r(**data, **kw)
    return out["color_pred"].numpy(), out["alpha_pred"].numpy()


def _compare(got, want):
    (c_t, a_t), (c_j, a_j) = got, want
    assert c_t.shape == c_j.shape == (1, H * W, 3) and a_t.shape == a_j.shape == (1, H * W)
    assert a_j.max() > 0.5
    # The float32 frames are not bit-equal: the highest positional band
    # multiplies local coordinates (|x| up to ~20) by 2^9, so one float32
    # ulp of geometry (XLA contracts fmas, PyTorch rounds each operation)
    # moves a sin argument by ~1e-3, and a knife-edge nearest pick (see
    # test_torch_instancer) swaps a sample's patch.  Measured here: 68-73 dB,
    # max pixel error 1.3e-2; a wrong frame measures below 30 dB.
    err = np.maximum(np.abs(c_t - c_j).max(-1), np.abs(a_t - a_j))
    mse = np.mean(np.concatenate([c_t - c_j, (a_t - a_j)[..., None]], -1) ** 2)
    assert 10 * np.log10(1 / mse) >= 60
    assert np.mean(err > 1e-3) <= 0.02
    assert err.max() <= 3e-2


def test_frame_matches_jax_deterministic_offsets(frame):
    data, tm = frame
    want = _recorded_render("test_frame_matches_jax_deterministic_offsets")
    _compare(_torch_render(data, tm, True), want)


def test_frame_matches_jax_with_injected_offsets(frame):
    """The port draws JAX's per-ray offsets from the same key."""
    data, tm = frame
    want = _recorded_render("test_frame_matches_jax_with_injected_offsets")
    _compare(_torch_render(data, tm, False, key=jax_rng.key(1)), want)


def test_sorted_frame_equals_dense_frame(frame):
    data, tm = frame
    c_s, a_s = _torch_render(data, tm, True)
    c_d, a_d = _torch_render(data, tm, True, sorted_blocks=False)
    # Same per-sample inputs and MLP rows; only the composite's reduction
    # length differs (block max vs the full grid), so a few ulps.
    np.testing.assert_allclose(c_s, c_d, rtol=0, atol=5e-7)
    np.testing.assert_allclose(a_s, a_d, rtol=0, atol=5e-7)


def _gathered_mlp(model, net_chunk, pos, dirs, prms, mask):
    """The MLP on the valid slots alone: a boolean gather of each input,
    the rows through model.infer, a scatter into zeros."""
    from nerftex_torch.render.renderer import chunked_apply

    r, s = mask.shape
    c, d = chunked_apply(model.infer, tuple(x[mask] for x in (pos, dirs, prms)), net_chunk)
    color, density = pos.new_zeros(r, s, 3), pos.new_zeros(r, s)
    color[mask], density[mask] = c, d[:, 0]
    return color, density


@pytest.mark.parametrize("net_chunk", [32768, 1000])
def test_dense_masked_mlp_equals_the_gathered_valid_samples(net_chunk):
    """InstanceRenderer._eval_mlp runs configs/config_carpet_render.py's
    ParamNerf (8 x 256, [1, 6]) over every slot of a carpet-sized block,
    1,024 rays x 24 slots: full rays, rays cut short, a tiny ray of one
    sample and an empty ray, the padding slots' positions inf.  The valid
    slots equal the MLP on the gathered valid samples; the padding slots
    are exactly 0, not the NaN the inf positions give."""
    import importlib

    import torch

    from nerftex_torch.render.instance_renderer import InstanceRenderer
    from nerftex_torch.utils import trace

    torch.manual_seed(0)
    cfg = importlib.import_module("configs.config_carpet_render").config["model_config"]
    model = instantiate(cfg, device="cpu")
    r, s = 1024, 24
    n_steps = torch.full((r,), s)
    n_steps[::3] = torch.randint(2, s, (len(n_steps[::3]),))
    n_steps[5], n_steps[7] = 1, 0
    mask = torch.arange(s)[None, :] < n_steps[:, None]
    pos = torch.where(mask[..., None], torch.rand(r, s, 3) * 2 - 1, float("inf"))
    dirs = torch.nn.functional.normalize(torch.randn(r, s, 3), dim=-1)
    prms = torch.rand(r, s, 7)
    renderer = InstanceRenderer.__new__(InstanceRenderer)
    renderer.model, renderer.net_chunk = model, net_chunk
    trace.reset()
    with trace.recording():
        color, density = renderer._eval_mlp(pos, dirs, prms, mask)
    totals = trace.totals()
    trace.reset()
    want_c, want_d = _gathered_mlp(model, net_chunk, pos, dirs, prms, mask)
    assert totals["mlp.valid"] == int(mask.sum()) and totals["mlp.rows"] == r * s
    assert "sync" not in totals
    for got, want in ((color, want_c), (density, want_d)):
        assert torch.isfinite(got).all()
        scale = want.abs().max()
        assert scale > 0
        torch.testing.assert_close(got[mask], want[mask], rtol=0, atol=1e-6 * float(scale))
        assert (got[~mask] == 0).all()


def test_carpet_render_config_instantiates():
    """configs/config_carpet_render.py's model and renderer configs resolve
    to the port's classes."""
    from configs.config_carpet_render import config

    from nerftex_torch.models.mlp import ParamNerf
    from nerftex_torch.render.instance_renderer import InstanceRenderer

    model = instantiate(config["model_config"], device="cpu")
    assert isinstance(model, ParamNerf) and model.pos_dim == 72 and model.dir_dim == 81
    cfg = dict(config["renderer_config"], model=model, device="cpu")
    cfg["instancer_config"] = dict(
        cfg["instancer_config"],
        textures=[os.path.join(ROOT, t) if t.endswith(".png") else t
                  for t in cfg["instancer_config"]["textures"]],
        mesh_path=os.path.join(ROOT, cfg["instancer_config"]["mesh_path"]),
        patch_origins_path=os.path.join(ROOT, cfg["instancer_config"]["patch_origins_path"]),
    )
    r = instantiate(cfg)
    assert isinstance(r, InstanceRenderer)
    assert r.instancer.n_instances() == 900 and r.patch_scale == 0.09
    assert r.render_chunk == 16384 and r.net_chunk == 32768


def test_unported_options_raise(frame):
    """The options that raised before the compact path was ported
    (sample_budget_per_ray > 0, false_color, raw_noise_std > 0) build and
    render the frame on the CPU: finite, some of it opaque, in palette
    colors, and the same frame for the same key."""
    data, tm = frame
    cfg = dict(_renderer_cfg(True), sample_budget_per_ray=160, false_color=True,
               raw_noise_std=0.1, model=tm, device="cpu")
    r = instantiate(cfg)
    assert r.sample_budget_per_ray == 160 and r.false_color and r.raw_noise_std == 0.1
    out = r(**data, key=jax_rng.key(1))
    color, alpha = out["color_pred"].numpy(), out["alpha_pred"].numpy()
    assert color.shape == (1, H * W, 3) and alpha.shape == (1, H * W)
    assert np.isfinite(color).all() and np.isfinite(alpha).all() and alpha.max() > 0.5
    # Premultiplied palette colors (uniform in [0, 1)) stay within alpha.
    assert (color <= alpha[..., None] + 1e-6).all()
    again = r(**data, key=jax_rng.key(1))
    assert np.array_equal(again["color_pred"].numpy(), color)


def test_bench_rays_match_tpu_golden():
    """Two ray blocks of the bench frame (128 and 150 of the 512x512 frame's
    one render chunk) through the full-width bf16 port with the bench
    weights (tests/torch_bench_inputs.npz) and the golden's key(1) against
    the TPU-rendered golden frame, at bench.py's 55 dB floor.  The golden's
    slab-test and Fourier-lift matmuls took bf16 operands on the TPU, so the
    port renders with matmul_precision="bfloat16".  Blocks draw their
    offsets by block index, so the batch keeps each of the two blocks at its
    frame index and fills the other 149 with rays that miss the scene."""
    inputs = np.load(os.path.join(ROOT, "tests", "torch_bench_inputs.npz"))
    params = {k[len("param/"):]: inputs[k] for k in inputs.files if k.startswith("param/")}

    def ff(n):
        return {"module": "network.model.FourierFeatures", "n_freq_bands": n,
                "matmul_precision": "bfloat16"}

    model = instantiate({"module": "network.model.ParamNerf", "pos_embedding": ff(10),
                         "dir_embedding": ff(4), "param_embedding": ff(4),
                         "n_parameters": [1, 6], "compute_dtype": "bfloat16"}, device="cpu")
    load_jax_params(model, params)
    cfg = _renderer_cfg(False)
    cfg["instancer_config"].update(max_hits=48, ray_block=1024, matmul_precision="bfloat16")
    renderer = instantiate(dict(cfg, render_chunk=262144, net_chunk=32768, model=model,
                                device="cpu"))
    data = frame_rays(512, 512, np.array([0.47, -0.65, 0.6]) * 6.0, 0.55,
                      [1, 1, 1, 0.1, 0, 0, 1.0])
    sel = np.concatenate([np.arange(128 * 1024, 129 * 1024), np.arange(150 * 1024, 151 * 1024)])
    n = 151 * 1024
    sub = {"parameters": data["parameters"],
           "rays_o": np.broadcast_to(np.float32([0, 0, 50.0]), (1, n, 3)).copy(),
           "rays_d": np.broadcast_to(np.float32([0, 0, 1.0]), (1, n, 3)).copy(),
           "t": np.full((1, n, 2), np.inf, np.float32),
           "cone_scale": np.zeros((1, n, 1), np.float32)}
    for k in ("rays_o", "rays_d", "t", "cone_scale"):
        sub[k][:, sel] = data[k][:, sel]
    out = renderer(**sub, key=jax_rng.key(1))
    color, alpha = out["color_pred"][0, sel].numpy(), out["alpha_pred"][0, sel].numpy()
    assert not out["alpha_pred"][0, np.setdiff1d(np.arange(n), sel)].any()
    golden = np.load(os.path.join(ROOT, "tests", "golden_bench_frame.npz"))
    err = np.concatenate([color - golden["color"][sel].astype(np.float32),
                          (alpha - golden["alpha"][sel].astype(np.float32))[:, None]], -1)
    assert alpha.max() > 0.5
    assert 10 * np.log10(1 / np.mean(err**2)) >= 55.0


JAX_CASES = {
    "frame": _jax_weights,
    "test_frame_matches_jax_deterministic_offsets": lambda: _jax_render(True, 0),
    "test_frame_matches_jax_with_injected_offsets": lambda: _jax_render(False, 1),
}
