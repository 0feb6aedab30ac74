"""The mip paths of nerftex_torch against the JAX package's on the same
inputs, weights and keys, at small width (depth 2, width 32, 4 position
bands):

- IntegratedPositionalEncoding, with float32 and bfloat16 operands;
- cone_segment_gaussians and cone_sample_cov, degenerate (mu = hw = 0)
  segments included, and their gradients;
- ParamNerf with n_pos 6, with and without embedding_config /
  include_param_dims: forward and infer against the JAX apply;
- MipRenderer: an eval render, and ten training steps through
  nerftex_torch.main against JAX's Train op by op, with and without
  mip_importance; proxy-missing rays stay finite;
- MipInstanceRenderer on a 24x24 demo_grass_mip_render frame;
- RenderSession on demo_grass_mip_render against a direct render;
- nerftex_torch.main training demo_grass_mip_train and rendering
  demo_grass_mip_render from its checkpoint with jax and nerftex_tpu
  blocked.

The JAX references run op by op (jax.disable_jit()) where a trajectory is
compared: tests/test_torch_train.py explains why."""

import copy
import importlib
import json
import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerftex_tpu.models.mlp as jax_mlp
from nerftex_tpu.models.encodings import IntegratedPositionalEncoding as JaxIPE
from nerftex_tpu.ops import volume as jax_volume
from nerftex_tpu.tools.synth import make_synthetic_tfrecord as jax_synth
from nerftex_tpu.utils import rng as jax_streams
from nerftex_tpu.utils import util as jax_util
from nerftex_torch import main as port_main
from nerftex_torch.models import mlp as port_mlp
from nerftex_torch.models.encodings import IntegratedPositionalEncoding
from nerftex_torch.ops import volume
from nerftex_torch.render.checkpoint import flatten_params, load_jax_params
from nerftex_torch.utils import jax_rng, rng
from nerftex_torch.utils.util import instantiate

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _jax_reference import group, recorded  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULE = "test_torch_mip"
N_ITERS = 10
LOSS_RTOL = 1e-4        # ten logged losses, the port vs JAX's op-by-op Train
H = W = 24
RENDER_SIZE = 16


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    monkeypatch.setenv("NERFTEX_NO_TENSORBOARD", "1")


def _reset(seed=0):
    """Both packages' seeds and model-init counters, as a fresh process has them."""
    jax_streams.set_seed(seed)
    rng.set_seed(seed)
    jax_mlp._INIT_COUNTER[0] = 0
    port_mlp._INIT_COUNTER[0] = 0


def _cut_model(cfg):
    """A mip config's ParamNerf cut to depth 2, width 32 and 4/2/2 bands."""
    model = cfg["model_config"]
    model.update(depth=2, width=32, skips=[0])
    model["pos_embedding"] = dict(model["pos_embedding"], n_freq_bands=4)
    for k in ("dir_embedding", "param_embedding"):
        model[k] = dict(model[k], n_freq_bands=2)
    return cfg


def _psnr(c_t, a_t, c_j, a_j):
    mse = np.mean(np.concatenate([c_t - c_j, (a_t - a_j)[..., None]], -1) ** 2)
    return 10 * np.log10(1 / mse)


# -- encodings, cone Gaussians, the model ------------------------------------------


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_ipe_matches_jax(precision):
    """The port's lift is the JAX matmul bit for bit; with bfloat16 operands
    it is JAX's on the bf16-rounded input (the lift's powers 2^k and 4^k
    are exact in bf16), as a TPU computes it at DEFAULT precision."""
    rs = np.random.RandomState(2)
    x = np.concatenate([rs.uniform(-2, 2, (64, 3)), rs.uniform(0, 0.05, (64, 3))],
                       -1).astype(np.float32)
    xr = torch.tensor(x)
    if precision == "bfloat16":
        xr = xr.to(torch.bfloat16).float()
    want = np.asarray(JaxIPE(6)(xr.numpy()))
    got = IntegratedPositionalEncoding(6, matmul_precision=precision)(torch.tensor(x)).numpy()
    assert got.shape == want.shape == (64, 36)
    assert IntegratedPositionalEncoding(6).out_dim(6) == JaxIPE(6).out_dim(6) == 36
    # tests/test_encodings.py's pin: sin, cos and exp of the same float32
    # arguments, up to libm ulps.
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _cone_inputs():
    rs = np.random.RandomState(3)
    rays_o = rs.normal(size=(6, 3)).astype(np.float32)
    rays_d = rs.normal(size=(6, 3)).astype(np.float32)
    t_vals = np.sort(rs.uniform(1, 3, (6, 9)), -1).astype(np.float32)
    t_vals[:2] = 0.0  # proxy-missing rays: every segment has mu = hw = 0
    t_vals[2, :4] = 0.0  # degenerate segments ahead of real ones
    radii = rs.uniform(0.001, 0.02, (6, 1)).astype(np.float32)
    return rays_o, rays_d, t_vals, radii


def test_cone_segment_gaussians_match_jax():
    rays_o, rays_d, t_vals, radii = _cone_inputs()

    def loss_j(t):
        mean, cov = jax_volume.cone_segment_gaussians(rays_o, rays_d, t, radii)
        return jnp.sum(mean * 0.3) + jnp.sum(cov * 50.0), (mean, cov)

    (_, (mean_j, cov_j)), g_j = jax.value_and_grad(loss_j, has_aux=True)(jnp.asarray(t_vals))
    t = torch.tensor(t_vals, requires_grad=True)
    mean_t, cov_t = volume.cone_segment_gaussians(torch.tensor(rays_o), torch.tensor(rays_d), t,
                                                  torch.tensor(radii))
    (mean_t.sum() * 0.3 + cov_t.sum() * 50.0).backward()
    assert mean_t.shape == cov_t.shape == (6, 8, 3)
    # The same float32 operations in the same order.
    np.testing.assert_allclose(mean_t.detach().numpy(), np.asarray(mean_j), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(cov_t.detach().numpy(), np.asarray(cov_j), rtol=1e-5, atol=1e-12)
    # The den == 0 gate: degenerate segments are exactly 0, with a finite
    # gradient, where the ungated formula gives 0/0.
    assert np.all(cov_t.detach().numpy()[:2] == 0)
    assert torch.isfinite(t.grad).all()
    # The backward's float32 roundings in other orders.  Measured: 9.1e-6
    # (2e-5 of max |g|) on one element.
    g_j = np.asarray(g_j)
    np.testing.assert_allclose(t.grad.numpy(), g_j, rtol=0, atol=5e-5 * np.abs(g_j).max())


def test_cone_sample_cov_matches_jax():
    rs = np.random.RandomState(4)
    n = 40
    rays_d = rs.normal(size=(n, 3)).astype(np.float32)
    t = rs.uniform(0, 0.3, n).astype(np.float32)
    dists = rs.uniform(0, 0.004, n).astype(np.float32)
    t[:5] = dists[:5] = 0.0  # masked slots of the instanced grid
    radii = rs.uniform(0, 0.2, n).astype(np.float32)

    def loss_j(t_, d_):
        return jnp.sum(jax_volume.cone_sample_cov(rays_d, t_, radii, d_) * 1e3)

    want = np.asarray(jax_volume.cone_sample_cov(rays_d, t, radii, dists))
    g_j = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(t), jnp.asarray(dists))
    tt = torch.tensor(t, requires_grad=True)
    dt = torch.tensor(dists, requires_grad=True)
    got = volume.cone_sample_cov(torch.tensor(rays_d), tt, torch.tensor(radii), dt)
    (got.sum() * 1e3).backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-14)
    assert np.all(got.detach().numpy()[:5] == 0)
    for ours, theirs in ((tt.grad, g_j[0]), (dt.grad, g_j[1])):
        assert torch.isfinite(ours).all()
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-5, atol=1e-6)


def _mip_model_cfg(**kw):
    def ff(n):
        return {"module": "network.model.FourierFeatures", "n_freq_bands": n}

    cfg = {"module": "network.model.ParamNerf",
           "pos_embedding": {"module": "network.model.IntegratedPositionalEncoding",
                             "n_freq_bands": 4},
           "dir_embedding": ff(2), "param_embedding": ff(2), "n_pos": 6, "n_parameters": [1, 3],
           "depth": 2, "width": 32, "skips": [0]}
    cfg.update(kw)
    return cfg


N_POS6_EXTRAS = [
    {},
    {"embedding_config": {"module": "network.layer.FourierFeatures", "n_freq_bands": 2}},
    {"embedding_config": {"module": "network.model.FourierFeatures", "n_freq_bands": 1},
     "include_param_dims": True},
]


def _n_pos6_inputs():
    rs = np.random.RandomState(5)
    pos = np.concatenate([rs.uniform(-1, 1, (200, 3)), rs.uniform(0, 0.02, (200, 3))],
                         -1).astype(np.float32)
    dirs = rs.normal(size=(200, 3)).astype(np.float32)
    prm = rs.uniform(0, 1, (200, 4)).astype(np.float32)
    return pos, dirs, prm


def _jax_n_pos6(extra):
    """The JAX model's init and its apply on _n_pos6_inputs()."""
    _reset()
    jm = jax_util.instantiate(jax_util.EasyDict(_mip_model_cfg(**extra)))["model"]
    c_j, d_j = (np.asarray(v) for v in jm.apply(jm.params, *_n_pos6_inputs()))
    return {**{f"weights/{k}": v for k, v in flatten_params(
        jax.tree.map(np.asarray, jm.params)).items()}, "color": c_j, "density": d_j}


@pytest.mark.parametrize("extra", N_POS6_EXTRAS)
def test_param_nerf_n_pos6_matches_jax_apply(extra):
    """forward and infer (the fused kernel's plain version) against the JAX
    model's apply, with the extra features after the position encoding.
    (The JAX package's Pallas wrapper drops them; apply is the reference.)"""
    cfg = _mip_model_cfg(**extra)
    case = f"extra{N_POS6_EXTRAS.index(extra)}"
    want = recorded(MODULE, f"test_param_nerf_n_pos6_matches_jax_apply[{case}]")
    _reset()
    tm = instantiate(cfg, device="cpu")
    load_jax_params(tm, group(want, "weights/"))
    # IPE 4 x 6, then 6 x 5 or 10 x 3 extra features, then Length 5.
    assert tm.pos_dim == 24 + (30 if extra else 0) + 5 and tm.dir_dim == 15 + 15
    pos, dirs, prm = _n_pos6_inputs()
    c_j, d_j = want["color"], want["density"]
    args = (torch.tensor(pos), torch.tensor(dirs), torch.tensor(prm))
    with torch.no_grad():
        c_f, d_f = tm(*args)
    c_i, d_i = tm.infer(*args)
    # tests/test_torch_models.py's float32 pin.
    for got, want in ((c_f, c_j), (d_f, d_j), (c_i, c_j), (d_i, d_j)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


# -- MipRenderer ---------------------------------------------------------------------


def _train_cfg(tfr, target, n_iters=N_ITERS, importance=False, device_resident=False):
    """configs/demo_grass_mip_train.py (or its _imp variant) cut to CPU
    size: the model as _cut_model, 2 x 8 rays of 16 segments (16 importance
    posts), 8x8 validation renders; every step logged; optionally with the
    training data resident on the device."""
    name = "demo_grass_mip_imp_train" if importance else "demo_grass_mip_train"
    cfg = _cut_model(copy.deepcopy(importlib.import_module(f"configs.{name}").config))
    cfg.update(target_path=str(target), n_iters=n_iters)
    data = cfg["train_dataset_config"]
    data["data_loader_config"]["tfr_path"] = str(tfr)
    data.update(batchsize=2, shuffle_buffer_size=8, prefetch=0)
    if device_resident:
        data["device_resident"] = True
    data["pixel_sampler_config"].update(n_samples=8, downsample_factor=2)
    cfg["val_dataset_config"]["data_loader_config"].update(height=8, width=8)
    cfg["val_dataset_config"]["prefetch"] = 0
    cfg["renderer_config"]["n_samples"] = 16
    if importance:
        cfg["renderer_config"]["n_importance"] = 16
    cfg["logger_config"].update(i_summary=1, i_img=n_iters, i_checkpoint=n_iters)
    return cfg


def _synthetic_tfr(directory):
    """A synthetic TFRecord with the grass dataset's 5 parameters."""
    cfg = importlib.import_module("configs.demo_grass_mip_train").config
    proxy = cfg["train_dataset_config"]["proxy_config"]
    path = os.path.join(str(directory), "train.tfr")
    jax_synth(path, n_images=6, size=16, n_parameters=(2, 3), b_0=tuple(proxy["b_0"]),
              b_1=tuple(proxy["b_1"]))
    return path


@pytest.fixture(scope="module")
def tfr(tmp_path_factory):
    return _synthetic_tfr(tmp_path_factory.mktemp("data"))


def _losses(target):
    with open(os.path.join(target, "scalars.jsonl")) as f:
        return [json.loads(line)["Loss"] for line in f]


def _files(root):
    """Every file under ``root``, "/"-joined relative paths, sorted."""
    return sorted(os.path.relpath(os.path.join(d, f), root).replace(os.sep, "/")
                  for d, _, names in os.walk(root) for f in names)


def _jax_train(variant):
    """JAX's Train, op by op, on the cut config of ``variant``: its logged
    losses and the files it wrote under media/."""
    with tempfile.TemporaryDirectory() as tmp:
        cfg = _train_cfg(_synthetic_tfr(tmp), os.path.join(tmp, "jax"),
                         n_iters=5 if variant == "device_resident" else N_ITERS,
                         importance=variant == "importance",
                         device_resident=variant == "device_resident")
        _reset()
        with jax.disable_jit():
            jax_util.instantiate(jax_util.EasyDict(cfg))
        return {"losses": np.array(_losses(cfg["target_path"])),
                "media": np.array(_files(os.path.join(cfg["target_path"], "media")))}


@pytest.mark.parametrize("variant", ["plain", "importance", "device_resident"])
def test_train_through_main_matches_jax_losses(tfr, tmp_path, variant):
    """Ten steps of nerftex_torch.main on the cut config against ten of
    JAX's Train, op by op: the MipRenderer's fence posts, blur splice, cone
    Gaussians, IPE and repeat_last_dist=False compositing, and with
    mip_importance the resampled posts and the AlphaLoss coarse terms; and
    five steps with the training data resident on the device (the fused
    step, sampled on the device, with a MipRenderer).  Measured: 2.9e-6
    and 3.0e-6 relative over ten steps (the classic path reads 5.1e-5,
    tests/test_torch_train.py)."""
    importance = variant == "importance"
    n_iters = 5 if variant == "device_resident" else N_ITERS
    want = recorded(MODULE, f"test_train_through_main_matches_jax_losses[{variant}]")
    cfg = _train_cfg(tfr, tmp_path / "port", n_iters=n_iters, importance=importance,
                     device_resident=variant == "device_resident")
    _reset()
    module = f"_cut_mip_train_{variant}"
    (tmp_path / f"{module}.py").write_text(f"config = {cfg!r}\n")
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        port_main.main([f"{module}.py", "--device", "cpu"])
    finally:
        os.chdir(cwd)
        sys.modules.pop(module, None)
        if str(tmp_path) in sys.path:
            sys.path.remove(str(tmp_path))
    got = _losses(cfg["target_path"])
    assert len(got) == len(want["losses"]) == n_iters
    np.testing.assert_allclose(got, want["losses"], rtol=LOSS_RTOL, atol=0)
    assert f"validation/{n_iters}/0.png" in list(want["media"])
    assert (tmp_path / "port" / "media" / "validation" / str(n_iters) / "0.png").exists()


def _mip_renderer_cfgs(importance=False, **kw):
    """The cut demo_grass_mip_train model's config and a MipRenderer's."""
    cfg = _cut_model(copy.deepcopy(importlib.import_module("configs.demo_grass_mip_train")
                                   .config))
    rcfg = dict(cfg["renderer_config"], n_samples=16, **kw)
    if importance:
        rcfg.update(n_importance=16, mip_importance=True)
    return cfg["model_config"], rcfg


def _jax_mip_renderer(importance=False, **kw):
    model_cfg, rcfg = _mip_renderer_cfgs(importance, **kw)
    _reset()
    jm = jax_util.instantiate(jax_util.EasyDict(model_cfg))["model"]
    return jax_util.instantiate(jax_util.EasyDict(dict(rcfg, model=jm)))


def _jax_mip_weights():
    return {f"weights/{k}": v for k, v in flatten_params(
        jax.tree.map(np.asarray, _jax_mip_renderer().model.params)).items()}


def _mip_renderer(importance=False, **kw):
    """The port's MipRenderer of the cut demo_grass_mip_train model with
    the JAX init's weights."""
    model_cfg, rcfg = _mip_renderer_cfgs(importance, **kw)
    _reset()
    tm = instantiate(model_cfg, device="cpu")
    load_jax_params(tm, group(recorded(MODULE, "mip_renderer"), "weights/"))
    tr = instantiate(dict(rcfg, model=tm, device="cpu"))
    assert tr.blur_idx is None and tr.blur_idx_mip == 0
    return tr


def _rays(n_rays=12, seed=6):
    rs = np.random.RandomState(seed)
    t = np.tile([3.0, 6.0], (1, n_rays, 1)).astype(np.float32)
    t[0, :3] = np.inf  # proxy-missing rays
    return {
        "rays_o": (rs.randn(1, n_rays, 3) * 0.3 + [0, 0, 4.5]).astype(np.float32),
        "rays_d": (np.tile([0, 0, -1.0], (1, n_rays, 1)) + rs.randn(1, n_rays, 3) * 0.05)
        .astype(np.float32),
        "t": t,
        "parameters": np.array([[0.7, 0.4, 0.3, 0.2, -0.93]], np.float32),
        "cone_scale": np.full((1, n_rays, 1), 0.002, np.float32),
    }


@pytest.mark.parametrize("importance", [False, True])
def test_mip_renderer_eval_render_matches_jax(importance):
    """Renderer.__call__ (infer, the fused kernel's plain version) against
    the JAX MipRenderer under one key; with mip_importance the
    deterministic resample of an eval render (det = not training).
    Measured: within 2.4e-7."""
    tr = _mip_renderer(importance)
    data = _rays()
    want = recorded(MODULE, f"test_mip_renderer_eval_render_matches_jax[{importance}]")
    got = tr(**data, training=False, key=jax_rng.key(7))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-5,
                                   err_msg=k)
    assert np.all(got["alpha_pred"].numpy()[0, :3] == 0)


def _jax_eval_render(importance):
    want = _jax_mip_renderer(importance)(**_rays(), training=False, key=jax.random.key(7))
    return {k: np.asarray(v) for k, v in want.items()}


def test_mip_renderer_refuses_importance_without_opt_in():
    tr = _mip_renderer(n_importance=16)
    with pytest.raises(NotImplementedError):
        tr(**_rays(), key=jax_rng.key(0))


_MIP_LOSS = importlib.import_module("configs.demo_grass_mip_train").config["loss_config"]


def _miss_batch():
    data = _rays(16, seed=8)
    rs = np.random.RandomState(9)
    data["color"] = rs.rand(1, 16, 3).astype(np.float32)
    data["alpha"] = (rs.rand(1, 16) > 0.4).astype(np.float32)
    return data


def _jax_miss_step(importance):
    """JAX's training loss on _miss_batch() under key(3) and its gradient
    of trunk/0/w."""
    jr = _jax_mip_renderer(importance, raw_noise_std=0.1)
    jl = jax_util.instantiate(jax_util.EasyDict(_MIP_LOSS))
    data = _miss_batch()

    def loss_of(params):
        pred = jr.apply(params, {k: jnp.asarray(v) for k, v in data.items()},
                        jax.random.key(3), training=True)
        return jl(color_true=data["color"], alpha_true=data["alpha"], **pred)

    jloss, jgrad = jax.jit(jax.value_and_grad(loss_of))({"model": jr.model.params})
    return {"loss": np.asarray(jloss),
            "grad/trunk/0/w": np.asarray(jgrad["model"]["trunk"][0]["w"])}


@pytest.mark.parametrize("importance", [False, True])
def test_mip_training_finite_with_miss_rays(importance):
    """Proxy-missing rays (t = inf, zeroed to mu = hw = 0) leave the loss
    and every gradient finite, and the step is JAX's (tests/
    test_more_paths.py's regression, here against the same step in JAX)."""
    tr = _mip_renderer(importance, raw_noise_std=0.1)
    tl = instantiate(_MIP_LOSS)
    data = _miss_batch()
    want = recorded(MODULE, f"test_mip_training_finite_with_miss_rays[{importance}]")
    jloss = want["loss"]
    tb = {k: torch.as_tensor(v) for k, v in data.items()}
    pred = tr.apply(tb, jax_rng.key(3), training=True)
    loss = tl(color_true=tb["color"], alpha_true=tb["alpha"], **pred)
    loss.backward()
    assert np.isfinite(float(loss.detach()))
    grads = [p.grad for p in tr.model.parameters()]
    assert all(torch.isfinite(g).all() for g in grads)
    # tests/test_torch_train.py's one-step pins: 1e-6 relative loss.
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-6)
    want = want["grad/trunk/0/w"]
    np.testing.assert_allclose(tr.model.trunk[0].weight.grad.numpy().T, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


# -- MipInstanceRenderer, RenderSession, main ------------------------------------------


def _render_cfg(size=None):
    """configs/demo_grass_mip_render.py with absolute mesh paths, the cut
    model and, given a size, frames of size x size."""
    cfg = _cut_model(copy.deepcopy(importlib.import_module("configs.demo_grass_mip_render")
                                   .config))
    inst = cfg["renderer_config"]["instancer_config"]
    for k in ("mesh_path", "patch_origins_path"):
        inst[k] = os.path.join(ROOT, inst[k])
    if size:
        cfg["test_dataset_config"]["data_loader_config"].update(height=size, width=size)
    return cfg


def _mip_instance_setup():
    """The cut demo_grass_mip_render config at 24x24 and its renderer
    config with 64-ray blocks and max_hits 32."""
    cfg = _render_cfg(size=H)
    rcfg = dict(cfg["renderer_config"], render_chunk=4096, net_chunk=8192)
    rcfg["instancer_config"] = dict(rcfg["instancer_config"], ray_block=64, max_hits=32)
    return cfg, rcfg


def _jax_mip_instance_frame():
    """The test dataset's last item, the JAX model's weights and the JAX
    sorted MipInstanceRenderer's frame of it under key(1)."""
    cfg, rcfg = _mip_instance_setup()
    jax_streams.set_seed(0)
    data = list(jax_util.instantiate(jax_util.EasyDict(cfg["test_dataset_config"])))[-1]
    _reset()
    jm = jax_util.instantiate(jax_util.EasyDict(cfg["model_config"]))["model"]
    jr = jax_util.instantiate(jax_util.EasyDict(dict(rcfg, model=jm)))
    want = jr(**data, training=False, key=jax.random.key(1))
    return {**{f"data/{k}": np.asarray(v) for k, v in data.items()},
            **{f"weights/{k}": v for k, v in flatten_params(
                jax.tree.map(np.asarray, jm.params)).items()},
            "color": np.asarray(want["color_pred"]), "alpha": np.asarray(want["alpha_pred"])}


def test_mip_instance_frame_matches_jax():
    """The demo_grass_mip_render test dataset's last item (radius 5) at
    24x24 with 64-ray blocks and max_hits 32 (both sides drop the same
    intervals), the same key and weights: the JAX sorted
    MipInstanceRenderer against the port's.  tests/test_torch_main.py's
    float32 frame gates; measured 142.2 dB, max error 8.0e-7."""
    cfg, rcfg = _mip_instance_setup()
    want = recorded(MODULE, "test_mip_instance_frame_matches_jax")
    data = group(want, "data/")
    _reset()
    tm = instantiate(cfg["model_config"], device="cpu")
    load_jax_params(tm, group(want, "weights/"))
    tr = instantiate(dict(rcfg, model=tm, device="cpu"))
    assert tr.blur_idx is None and tr.blur_idx_mip == 0
    got = tr(**data, key=jax_rng.key(1))
    c_j, a_j = want["color"], want["alpha"]
    c_t, a_t = got["color_pred"].numpy(), got["alpha_pred"].numpy()
    assert c_t.shape == c_j.shape == (1, H * W, 3)
    assert a_j.max() > 0.3 and (a_j > 0.05).mean() > 0.1
    err = np.maximum(np.abs(c_t - c_j).max(-1), np.abs(a_t - a_j))
    assert _psnr(c_t, a_t, c_j, a_j) >= 60
    assert np.mean(err > 1e-3) <= 0.02
    assert err.max() <= 3e-2


def test_render_session_serves_the_direct_render(tmp_path):
    """RenderSession on demo_grass_mip_render at 16x16 (a checkpoint of the
    cut model): its first frame is a direct MipInstanceRenderer render of
    the same rays under stream_key(STREAM_PERTURB, 0)."""
    from nerftex_torch.render.checkpoint import CheckpointManager, export_jax_params
    from nerftex_torch.render.serve import RenderSession, straight_rgba

    cfg = _render_cfg(size=RENDER_SIZE)
    cfg["renderer_config"]["instancer_config"].update(ray_block=64, max_hits=32)
    cfg["target_path"] = str(tmp_path)
    _reset(3)
    model = instantiate(cfg["model_config"], device="cpu")
    CheckpointManager(str(tmp_path / "checkpoints")).save(
        {"models": {"model": export_jax_params(model)}, "extra": {"step": 1}}, 1)
    session = RenderSession(cfg, device="cpu")
    assert type(session.renderer).__name__ == "MipInstanceRenderer"
    img = session.render([0.3, -0.74, 0.6], radius=5.0)
    rays_o, rays_d, t, cone = session.device_rays(session.pose([0.3, -0.74, 0.6], radius=5.0))
    out = session.renderer(rays_o=rays_o[None], rays_d=rays_d[None], t=t[None],
                           parameters=session.default_parameters[None], cone_scale=cone[None],
                           key=rng.stream_key(rng.STREAM_PERTURB, 0))
    want = straight_rgba(out["color_pred"][0].numpy(), out["alpha_pred"][0].numpy(),
                         RENDER_SIZE, RENDER_SIZE)
    assert img.shape == (RENDER_SIZE, RENDER_SIZE, 4) and img[..., 3].max() > 0.1
    np.testing.assert_allclose(img, want, rtol=0, atol=1e-6)


def test_main_trains_and_renders_the_mip_demo_without_jax(tmp_path):
    """The user's sequence, cut to CPU size: nerftex_torch.main trains
    demo_grass_mip_train three steps on a synthetic TFRecord, then renders
    demo_grass_mip_render (16x16, five frames) from the checkpoint it wrote
    (both configs' target_path), with jax, optax and nerftex_tpu blocked."""
    cut = (
        "import copy\n"
        "from configs.{name} import config as _config\n"
        "config = copy.deepcopy(_config)\n"
        "config['target_path'] = 'logs/grass_mip'\n"
        "model = config['model_config']\n"
        "model.update(depth=2, width=32, skips=[0])\n"
        "model['pos_embedding'] = dict(model['pos_embedding'], n_freq_bands=4)\n"
        "model['dir_embedding'] = dict(model['dir_embedding'], n_freq_bands=2)\n"
        "model['param_embedding'] = dict(model['param_embedding'], n_freq_bands=2)\n")
    train = cut.format(name="demo_grass_mip_train") + (
        "from nerftex_torch.tools.synth import make_synthetic_tfrecord\n"
        "proxy = config['train_dataset_config']['proxy_config']\n"
        "tfr = make_synthetic_tfrecord('train.tfr', n_images=4, size=16, n_parameters=(2, 3), "
        "b_0=tuple(proxy['b_0']), b_1=tuple(proxy['b_1']))\n"
        "config['n_iters'] = 3\n"
        "config['train_dataset_config']['data_loader_config']['tfr_path'] = tfr\n"
        "config['train_dataset_config']['pixel_sampler_config'].update(n_samples=8, "
        "downsample_factor=2)\n"
        "config['val_dataset_config']['data_loader_config'].update(height=8, width=8)\n"
        "config['renderer_config']['n_samples'] = 8\n"
        "config['logger_config'].update(i_summary=1, i_img=3, i_checkpoint=3)\n")
    render = cut.format(name="demo_grass_mip_render") + (
        "import os\n"
        "config['test_dataset_config']['data_loader_config'].update(height=16, width=16)\n"
        "inst = config['renderer_config']['instancer_config']\n"
        "inst.update(ray_block=64, max_hits=32)\n"
        f"for k in ('mesh_path', 'patch_origins_path'):\n"
        f"    inst[k] = os.path.join({ROOT!r}, inst[k])\n")
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'optax', 'nerftex_tpu'):\n"
        "    sys.modules[name] = None\n"
        "from nerftex_torch import main\n"
        "main.main(['train_cfg.py', '--device', 'cpu'])\n"
        "main.main(['render_cfg.py', '--device', 'cpu'])\n"
        "print('loaded', sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'nerftex_tpu', 'optax') and sys.modules[m] is not None))\n")
    (tmp_path / "train_cfg.py").write_text(train)
    (tmp_path / "render_cfg.py").write_text(render)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          env=dict(os.environ, PYTHONPATH=ROOT, NERFTEX_NO_TENSORBOARD="1"),
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert lines[-1] == "loaded []", lines
    logs = tmp_path / "logs" / "grass_mip"
    losses = _losses(str(logs))
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert (logs / "checkpoints" / "ckpt-3.pkl").exists()
    assert any("Restored model from " in line and "ckpt-3.pkl" in line for line in lines), lines
    names = sorted(os.listdir(logs / "media" / "test"))
    assert names == [f"{i}.png" for i in range(5)]


JAX_CASES = {
    **{f"test_param_nerf_n_pos6_matches_jax_apply[extra{i}]": (lambda e=e: _jax_n_pos6(e))
       for i, e in enumerate(N_POS6_EXTRAS)},
    "mip_renderer": _jax_mip_weights,
    **{f"test_mip_renderer_eval_render_matches_jax[{imp}]": (lambda imp=imp: _jax_eval_render(imp))
       for imp in (False, True)},
    **{f"test_mip_training_finite_with_miss_rays[{imp}]": (lambda imp=imp: _jax_miss_step(imp))
       for imp in (False, True)},
    **{f"test_train_through_main_matches_jax_losses[{v}]": (lambda v=v: _jax_train(v))
       for v in ("plain", "importance", "device_resident")},
    "test_mip_instance_frame_matches_jax": _jax_mip_instance_frame,
}
