"""The device-resident training path of nerftex_torch against the JAX
package's, on the same seed-made inputs and the JAX init weights, at small
size (16x16 swatches, downsample 2, depth 3, width 64; the
tests/test_train_e2e.py config):

- utils.jax_rng with keys and steps as tensors, and randint, against
  jax.random bit for bit;
- DeviceResidentSampler against the JAX sampler's ``sample_from`` under
  the same key (u8 and float stores, Proxy/Frustum and Independent
  modes, the three rejections, the max_bytes cap);
- FusedStep against ``make_fused_train_step``: loss, gradient per leaf and
  parameters after three steps;
- steps_per_dispatch, flat_params (the step, resume across a layout
  switch, a JAX checkpoint with flat parameters), cast_params_once and
  net_chunk_unroll;
- Train end to end with device_resident against JAX's, and a resume.

The JAX references run op by op (jax.disable_jit()): the port follows the
op-by-op step, which JAX's own jitted step leaves by up to 5.4e-4 within
ten steps (tests/test_torch_train.py)."""

import copy
import json
import os
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerftex_tpu.models.mlp as jax_mlp
from nerftex_tpu.data.device_dataset import DeviceResidentSampler as JaxSampler
from nerftex_tpu.data.pixel_sampler import Independent as JaxIndependent
from nerftex_tpu.data.ray_sampler import Frustum as JaxFrustum
from nerftex_tpu.render.renderer import Renderer as JaxRenderer
from nerftex_tpu.render.train import (make_fused_train_step as jax_fused_step,
                                      make_optimizer as jax_make_optimizer)
from nerftex_tpu.tools.synth import make_synthetic_tfrecord as jax_synth
from nerftex_tpu.utils import rng as jax_streams
from nerftex_tpu.utils import util as jax_util
from nerftex_torch.data.dataset import ListSource
from nerftex_torch.data.device_dataset import DeviceResidentSampler
from nerftex_torch.data.pixel_sampler import Full, Independent
from nerftex_torch.data.ray_sampler import Frustum
from nerftex_torch.models import mlp as port_mlp
from nerftex_torch.render import train as port_train
from nerftex_torch.render.checkpoint import (CheckpointManager, as_jax_tree, export_jax_params,
                                             flatten_params, load_jax_params)
from nerftex_torch.render.renderer import Renderer
from nerftex_torch.utils import jax_rng, rng
from nerftex_torch.utils.util import instantiate

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _jax_reference import file_bytes, group, recorded  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401
from test_train_e2e import _train_config  # noqa: E402

MODULE = "test_torch_device_train"

SEEDS = (0, 42, 0xFFFFFFFF)
# The JAX test's tolerances (tests/test_device_dataset.py): rays, t,
# cone_scale, and the u8 decode (XLA folds / 255 into a reciprocal multiply).
RAYS_TOL, T_TOL, CONE_TOL, COLOR_TOL = 1e-6, 1e-5, 1e-7, 4e-7
LOSS_RTOL = 1e-6        # a step's loss (tests/test_torch_train.py)
GRAD_TOL = 1e-5         # a step's gradient, times the leaf's max |g| (the same)
PARAM_TOL = 1e-5        # parameters after three Adam steps at lrate 5e-3 (+-lrate
                        # moves only where rounding flips a near-zero gradient's sign)


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    monkeypatch.setenv("NERFTEX_NO_TENSORBOARD", "1")


def _reset(seed=0):
    jax_streams.set_seed(seed)
    rng.set_seed(seed)
    jax_mlp._INIT_COUNTER[0] = 0
    port_mlp._INIT_COUNTER[0] = 0


def _data(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


# -- the random streams --------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_tensor_keys_draw_the_int_keys_bits(seed):
    """fold_in with a 0-d step tensor, split and uniform under a key that
    is a tensor derived without reading it back: the int-key API's bits and
    jax.random's."""
    k, tk = jax.random.key(seed), jax_rng.key(seed)
    for step in (0, 7, 0x7FFFFFFF):
        want = _data(jax.random.fold_in(k, step))
        np.testing.assert_array_equal(jax_rng.fold_in(tk, step).numpy(), want)
        np.testing.assert_array_equal(
            jax_rng.fold_in(tk, torch.tensor(step, dtype=torch.int64)).numpy(), want)
    step_key = jax_rng.fold_in(tk, torch.tensor(3))
    np.testing.assert_array_equal(jax_rng.split(step_key, 3).numpy(),
                                  _data(jax.random.split(jax.random.fold_in(k, 3), 3)))
    np.testing.assert_array_equal(jax_rng.uniform(step_key, (4, 5)).numpy(),
                                  np.asarray(jax.random.uniform(jax.random.fold_in(k, 3), (4, 5))))
    np.testing.assert_array_equal(jax_rng.uniform(step_key, (4, 5)).numpy(),
                                  jax_rng.uniform(jax_rng.fold_in(tk, 3), (4, 5)).numpy())


@pytest.mark.parametrize("span", [1, 2, 3, 7, 16, 100, 5000, 65537, 2**31 - 1])
def test_randint_matches_jax(span):
    for seed in SEEDS:
        for shape in ((5,), (3, 4, 2)):
            want = np.asarray(jax.random.randint(jax.random.key(seed), shape, 0, span))
            got = jax_rng.randint(jax_rng.key(seed), shape, 0, span)
            assert got.shape == shape
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{seed} {shape}")
    lo = -4 if span > 2**30 else 4  # a range that int32 holds
    want = np.asarray(jax.random.randint(jax.random.key(1), (6,), lo, lo + span))
    np.testing.assert_array_equal(jax_rng.randint(jax_rng.key(1), (6,), lo, lo + span).numpy(),
                                  want)


# -- the sampler ----------------------------------------------------------------------


def _synthetic_tfr(directory):
    path = os.path.join(str(directory), "train.tfr")
    jax_synth(path, n_images=6, size=16)
    return path


@pytest.fixture(scope="module")
def tfr(tmp_path_factory):
    return _synthetic_tfr(tmp_path_factory.mktemp("data"))


def _dataset_cfg(tfr_path, n_samples=32, batchsize=2):
    cfg = _train_config(tfr_path, "unused")["train_dataset_config"]
    cfg["pixel_sampler_config"]["n_samples"] = n_samples
    cfg.update(batchsize=batchsize, device_resident=True)
    return cfg


def _jax_sampler(seed):
    """The JAX device sampler's tables and store, and its batch and aux
    under key(seed)."""
    with tempfile.TemporaryDirectory() as tmp:
        _reset()
        js = jax_util.instantiate(jax_util.EasyDict(_dataset_cfg(_synthetic_tfr(tmp))))
    js = js.device_sampler
    batch, aux = js.sample(jax.random.key(seed), with_aux=True)
    return {"store": np.array(js._store),
            **{f"table/{k}": np.asarray(getattr(js, k))
               for k in ("cells", "counts", "poses", "parameters", "images")},
            **{f"batch/{k}": np.asarray(v) for k, v in batch.items()},
            **{f"aux/{k}": np.asarray(aux[k]) for k in ("img_idx", "loc")}}


def _compare_batches(jax_out, port_out, color_tol=COLOR_TOL):
    (jb, jaux), (tb, taux) = jax_out, port_out
    np.testing.assert_array_equal(taux["img_idx"].numpy(), np.asarray(jaux["img_idx"]))
    np.testing.assert_array_equal(taux["loc"].numpy(), np.asarray(jaux["loc"]))
    tols = {"rays_o": RAYS_TOL, "rays_d": RAYS_TOL, "t": T_TOL, "cone_scale": CONE_TOL,
            "color": color_tol, "alpha": color_tol, "parameters": 0}
    assert set(tb) == set(jb)
    for name, tol in tols.items():
        assert tuple(tb[name].shape) == tuple(jb[name].shape), name
        np.testing.assert_allclose(tb[name].numpy(), np.asarray(jb[name]), rtol=0, atol=tol,
                                   err_msg=name)


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_sampler_matches_jax(tfr, seed):
    """The u8 store with Proxy pixels and rays, under the same key."""
    want = recorded(MODULE, f"test_sampler_matches_jax[{seed}]")
    _reset()
    ts = instantiate(_dataset_cfg(tfr), device="cpu").device_sampler
    assert ts._store == str(want["store"]) == "u8"
    tables = group(want, "table/")
    for name in ("cells", "counts", "poses", "parameters"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(), tables[name])
    np.testing.assert_array_equal(ts.images.numpy(), tables["images"])
    _compare_batches((group(want, "batch/"), group(want, "aux/")),
                     ts.sample(jax_rng.key(seed), with_aux=True))


def _list_source(rs, n=3, size=8):
    from nerftex_tpu.data.dataset import look_at_np

    return [{"image": rs.rand(size, size, 3).astype(np.float32),
             "alpha": rs.rand(size, size).astype(np.float32),
             "pose": look_at_np(np.array([0.4, -0.6, 0.7]) * 5.0),
             "parameters": rs.rand(2).astype(np.float32)} for _ in range(n)]


SAMPLER_ARGS = dict(batchsize=2, height=8, width=8, focal=10.0, composite_bkgd=False,
                    bkgd_color=[1, 1, 1.0])
PIXELS = dict(height=8, width=8, n_samples=16)
FRUSTUM = dict(height=8, width=8, focal=10.0, near=1.0, far=7.0)


def test_sampler_float_store_independent_frustum():
    """Float images (a ListSource) with Independent pixels and Frustum rays."""
    from nerftex_tpu.data.dataset import ListSource as JaxListSource

    records = _list_source(np.random.RandomState(3))
    js = JaxSampler(JaxListSource(records), JaxIndependent(**PIXELS), JaxFrustum(**FRUSTUM),
                    **SAMPLER_ARGS)
    ts = DeviceResidentSampler(ListSource(records), Independent(**PIXELS), Frustum(**FRUSTUM),
                               **SAMPLER_ARGS, device="cpu")
    assert ts._store == js._store == "f32"
    _compare_batches(js.sample(jax.random.key(0), with_aux=True),
                     ts.sample(jax_rng.key(0), with_aux=True), color_tol=0)


def test_sampler_rejections_and_cap(tmp_path, tfr):
    """A Proxy grid that does not divide the image, a pixel sampler or a
    ray sampler the sampler does not take, and data over max_bytes (u8
    and float stores) raise ValueError, as in the JAX package."""
    odd = str(tmp_path / "odd.tfr")
    jax_synth(odd, n_images=1, size=15)
    with pytest.raises(ValueError, match="divisible"):
        instantiate(_dataset_cfg(odd), device="cpu")
    source = ListSource(_list_source(np.random.RandomState(0)))
    args = dict(SAMPLER_ARGS, device="cpu")
    with pytest.raises(ValueError, match="pixel samplers"):
        DeviceResidentSampler(source, Full(height=8, width=8), Frustum(**FRUSTUM), **args)
    with pytest.raises(ValueError, match="ray samplers"):
        DeviceResidentSampler(source, Independent(**PIXELS), object(), **args)
    f32_bytes = 3 * 8 * 8 * 4 * 4
    with pytest.raises(ValueError, match="cap"):
        DeviceResidentSampler(source, Independent(**PIXELS), Frustum(**FRUSTUM),
                              max_bytes=f32_bytes - 1, **args)
    DeviceResidentSampler(source, Independent(**PIXELS), Frustum(**FRUSTUM),
                          max_bytes=f32_bytes, **args)
    cfg = _dataset_cfg(tfr)
    tfr_source = instantiate(cfg["data_loader_config"])[0]
    u8_bytes = 6 * 16 * 16 * 4
    for cap in (u8_bytes - 1, u8_bytes):
        call = lambda: DeviceResidentSampler(  # noqa: E731
            tfr_source, Independent(16, 16, 8), Frustum(16, 16, 10.0, 1.0, 7.0),
            **dict(args, height=16, width=16, max_bytes=cap))
        if cap < u8_bytes:
            with pytest.raises(ValueError, match="cap"):
                call()
        else:
            assert call()._store == "u8"


# -- the fused step -------------------------------------------------------------------


def _cfg(tfr_path, target="unused", n_iters=20, **overrides):
    cfg = _train_config(tfr_path, target, n_iters=n_iters)
    cfg["train_dataset_config"]["device_resident"] = True
    cfg["logger_config"]["i_img"] = 10**9
    cfg.update(overrides)
    return cfg


def _jax_steps(n_steps):
    """JAX's fused step, op by op, from the JAX init: the losses, step 0's
    gradient per leaf and the parameters after n_steps."""
    with tempfile.TemporaryDirectory() as tmp:
        return _jax_steps_on(_synthetic_tfr(tmp), n_steps)


def _jax_steps_on(tfr_path, n_steps):
    cfg = jax_util.EasyDict(_cfg(tfr_path))
    _reset()
    sampler = jax_util.instantiate(cfg.train_dataset_config).device_sampler
    models = jax_util.instantiate(jax_util.EasyDict(dict(cfg.model_config, n_parameters=[1, 6])))
    renderer = jax_util.instantiate(jax_util.EasyDict(dict(cfg.renderer_config, **models)))
    loss_fn = jax_util.instantiate(cfg.loss_config)
    optimizer = jax_make_optimizer(cfg.lrate, cfg.lrate_decay)
    step = jax_fused_step(renderer, loss_fn, optimizer, sampler, False, [1, 1, 1.0], donate=False)
    params = {k: m.params for k, m in models.items()}
    opt_state = optimizer.init(params)
    data_key = jax_streams.stream_key(jax_streams.STREAM_DATA)
    perturb_key = jax_streams.stream_key(jax_streams.STREAM_PERTURB)

    def loss_of(p, s):
        batch = sampler.sample_from(sampler.tables, jax.random.fold_in(data_key, s))
        pred = renderer.apply(p, batch, jax.random.fold_in(perturb_key, s))
        return loss_fn(color_true=batch["color"], alpha_true=batch["alpha"], **pred)

    losses = []
    with jax.disable_jit():
        _, grads = jax.value_and_grad(loss_of)(params, 0)
        for s in range(n_steps):
            params, opt_state, loss = step(params, opt_state, sampler.tables,
                                           jax.random.fold_in(data_key, s),
                                           jax.random.fold_in(perturb_key, s))
            losses.append(float(loss))
    return {"losses": np.array(losses),
            **{f"grad/{k}": v for k, v in flatten_params(
                jax.tree.map(np.asarray, grads["model"])).items()},
            **{f"param/{k}": v for k, v in flatten_params(
                jax.tree.map(np.asarray, params["model"])).items()}}


def _port_step(tfr_path, flat=False, max_steps=3, **renderer):
    cfg = _cfg(tfr_path)
    cfg["renderer_config"].update(renderer)
    _reset()
    state = port_train.TrainState()
    _, models, _, step = port_train.build_step(
        cfg["train_dataset_config"], cfg["model_config"], cfg["loss_config"], cfg["lrate"],
        cfg["lrate_decay"], cfg["renderer_config"], torch.device("cpu"), state,
        flat_params=flat, steps_per_dispatch=max_steps)
    return models["model"], step


def _grads(model):
    if getattr(model, "flat", None) is not None:
        from nerftex_torch.render.checkpoint import _moment_tree

        return flatten_params(_moment_tree(model, model.flat.grad.numpy()))
    return flatten_params(as_jax_tree(model, lambda p: p.grad.numpy()))


def _params(model):
    return flatten_params(export_jax_params(model))


@pytest.fixture(scope="module")
def jax_three_steps():
    want = recorded(MODULE, "jax_three_steps")
    return list(want["losses"]), group(want, "grad/"), group(want, "param/")


@pytest.mark.parametrize("flat", [False, True])
def test_fused_step_matches_jax(tfr, jax_three_steps, flat):
    """Three device-resident steps from the JAX init, sampled on the device
    from the same keys: the losses, step 0's gradient per leaf and the
    parameters after three Adam updates (per-layer and flat parameters)."""
    want_losses, want_grads, want_params = jax_three_steps
    model, step = _port_step(tfr, flat=flat)
    losses = list(step.run(0, 1).numpy())
    grads = _grads(model)
    losses += list(step.run(1, 2).numpy())
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL if not flat else 1e-5)
    for leaf, g in want_grads.items():
        np.testing.assert_allclose(grads[leaf], g, rtol=0, atol=GRAD_TOL * np.abs(g).max(),
                                   err_msg=leaf)
    got = _params(model)
    for leaf, p in want_params.items():
        np.testing.assert_allclose(got[leaf], p, rtol=0, atol=PARAM_TOL, err_msg=leaf)
    assert int(step.step) == 3


def test_flat_step_equals_the_per_layer_step(tfr):
    """One flat parameter per model (views for the layers) takes the steps
    of the per-layer parameters, and Adam holds one state tensor."""
    ref_model, ref = _port_step(tfr, max_steps=4)
    flat_model, flat = _port_step(tfr, flat=True, max_steps=4)
    assert [n for n, _ in flat_model.named_parameters()] == ["flat"]
    np.testing.assert_allclose(flat.run(0, 4).numpy(), ref.run(0, 4).numpy(), rtol=1e-6)
    assert len(flat.optimizer.state) == 1
    want, got = _params(ref_model), _params(flat_model)
    for leaf in want:
        np.testing.assert_allclose(got[leaf], want[leaf], rtol=0, atol=1e-6, err_msg=leaf)


# -- cast_params_once and net_chunk_unroll ------------------------------------------------------


def _cast_batch(b=2, r=32, seed=0):
    """tests/test_cast_once.py's batch."""
    rs = np.random.RandomState(seed)
    d = rs.normal(size=(b, r, 3)).astype(np.float32)
    d[..., 2] = -np.abs(d[..., 2]) - 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return {"rays_o": np.tile([0, 0, 3.0], (b, r, 1)).astype(np.float32), "rays_d": d,
            "t": np.tile([1.0, 5.0], (b, r, 1)).astype(np.float32),
            "cone_scale": np.full((b, r, 1), 1e-3, np.float32),
            "parameters": rs.uniform(0, 1, (b, 7)).astype(np.float32),
            "color": rs.uniform(0, 1, (b, r, 3)).astype(np.float32),
            "alpha": rs.uniform(0, 1, (b, r)).astype(np.float32)}


def _model_cfg(dtype):
    return dict(_train_config("", "")["model_config"], compute_dtype=dtype)


def _port_loss_grads(dtype, remat=False, **renderer):
    """(loss, {leaf: grad}) of one render of _cast_batch in 4 net_chunks."""
    _reset()
    model = instantiate(_model_cfg(dtype), device="cpu")
    r = Renderer(model=model, n_samples=16, net_chunk=256, remat_net_chunks=remat,
                 perturb=True, device="cpu", **renderer)
    loss_fn = instantiate(_train_config("", "")["loss_config"])
    batch = {k: torch.tensor(v) for k, v in _cast_batch().items()}
    pred = r.apply(batch, jax_rng.key(7))
    loss = loss_fn(color_true=batch["color"], alpha_true=batch["alpha"], **pred)
    loss.backward()
    return float(loss.detach()), flatten_params(as_jax_tree(model, lambda p: p.grad.numpy()))


def test_cast_params_once_f32_is_bit_identical_and_unroll_changes_nothing():
    loss, grads = _port_loss_grads("float32")
    for kw in (dict(cast_params_once=True), dict(net_chunk_unroll=4),
               dict(cast_params_once=True, net_chunk_unroll=2)):
        loss_k, grads_k = _port_loss_grads("float32", **kw)
        assert loss_k == loss, kw
        for leaf, g in grads.items():
            np.testing.assert_array_equal(grads_k[leaf], g, err_msg=f"{kw} {leaf}")


def _jax_cast_once_bf16():
    """JAX's bf16 cast-once step with save_encodings remat: the loss and
    each leaf's gradient."""
    _reset()
    models = jax_util.instantiate(jax_util.EasyDict(_model_cfg("bfloat16")))
    jr = JaxRenderer(n_samples=16, net_chunk=256, remat_net_chunks="save_encodings",
                     cast_params_once=True, perturb=True, **models)
    loss_fn = jax_util.instantiate(jax_util.EasyDict(_train_config("", "")["loss_config"]))
    batch = {k: jnp.asarray(v) for k, v in _cast_batch().items()}

    def loss_of(params):
        pred = jr.apply(params, batch, jax.random.key(7), training=True)
        return loss_fn(color_true=batch["color"], alpha_true=batch["alpha"], **pred)

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_of))({k: m.params for k, m in models.items()})
    return {"loss": np.asarray(jloss),
            **{f"grad/{k}": v for k, v in flatten_params(
                jax.tree.map(np.asarray, jgrads["model"])).items()}}


def test_cast_params_once_bf16_matches_jax():
    """bf16 with save_encodings remat: the port's cast-once step against
    JAX's, within tests/test_cast_once.py's tolerances (the loss to bf16
    resolution, 1e-2; gradients 3e-2 of the leaf's max |g|, the bf16 sums
    over four chunks)."""
    want = recorded(MODULE, "test_cast_params_once_bf16_matches_jax")
    jloss, jgrads = want["loss"], group(want, "grad/")
    loss, grads = _port_loss_grads("bfloat16", remat="save_encodings", cast_params_once=True)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-2)
    for leaf, g in jgrads.items():
        scale = max(np.abs(g).max(), 1e-6)
        np.testing.assert_allclose(grads[leaf] / scale, g / scale, rtol=0, atol=3e-2,
                                   err_msg=leaf)


# -- Train: steps_per_dispatch, resume, layouts ------------------------------------------------


def _losses(target):
    with open(os.path.join(target, "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


def _train(tfr_path, target, n_iters, **overrides):
    _reset()
    return instantiate(_cfg(tfr_path, str(target), n_iters=n_iters, **overrides),
                       device="cpu")["model"]


def test_dispatch_sizes_stop_at_every_cadence():
    assert port_train.dispatch_sizes(0, 20, 5, (10**9, 10)) == [5, 5, 5, 5]
    assert port_train.dispatch_sizes(3, 23, 5, (10**9, 10)) == [5, 2, 5, 5, 3]
    assert port_train.dispatch_sizes(0, 23, 100, (20, 10)) == [10, 10, 3]
    assert port_train.dispatch_sizes(7, 9, 100, (0, 0)) == [2]


def test_steps_per_dispatch_matches_single_steps(tfr, tmp_path):
    """K = 5 steps per dispatch against K = 1 (checkpoints every 10 steps
    and validation at 15 clip the chunks): the same logged steps and
    losses, parameters within 1e-5 (tests/test_device_dataset.py's pin), the
    checkpoints and images at their steps."""
    models, scalars = {}, {}
    for k in (1, 5):
        target = tmp_path / f"k{k}"
        cfg_logger = {"i_img": 15, "i_checkpoint": 10}
        _reset()
        cfg = _cfg(tfr, str(target), n_iters=20, steps_per_dispatch=k)
        cfg["logger_config"].update(cfg_logger)
        models[k] = _params(instantiate(cfg, device="cpu")["model"])
        scalars[k] = _losses(str(target))
        assert sorted(os.listdir(target / "checkpoints")) == ["ckpt-10.pkl", "ckpt-20.pkl"]
        assert os.listdir(target / "media" / "validation") == ["15"]
    assert [r["step"] for r in scalars[5]] == [r["step"] for r in scalars[1]] == list(range(1, 21))
    np.testing.assert_allclose([r["Loss"] for r in scalars[5]], [r["Loss"] for r in scalars[1]],
                               rtol=1e-6)
    for leaf in models[1]:
        np.testing.assert_allclose(models[5][leaf], models[1][leaf], rtol=0, atol=1e-5)


@pytest.mark.parametrize("first,second", [(False, True), (True, False)])
def test_resume_across_a_layout_switch(tfr, tmp_path, first, second):
    """Ten steps with flat_params=first, then a resume to 15 with
    flat_params=second: the steps, losses and parameters of an
    uninterrupted 15-step run (the device stream is keyed by the absolute
    step), to the rounding that separates the two layouts' products."""
    straight = tmp_path / "straight"
    want = _params(_train(tfr, straight, 15, steps_per_dispatch=5))
    resumed = tmp_path / "resumed"
    _train(tfr, resumed, 10, steps_per_dispatch=5, flat_params=first)
    got = _params(_train(tfr, resumed, 15, steps_per_dispatch=5, flat_params=second))
    losses, want_losses = _losses(str(resumed)), _losses(str(straight))
    assert [r["step"] for r in losses] == list(range(1, 16))
    np.testing.assert_allclose([r["Loss"] for r in losses], [r["Loss"] for r in want_losses],
                               rtol=1e-5)
    for leaf in want:
        np.testing.assert_allclose(got[leaf], want[leaf], rtol=0, atol=1e-5, err_msg=leaf)


def _flat_cfg(tfr_path, target):
    cfg = _cfg(tfr_path, str(target), n_iters=5, flat_params=True)
    cfg["logger_config"]["i_checkpoint"] = 5
    return cfg


def _jax_flat_train():
    """JAX's Train with flat_params for five steps: its checkpoint and
    scalars files, and the checkpoint's parameters and Adam mu unravelled
    by the JAX model ("param/<leaf>", "mu/<leaf>")."""
    with tempfile.TemporaryDirectory() as tmp:
        target = os.path.join(tmp, "logs")
        _reset()
        jax_models = jax_util.instantiate(jax_util.EasyDict(
            _flat_cfg(_synthetic_tfr(tmp), target)))
        saved = CheckpointManager(os.path.join(target, "checkpoints")).restore_latest()
        adam = next(s for s in saved["extra"]["opt_state"] if s.name == "ScaleByAdamState")
        unravel = jax_models["model"]._unravel
        return {"ckpt": file_bytes(os.path.join(target, "checkpoints", "ckpt-5.pkl")),
                "scalars": file_bytes(os.path.join(target, "scalars.jsonl")),
                **{f"param/{k}": v for k, v in flatten_params(jax.tree.map(
                    np.asarray, unravel(np.asarray(saved["models"]["model"])))).items()},
                **{f"mu/{k}": v for k, v in flatten_params(jax.tree.map(
                    np.asarray, unravel(np.asarray(adam[1]["model"])))).items()}}


def test_a_jax_flat_checkpoint_restores(tfr, tmp_path):
    """JAX's Train with flat_params (params and optax moments as flat
    vectors) for five steps; the port restores its checkpoint into flat and
    per-layer models, parameters and moments bit for bit, and resumes."""
    target = tmp_path / "logs"
    cfg = _flat_cfg(tfr, target)
    recording = recorded(MODULE, "test_a_jax_flat_checkpoint_restores")
    os.makedirs(target / "checkpoints")
    (target / "checkpoints" / "ckpt-5.pkl").write_bytes(recording["ckpt"].tobytes())
    (target / "scalars.jsonl").write_bytes(recording["scalars"].tobytes())
    saved = CheckpointManager(str(target / "checkpoints")).restore_latest()
    theta = np.asarray(saved["models"]["model"])
    assert theta.ndim == 1
    want, want_mu = group(recording, "param/"), group(recording, "mu/")
    for flat in (False, True):
        _reset()
        model = instantiate(dict(cfg["model_config"], n_parameters=[1, 6]), device="cpu")
        if flat:
            port_train.apply_flat_param_space({"model": model})
        load_jax_params(model, saved["models"]["model"])
        got = _params(model)
        for leaf in want:
            np.testing.assert_array_equal(got[leaf], want[leaf], err_msg=leaf)
        optimizer = port_train.make_optimizer(model.parameters(), 5e-3, 500)
        from nerftex_torch.render.checkpoint import adam_state_tree, load_jax_opt_state

        load_jax_opt_state(optimizer, {"model": model}, saved["extra"]["opt_state"])
        tree = adam_state_tree(optimizer, {"model": model})
        assert int(tree["count"]) == 5
        got_mu = flatten_params(tree["mu"]["model"])
        for leaf in want_mu:
            np.testing.assert_array_equal(got_mu[leaf], want_mu[leaf], err_msg=leaf)
    _reset()
    instantiate(dict(copy.deepcopy(cfg), n_iters=8, flat_params=False), device="cpu")
    assert [r["step"] for r in _losses(str(target))][-3:] == [6, 7, 8]


def test_train_end_to_end_matches_jax_and_resumes(tfr, tmp_path):
    """Train with device_resident: the logged losses of JAX's Train (op by
    op) for five steps, the loss falling over 25 steps, and a resume that
    continues at 26 (tests/test_device_dataset.py's
    test_fused_training_end_to_end)."""
    target = tmp_path / "port"
    want = recorded(MODULE, "test_train_end_to_end_matches_jax_and_resumes")
    model = _train(tfr, target, 25)
    losses = [r["Loss"] for r in _losses(str(target))]
    np.testing.assert_allclose(losses[:5], want["losses"], rtol=1e-4)
    assert len(losses) == 25 and np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < 0.9 * np.mean(losses[:5]), losses
    assert all(np.isfinite(v).all() for v in _params(model).values())
    _train(tfr, target, 30)
    assert [r["step"] for r in _losses(str(target))][-5:] == list(range(26, 31))


def _jax_train():
    """JAX's Train with device_resident, op by op, for five steps: the
    logged losses."""
    with tempfile.TemporaryDirectory() as tmp:
        target = os.path.join(tmp, "jax")
        _reset()
        with jax.disable_jit():
            jax_util.instantiate(jax_util.EasyDict(_cfg(_synthetic_tfr(tmp), target, n_iters=5)))
        return {"losses": np.array([r["Loss"] for r in _losses(target)])}


JAX_CASES = {
    **{f"test_sampler_matches_jax[{seed}]": (lambda seed=seed: _jax_sampler(seed))
       for seed in (0, 7, 123)},
    "jax_three_steps": lambda: _jax_steps(3),
    "test_cast_params_once_bf16_matches_jax": _jax_cast_once_bf16,
    "test_a_jax_flat_checkpoint_restores": _jax_flat_train,
    "test_train_end_to_end_matches_jax_and_resumes": _jax_train,
}
