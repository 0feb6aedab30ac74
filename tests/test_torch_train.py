"""Training in nerftex_torch against the JAX package's on the same inputs,
weights and keys, at small width (depth 3, width 64, Fourier bands 6/2/2,
32 samples; tests/test_train_e2e.py's config).

- the losses, with hard and soft masks and coarse terms;
- one training step (loss and every leaf's gradient) of the plain
  Renderer, of raw_noise_std > 0 with blur_idx 0, and of CoarseFine with
  n_importance 16; remat True and "save_encodings" give the gradients of
  remat False;
- Adam and the learning-rate schedule over ten steps against optax;
- the whole Train through nerftex_torch.main against JAX's Train on one
  synthetic TFRecord (losses, checkpoint and validation file names); a
  resume from a JAX checkpoint, moments included; JAX's Render restoring
  a port-written checkpoint;
- the port's synthetic TFRecord writer, its ParamNerf init, the packed
  kernel weights after an optimizer step, the device-resident path's
  knobs training through Train, and every shipped config_*_train.py taking a step through main.

The JAX references run op by op (jax.disable_jit()).  Adam divides each
gradient by its own magnitude, so a near-zero gradient element whose sign
is decided by float32 rounding moves its weight by +-lrate (5e-3 here):
JAX's own jitted step and its op-by-op step part at step 2 (1.9e-5
relative loss) and reach 5.4e-4 at step 9, as the port does against the
jitted step; against the op-by-op step the port stays within 5.1e-5 over
ten steps, which the 1e-4 gate holds."""

import copy
import functools
import importlib
import json
import os
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import nerftex_tpu.models.mlp as jax_mlp
from nerftex_tpu.render.train import make_optimizer as jax_make_optimizer
from nerftex_tpu.tools.synth import make_synthetic_tfrecord as jax_synth
from nerftex_tpu.utils import rng as jax_streams
from nerftex_tpu.utils import util as jax_util
from nerftex_torch import main as port_main
from nerftex_torch.models import mlp as port_mlp
from nerftex_torch.render.checkpoint import (CheckpointManager, adam_state_tree, as_jax_tree,
                                             export_jax_params, flatten_params,
                                             load_jax_opt_state, load_jax_params)
from nerftex_torch.render.train import make_optimizer, optimizer_step
from nerftex_torch.tools.synth import make_synthetic_tfrecord
from nerftex_torch.utils import jax_rng, rng, trace
from nerftex_torch.utils.image import decode_png_u8
from nerftex_torch.utils.util import instantiate

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _jax_reference import file_bytes, group, recorded, sha256  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401
from test_train_e2e import _train_config  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULE = "test_torch_train"
N_ITERS = 20
LOSS_RTOL = 1e-4        # ten logged losses, the port vs JAX's op-by-op Train
STEP_LOSS_RTOL = 1e-6   # one step's loss
GRAD_TOL = 1e-5         # one step's gradient, times the leaf's max |g|


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    monkeypatch.setenv("NERFTEX_NO_TENSORBOARD", "1")


def _reset(seed=0):
    """Both packages' seeds and model-init counters, as a fresh process has them."""
    jax_streams.set_seed(seed)
    rng.set_seed(seed)
    jax_mlp._INIT_COUNTER[0] = 0
    port_mlp._INIT_COUNTER[0] = 0


def _config(tfr, target, n_iters=N_ITERS):
    """tests/test_train_e2e.py's config; checkpoints every 5 steps, so the
    retention (max_to_keep 3) deletes one."""
    cfg = _train_config(tfr, target, n_iters=n_iters)
    cfg["logger_config"]["i_checkpoint"] = 5
    return cfg


def _losses(target):
    with open(os.path.join(target, "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


def _tree(root):
    return sorted((os.path.relpath(d, root), sorted(f)) for d, _, f in os.walk(root))


def _tree_lines(root):
    """_tree(root) as strings "<directory>: <file>, <file>"."""
    return [f"{d}: {', '.join(f)}" for d, f in _tree(root)]


def _synthetic_tfr(directory):
    path = os.path.join(str(directory), "train.tfr")
    jax_synth(path, n_images=8, size=16)
    return path


@pytest.fixture(scope="module")
def tfr(tmp_path_factory):
    return _synthetic_tfr(tmp_path_factory.mktemp("data"))


@functools.lru_cache(maxsize=None)
def _jax_train():
    """JAX's Train, op by op, for N_ITERS steps: its logged steps and
    losses, the checkpoints it kept (the bytes of those at steps 10 and 20)
    and its media tree."""
    with tempfile.TemporaryDirectory() as tmp:
        target = os.path.join(tmp, "jax")
        _reset()
        with jax.disable_jit():
            jax_util.instantiate(_config(_synthetic_tfr(tmp), target))
        ckpts = os.path.join(target, "checkpoints")
        return {"steps": np.array([r["step"] for r in _losses(target)]),
                "losses": np.array([r["Loss"] for r in _losses(target)]),
                "checkpoints": np.array(sorted(os.listdir(ckpts))),
                **{f"ckpt/{n}": file_bytes(os.path.join(ckpts, n))
                   for n in ("ckpt-10.pkl", "ckpt-20.pkl")},
                "media": np.array(_tree_lines(os.path.join(target, "media")))}


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX's Train, op by op, for N_ITERS steps (recorded): the recording,
    and a directory holding its checkpoints at steps 10 and 20."""
    want = recorded(MODULE, "jax_run")
    target = tmp_path_factory.mktemp("jax")
    os.makedirs(target / "checkpoints")
    for name, data in group(want, "ckpt/").items():
        (target / "checkpoints" / name).write_bytes(data.tobytes())
    return str(target), want


def _write_config_module(directory, name, cfg):
    with open(os.path.join(directory, name + ".py"), "w") as f:
        f.write(f"config = {cfg!r}\n")
    return name + ".py"


def _main(directory, name, cfg):
    """nerftex_torch.main on a config module written to ``directory``, run
    from there on the CPU."""
    path = _write_config_module(directory, name, cfg)
    cwd = os.getcwd()
    os.chdir(directory)
    try:
        port_main.main([path, "--device", "cpu"])
    finally:
        os.chdir(cwd)


@pytest.fixture(scope="module")
def port_run(tfr, tmp_path_factory):
    """nerftex_torch.main on the same config, on the CPU."""
    work = str(tmp_path_factory.mktemp("port"))
    target = os.path.join(work, "logs")
    _reset()
    _main(work, "port_train", dict(_config(tfr, target)))
    return target


def test_train_through_main_matches_jax_losses(jax_run, port_run):
    _, want = jax_run
    got = _losses(port_run)
    assert [r["step"] for r in got] == list(want["steps"]) == list(range(1, N_ITERS + 1))
    w = want["losses"][:10]
    g = np.array([r["Loss"] for r in got[:10]])
    np.testing.assert_allclose(g, w, rtol=LOSS_RTOL, atol=0)
    assert np.isfinite([r["Loss"] for r in got]).all()


def test_train_through_main_writes_the_jax_files(jax_run, port_run):
    """The same checkpoints after retention (saves at 5, 10, 15 and 20,
    the newest three kept) and the same validation images; main's config
    copy is config_train.py."""
    _, want = jax_run
    ckpts = sorted(os.listdir(os.path.join(port_run, "checkpoints")))
    assert ckpts == list(want["checkpoints"])
    assert ckpts == ["ckpt-10.pkl", "ckpt-15.pkl", "ckpt-20.pkl"]
    media = _tree(os.path.join(port_run, "media"))
    assert _tree_lines(os.path.join(port_run, "media")) == list(want["media"])
    assert ("validation/20", ["0.png"]) in media
    assert os.path.exists(os.path.join(port_run, "config_train.py"))
    saved = CheckpointManager(os.path.join(port_run, "checkpoints")).restore_latest()
    assert saved["extra"]["step"] == N_ITERS and "opt_state" not in saved["extra"]
    assert int(saved["extra"]["torch_adam"]["count"]) == N_ITERS


def _resume(tfr_path, target, ckpt_10, side):
    """Five steps from the checkpoint at step 10 under ``target``, by
    ``side``'s Train (JAX's op by op): the logged records."""
    os.makedirs(os.path.join(target, "checkpoints"))
    with open(os.path.join(target, "checkpoints", "ckpt-10.pkl"), "wb") as f:
        f.write(ckpt_10)
    _reset()
    if side == "jax":
        with jax.disable_jit():
            jax_util.instantiate(_config(tfr_path, target, n_iters=15))
    else:
        instantiate(_config(tfr_path, target, n_iters=15), device="cpu")
    return _losses(target)


def _jax_resume():
    with tempfile.TemporaryDirectory() as tmp:
        records = _resume(_synthetic_tfr(tmp), os.path.join(tmp, "jax"),
                          _jax_train()["ckpt/ckpt-10.pkl"].tobytes(), "jax")
    return {"losses": np.array([r["Loss"] for r in records])}


def test_resume_from_a_jax_checkpoint_matches_jax(jax_run, tfr, tmp_path):
    """From JAX's checkpoint at step 10 (weights and optax moments), five
    port steps match five JAX steps from the same checkpoint.  Both
    packages restart the data stream on a resume, so JAX's uninterrupted
    steps 11-15 saw other batches; the reference is JAX's resume."""
    _, run = jax_run
    want = recorded(MODULE, "test_resume_from_a_jax_checkpoint_matches_jax")
    got = _resume(tfr, str(tmp_path / "port"), run["ckpt/ckpt-10.pkl"].tobytes(), "port")
    assert [r["step"] for r in got] == list(range(11, 16))
    np.testing.assert_allclose([r["Loss"] for r in got], want["losses"], rtol=LOSS_RTOL, atol=0)


def test_jax_opt_state_loads_into_torch_adam(jax_run):
    """The optax moments and count of a JAX checkpoint land in the torch
    Adam state bit for bit, and the port writes them back in the same
    layout."""
    saved = CheckpointManager(os.path.join(jax_run[0], "checkpoints")).restore_latest()
    _reset()
    model = instantiate(_config("", "")["model_config"], device="cpu")
    load_jax_params(model, saved["models"]["model"])
    opt = make_optimizer(model.parameters(), 5e-3, 500)
    load_jax_opt_state(opt, {"model": model}, saved["extra"]["opt_state"])
    tree = adam_state_tree(opt, {"model": model})
    adam = next(s for s in saved["extra"]["opt_state"] if s.name == "ScaleByAdamState")
    assert int(tree["count"]) == int(adam[0]) == N_ITERS
    for ours, theirs in ((tree["mu"], adam[1]), (tree["nu"], adam[2])):
        want, got = flatten_params(theirs["model"]), flatten_params(ours["model"])
        assert set(want) == set(got)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_jax_render_restores_a_port_checkpoint(port_run, tfr, tmp_path):
    """JAX's Render restores the port's last checkpoint (models in the JAX
    layout) and renders what the port's Render renders from it."""
    cfg = _config(tfr, port_run)
    images = {}
    for side in ("jax", "port"):
        render = {
            "module": "network.render.Render",
            "target_path": str(tmp_path / side),
            "source_path": port_run,
            "override": True,
            "test_dataset_config": cfg["val_dataset_config"],
            "model_config": cfg["model_config"],
            "renderer_config": {"module": "network.renderer.Renderer", "n_samples": 32,
                                "perturb": False},
            "logger_config": {"module": "network.logger.Logger"},
        }
        _reset()
        if side == "jax":
            jax_util.instantiate(jax_util.EasyDict(render))
        else:
            instantiate(render, device="cpu")
        with open(tmp_path / side / "media" / "test" / "0.png", "rb") as f:
            images[side] = decode_png_u8(f.read()).astype(np.int32)
    assert images["port"].shape == (8, 8, 4) and images["port"][..., 3].max() > 0
    # float32 renders of the same weights: at most one u8 level apart.
    assert np.abs(images["port"] - images["jax"]).max() <= 1


# -- one step, from the same weights, batch and key ------------------------------


def _step_case(tfr, case):
    """(config, renderer and model overrides) for one step's case."""
    cfg = _config(tfr, "unused")
    if case == "noise_blur":
        cfg["renderer_config"].update(raw_noise_std=0.1, blur_idx=0)
    elif case == "coarse_fine":
        cfg["model_config"] = {"module": "network.model.CoarseFine",
                               "model_config": cfg["model_config"]}
        cfg["renderer_config"].update(n_importance=16)
    return cfg


def _port_grads(models):
    return {name: flatten_params(as_jax_tree(m, lambda p: p.grad.numpy()))
            for name, m in models.items()}


def _jax_step(case):
    """JAX's first batch of the config's dataset, and the loss and
    {model: {leaf: grad}} of JAX's step on it under step 0's key, op by op."""
    with tempfile.TemporaryDirectory() as tmp:
        cfg = _step_case(_synthetic_tfr(tmp), case)
        _reset()
        batch = next(iter(jax_util.instantiate(jax_util.EasyDict(cfg["train_dataset_config"]))
                          .take(1)))
    model_cfg = dict(cfg["model_config"], n_parameters=[1, 6])
    jm = jax_util.instantiate(jax_util.EasyDict(model_cfg))
    jr = jax_util.instantiate(jax_util.EasyDict(dict(cfg["renderer_config"], **jm)))
    jl = jax_util.instantiate(jax_util.EasyDict(cfg["loss_config"]))
    key = jax.random.fold_in(jax_streams.stream_key(jax_streams.STREAM_PERTURB), 0)

    def loss_of(params):
        pred = jr.apply(params, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        return jl(color_true=batch["color"], alpha_true=batch["alpha"], **pred)

    with jax.disable_jit():
        jloss, jgrad = jax.value_and_grad(loss_of)({k: m.params for k, m in jm.items()})
    return {"loss": np.asarray(jloss), **{f"batch/{k}": np.asarray(v) for k, v in batch.items()},
            **{f"grad/{name}/{leaf}": g for name, tree in jgrad.items()
               for leaf, g in flatten_params(jax.tree.map(np.asarray, tree)).items()}}


def _one_step(tfr, case, remat=False):
    """JAX's (recorded) and the port's (loss, {model: {leaf: grad}}) for
    the first batch of the config's dataset under step 0's key."""
    want = recorded(MODULE, f"test_one_step_matches_jax[{case}]")
    batch = group(want, "batch/")
    cfg = _step_case(tfr, case)
    _reset()
    model_cfg = dict(cfg["model_config"], n_parameters=[1, 6])
    tm = port_mlp.model_dict(instantiate(model_cfg, device="cpu"))
    tr = instantiate(dict(cfg["renderer_config"], **tm, device="cpu",
                          remat_net_chunks=remat, net_chunk=512))
    tl = instantiate(cfg["loss_config"])
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    pred = tr.apply(tb, jax_rng.fold_in(rng.stream_key(rng.STREAM_PERTURB), 0))
    tloss = tl(color_true=tb["color"], alpha_true=tb["alpha"], **pred)
    tloss.backward()
    grads = group(want, "grad/")
    jgrad = {name: group(grads, f"{name}/") for name in {k.split("/", 1)[0] for k in grads}}
    return (float(want["loss"]), jgrad), (float(tloss.detach()), _port_grads(tm))


@pytest.mark.parametrize("case", ["plain", "noise_blur", "coarse_fine"])
def test_one_step_matches_jax(tfr, case):
    (jloss, jgrad), (tloss, tgrad) = _one_step(tfr, case)
    np.testing.assert_allclose(tloss, jloss, rtol=STEP_LOSS_RTOL)
    assert set(tgrad) == set(jgrad) == ({"model", "model_fine"} if case == "coarse_fine"
                                        else {"model"})
    for name in jgrad:
        # The fine model's samples come from sample_pdf, whose cdf both
        # packages sum in other orders: a sample in a bin of tiny mass moves
        # by up to 2.5e-4 (tests/test_torch_volume.py), and its gradient
        # terms with it.  Measured: 1.1e-5 of the leaf's max |g| (one
        # element of trunk/0/w); the coarse model holds GRAD_TOL.
        tol = 3 * GRAD_TOL if name == "model_fine" else GRAD_TOL
        assert set(tgrad[name]) == set(jgrad[name])
        for leaf, g in jgrad[name].items():
            scale = np.abs(g).max()
            np.testing.assert_allclose(tgrad[name][leaf], g, rtol=0, atol=tol * scale,
                                       err_msg=f"{name} {leaf}")


@pytest.mark.parametrize("remat", [True, "save_encodings"])
def test_remat_gives_the_same_gradients(tfr, remat):
    """Recomputing each net_chunk's activations (or only its dense chain)
    in the backward changes no bit of the loss or the gradients."""
    _, (loss, grads) = _one_step(tfr, "plain", remat=False)
    _, (loss_r, grads_r) = _one_step(tfr, "plain", remat=remat)
    assert loss_r == loss
    for leaf, g in grads["model"].items():
        np.testing.assert_array_equal(grads_r["model"][leaf], g, err_msg=leaf)


# -- Adam, losses, data, init ------------------------------------------------------


def test_adam_and_schedule_match_optax():
    """Ten updates from the same gradients (numpy seed 0) with a rate that
    decays tenfold every 3 updates."""
    rs = np.random.RandomState(0)
    w0 = rs.normal(size=(7, 5)).astype(np.float32)
    grads = [(rs.normal(size=(7, 5)) * 10.0 ** rs.uniform(-8, 0, (7, 5))).astype(np.float32)
             for _ in range(10)]
    opt = jax_make_optimizer(5e-3, 0.003)
    params = {"w": jnp.asarray(w0)}
    state = opt.init(params)
    w = torch.nn.Parameter(torch.tensor(w0))
    topt = make_optimizer([w], 5e-3, 0.003)
    for i, g in enumerate(grads):
        updates, state = opt.update({"w": jnp.asarray(g)}, state, params)
        params = optax.apply_updates(params, updates)
        w.grad = torch.tensor(g)
        optimizer_step(topt)
        # The same update to a float32 ulp or two of the weights (torch
        # divides by sqrt(1 - b2^t) after the square root; optax before).
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(params["w"]), rtol=1e-6,
                                   atol=1e-7, err_msg=f"update {i}")
    assert topt.param_groups[0]["lr"] == pytest.approx(5e-3 * 0.1 ** (9 / 3))


@pytest.mark.parametrize("filter_color,hard,coarse,loss_fn", [
    (True, True, False, "smape"), (True, False, True, "smape"), (False, True, True, "mse"),
    (True, True, True, "mse")])
def test_alpha_loss_matches_jax(filter_color, hard, coarse, loss_fn):
    rs = np.random.RandomState(4)
    arrays = {
        "color_true": rs.uniform(0, 1, (2, 64, 3)), "color_pred": rs.uniform(0, 1, (2, 64, 3)),
        "alpha_true": np.where(rs.uniform(size=(2, 64)) < 0.3, 0, rs.uniform(size=(2, 64))),
        "alpha_pred": rs.uniform(0, 1, (2, 64)),
    }
    if coarse:
        arrays.update(color_pred_coarse=rs.uniform(0, 1, (2, 64, 3)),
                      alpha_pred_coarse=rs.uniform(0, 1, (2, 64)))
    cfg = {"module": "network.loss.AlphaLoss", "loss_fn": f"network.loss.{loss_fn}",
           "alpha_loss_fn": "network.loss.mse", "gamma": 0.5,
           "filter_color_loss": filter_color, "use_hard_mask": hard}
    want = jax_util.instantiate(jax_util.EasyDict(cfg))(
        **{k: jnp.asarray(v, jnp.float32) for k, v in arrays.items()})
    got = instantiate(cfg)(**{k: torch.tensor(v, dtype=torch.float32) for k, v in arrays.items()})
    # Means over a few hundred float32 terms, summed in other orders.
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("coarse", [False, True])
def test_nerf_loss_matches_jax(coarse):
    rs = np.random.RandomState(5)
    arrays = {"color_true": rs.uniform(0, 1, (3, 32, 3)), "color_pred": rs.uniform(0, 1, (3, 32, 3))}
    if coarse:
        arrays["color_pred_coarse"] = rs.uniform(0, 1, (3, 32, 3))
    cfg = {"module": "network.loss.NerfLoss", "loss_fn": "network.loss.smape"}
    want = jax_util.instantiate(jax_util.EasyDict(cfg))(
        **{k: jnp.asarray(v, jnp.float32) for k, v in arrays.items()})
    got = instantiate(cfg)(**{k: torch.tensor(v, dtype=torch.float32) for k, v in arrays.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("kw", [dict(n_images=4, size=16),
                                dict(n_images=3, size=12, n_parameters=(2, 3), seed=3,
                                     b_0=(-2.5, -2.5, -1), b_1=(2.5, 2.5, 2.5))])
def test_synthetic_tfrecord_is_the_jax_bytes(tmp_path, kw):
    jax_synth(str(tmp_path / "jax.tfr"), **kw)
    make_synthetic_tfrecord(str(tmp_path / "port.tfr"), **kw)
    assert (tmp_path / "port.tfr").read_bytes() == (tmp_path / "jax.tfr").read_bytes()


INIT_CFG = {"module": "network.model.CoarseFine", "model_config": {
    "module": "network.model.ParamNerf",
    "pos_embedding": {"module": "network.model.FourierFeatures", "n_freq_bands": 10},
    "dir_embedding": {"module": "network.model.FourierFeatures", "n_freq_bands": 4},
    "param_embedding": {"module": "network.model.FourierFeatures", "n_freq_bands": 4},
    "n_parameters": [1, 6], "param_depth": 1}}


def _jax_init(seed):
    """The JAX factories' models for ``seed``: their names, and each
    leaf's SHA-256 and shape."""
    _reset(seed)
    want = jax_util.instantiate(jax_util.EasyDict(INIT_CFG))
    out = {"models": np.array(list(want))}
    for name, model in want.items():
        for k, v in flatten_params(jax.tree.map(np.asarray, model.params)).items():
            out[f"sha256/{name}/{k}"] = np.array(sha256(v))
            out[f"shape/{name}/{k}"] = np.array(v.shape)
    return out


@pytest.mark.parametrize("seed", [0, 3])
def test_model_init_is_jax_bit_for_bit(seed):
    """Coarse and fine models of a CoarseFine config, at the shipped
    width, initialise to the JAX factories' weights for the same seed."""
    want = recorded(MODULE, f"test_model_init_is_jax_bit_for_bit[{seed}]")
    _reset(seed)
    got = instantiate(INIT_CFG, device="cpu")
    assert list(got) == list(want["models"]) == ["model", "model_fine"]
    for name, model in got.items():
        ours = flatten_params(export_jax_params(model))
        digests, shapes = group(want, f"sha256/{name}/"), group(want, f"shape/{name}/")
        assert set(ours) == set(digests)
        for k in digests:
            assert ours[k].shape == tuple(shapes[k]), f"{name} {k}"
            assert sha256(ours[k]) == str(digests[k]), f"{name} {k}"


def test_packed_weights_follow_an_optimizer_step():
    """An in-place Adam step (the foreach path, as on the card) bumps every
    parameter's version, so infer repacks and agrees with forward."""
    _reset()
    cfg = _config("", "")["model_config"]
    model = instantiate(dict(cfg, n_parameters=[1, 6]), device="cpu")
    rs = np.random.RandomState(0)
    x = [torch.tensor(rs.uniform(-1, 1, (64, n)).astype(np.float32)) for n in (3, 3, 7)]
    with torch.inference_mode():
        before = model.infer(*x)
    packed = model.packed()
    opt = torch.optim.Adam(model.parameters(), lr=1e-2, foreach=True)
    sum(o.sum() for o in model(*x)).backward()
    opt.step()
    assert model.packed() is not packed
    with torch.inference_mode():
        after = model.infer(*x)
    with torch.no_grad():
        plain = model(*x)
    assert (after[1] - before[1]).abs().max() > 1e-3
    for a, p in zip(after, plain):
        np.testing.assert_allclose(a.numpy(), p.numpy(), rtol=0, atol=1e-5)


def test_training_forward_after_an_eval_render(tfr):
    """A render under inference_mode (the Logger's validation) leaves
    nothing that a later differentiable step cannot save for backward."""
    cfg = _config(tfr, "unused")
    _reset()
    data = next(iter(instantiate(cfg["train_dataset_config"]).take(1)))
    model = instantiate(dict(cfg["model_config"], n_parameters=[1, 6]), device="cpu")
    renderer = instantiate(dict(cfg["renderer_config"], model=model, device="cpu"))
    renderer(**data, key=jax_rng.key(1))
    pred = renderer.apply(data, jax_rng.key(2))
    pred["color_pred"].sum().backward()
    assert model.trunk[0].weight.grad.abs().max() > 0


@pytest.mark.parametrize("override,where", [
    ({"steps_per_dispatch": 2}, None), ({"flat_params": True}, None),
    ({"device_resident": True}, "train_dataset_config"),
    ({"net_chunk_unroll": 2}, "renderer_config"), ({"cast_params_once": True}, "renderer_config")])
def test_train_refuses_the_deferred_knobs(tfr, tmp_path, override, where):
    """Each knob of the JAX package's device-resident training path, which
    the port once refused, now trains: two steps through Train on the CPU,
    logged and checkpointed (the host-fed path takes one step at a time
    whatever steps_per_dispatch says, as the JAX package's does)."""
    cfg = _config(tfr, str(tmp_path), n_iters=2)
    cfg["logger_config"].update(i_checkpoint=2, i_img=2)
    (cfg[where] if where else cfg).update(override)
    _reset()
    instantiate(cfg, device="cpu")
    assert [r["step"] for r in _losses(str(tmp_path))] == [1, 2]
    assert os.listdir(tmp_path / "checkpoints") == ["ckpt-2.pkl"]


def test_train_writes_tensorboard_and_a_profiler_trace(tfr, tmp_path, monkeypatch):
    """With TensorBoard importable and NERFTEX_NO_TENSORBOARD unset, the
    scalars and validation images go to an event file too; i_trace writes
    a torch.profiler trace of trace_steps steps under <target>/profile."""
    monkeypatch.delenv("NERFTEX_NO_TENSORBOARD")
    pytest.importorskip("torch.utils.tensorboard")
    cfg = _config(tfr, str(tmp_path), n_iters=4)
    cfg["logger_config"].update(i_img=4, i_trace=2, trace_steps=1)
    _reset()
    trace.reset()
    instantiate(cfg, device="cpu")
    assert any(n.startswith("events.out.tfevents") for n in os.listdir(tmp_path))
    assert os.listdir(tmp_path / "profile") == ["trace_2.json"]
    # Step 4's trace would end past n_iters: it is not started, so no
    # profiler is left running.
    assert not torch.autograd.profiler._is_profiler_enabled
    with open(tmp_path / "profile" / "trace_2.json") as f:
        events = json.load(f)["traceEvents"]
    # The program's spans are in the export, and the tracer forgot them.
    assert any(e.get("name") == "nerftex.train.step" for e in events)
    assert trace.snapshot() == {"spans": [], "counts": [], "dropped": 0}
    assert len(_losses(str(tmp_path))) == 4


TRAIN_CONFIGS = ("carpet", "fur", "grass", "grass_filtered", "plush")


@pytest.mark.parametrize("name", TRAIN_CONFIGS)
def test_shipped_train_config_takes_a_step_through_main(name, tmp_path):
    """configs/config_<name>_train.py through nerftex_torch.main on the CPU
    with a synthetic TFRecord of its parameter count and proxy box, cut to
    CPU size (depth 3, width 64, 8 rays of 16 samples, 8x8 validation
    images); everything else is the config's own (its renderer options:
    grass_filtered's raw_noise_std and blur_idx)."""
    cfg = copy.deepcopy(importlib.import_module(f"configs.config_{name}_train").config)
    n_parameters = cfg["model_config"]["n_parameters"]
    proxy = cfg["train_dataset_config"]["proxy_config"]
    tfr = str(tmp_path / "train.tfr")
    make_synthetic_tfrecord(tfr, n_images=4, size=16, n_parameters=tuple(n_parameters),
                            b_0=tuple(proxy["b_0"]), b_1=tuple(proxy["b_1"]))
    cfg["target_path"] = str(tmp_path / "logs")
    cfg["n_iters"] = 2
    cfg["train_dataset_config"]["data_loader_config"]["tfr_path"] = tfr
    cfg["train_dataset_config"]["pixel_sampler_config"].update(n_samples=8, downsample_factor=2)
    cfg["val_dataset_config"]["data_loader_config"].update(height=8, width=8)
    cfg["model_config"].update(depth=3, width=64, skips=[1])
    cfg["renderer_config"]["n_samples"] = 16
    cfg["logger_config"].update(i_summary=1, i_img=2, i_checkpoint=2)
    _reset()
    _main(str(tmp_path), f"cut_{name}_train", cfg)
    losses = [r["Loss"] for r in _losses(cfg["target_path"])]
    assert len(losses) == 2 and np.isfinite(losses).all()
    media = os.listdir(os.path.join(cfg["target_path"], "media", "validation", "2"))
    assert sorted(media) == ["0.png", "1.png"]
    assert os.listdir(os.path.join(cfg["target_path"], "checkpoints")) == ["ckpt-2.pkl"]


JAX_CASES = {
    "jax_run": _jax_train,
    "test_resume_from_a_jax_checkpoint_matches_jax": _jax_resume,
    **{f"test_one_step_matches_jax[{case}]": (lambda case=case: _jax_step(case))
       for case in ("plain", "noise_blur", "coarse_fine")},
    **{f"test_model_init_is_jax_bit_for_bit[{seed}]": (lambda seed=seed: _jax_init(seed))
       for seed in (0, 3)},
}
