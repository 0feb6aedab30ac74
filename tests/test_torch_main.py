"""The render mode of nerftex_torch against the JAX package's: a small
grass_filtered frame (blur_idx 0, the blur slot scaled per sample by the
ray's footprint) matches JAX's InstanceRenderer(blur_idx=0) with the same
key and weights; the port's main on the grass_filtered render config, cut
to 16x16 and a narrow ParamNerf, restored from one checkpoint that the
JAX package's CheckpointManager wrote, writes the file names and images
that the JAX package's Render writes; the eval Logger's PNG and EXR
images, with and without its filtered downsample, are the JAX Logger's;
NERFTEX_DEBUG_NANS makes main and the Logger raise on an injected NaN, and
nothing changes without it.  (main's train configs:
tests/test_torch_train.py.)"""

import contextlib
import copy
import importlib
import io
import json
import os
import re
import sys
import tempfile

import jax
import numpy as np
import pytest
import torch

import nerftex_tpu.models.mlp as jax_mlp
from nerftex_tpu.render.checkpoint import CheckpointManager as JaxCheckpointManager
from nerftex_tpu.utils import rng as jax_rng_streams
from nerftex_tpu.utils import util as jax_util
from nerftex_torch import main as port_main
from nerftex_torch.render.checkpoint import flatten_params, load_jax_params
from nerftex_torch.utils import jax_rng
from nerftex_torch.utils.image import decode_png_u8
from nerftex_torch.utils.util import instantiate

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _jax_reference import file_bytes, group, recorded  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULE = "test_torch_main"
H = W = 24
RENDER_SIZE = 16


def _config(name="grass_filtered", size=None):
    """configs/config_<name>_render.py with absolute mesh paths, a depth-3,
    width-64 ParamNerf and, given a size, frames of size x size."""
    cfg = copy.deepcopy(importlib.import_module(f"configs.config_{name}_render").config)
    inst = cfg["renderer_config"]["instancer_config"]
    for k in ("mesh_path", "patch_origins_path"):
        inst[k] = os.path.join(ROOT, inst[k])
    inst["textures"] = [os.path.join(ROOT, t) if t.endswith(".png") else t
                        for t in inst["textures"]]
    cfg["model_config"].update({"depth": 3, "width": 64, "skips": [1]})
    if size:
        cfg["test_dataset_config"]["data_loader_config"].update(height=size, width=size)
    return cfg


def _renderer_cfg(sorted_blocks=True):
    """The grass_filtered renderer (blur_idx 0, n_samples 1024, step 0.001)
    with 64-ray blocks and max_hits 32."""
    cfg = _config()["renderer_config"]
    inst = dict(cfg["instancer_config"], ray_block=64, max_hits=32)
    return dict(cfg, instancer_config=inst, render_chunk=4096, net_chunk=8192,
                sorted_blocks=sorted_blocks)


def _jax_frame():
    """The grass_filtered test dataset's last item (radius 5) at 24x24, a
    narrow ParamNerf's JAX weights, and JAX's frame with key(1)."""
    cfg = _config(size=H)
    jax_rng_streams.set_seed(0)
    data = list(jax_util.instantiate(jax_util.EasyDict(cfg["test_dataset_config"])))[-1]
    model_cfg = dict(cfg["model_config"], n_parameters=[2, 3])
    jax_mlp._INIT_COUNTER[0] = 0
    jm = jax_util.instantiate(jax_util.EasyDict(model_cfg))["model"]
    jr = jax_util.instantiate(jax_util.EasyDict(dict(_renderer_cfg(), model=jm)))
    assert jr.blur_idx == 0
    out = jr(**data, training=False, key=jax.random.key(1))
    return {**{f"data/{k}": np.asarray(v) for k, v in data.items()},
            **{f"weights/{k}": v for k, v in flatten_params(
                jax.tree.map(np.asarray, jm.params)).items()},
            "color": np.asarray(out["color_pred"]), "alpha": np.asarray(out["alpha_pred"])}


@pytest.fixture(scope="module")
def frame():
    """The grass_filtered test dataset's last item (radius 5) at 24x24, a
    narrow ParamNerf with the JAX weights, and JAX's frame with key(1)."""
    cfg = _config(size=H)
    want = recorded(MODULE, "frame")
    model_cfg = dict(cfg["model_config"], n_parameters=[2, 3])
    tm = instantiate(model_cfg, device="cpu")
    load_jax_params(tm, group(want, "weights/"))
    return group(want, "data/"), tm, (want["color"], want["alpha"])


def _port_render(data, tm, sorted_blocks=True):
    renderer = instantiate(dict(_renderer_cfg(sorted_blocks), model=tm, device="cpu"))
    assert renderer.blur_idx == 0
    out = renderer(**data, key=jax_rng.key(1))
    return out["color_pred"].numpy(), out["alpha_pred"].numpy()


def test_grass_filtered_frame_matches_jax_with_the_same_key(frame):
    data, tm, (c_j, a_j) = frame
    c_t, a_t = _port_render(data, tm)
    assert c_t.shape == c_j.shape == (1, H * W, 3) and a_t.shape == a_j.shape == (1, H * W)
    assert a_j.max() > 0.5 and (a_j > 0.1).mean() > 0.1
    # tests/test_torch_render.py's float32 gates (Fourier top band x 2^9,
    # nearest knife edges).  Measured here: 111.6 dB, max error 5.0e-5.
    err = np.maximum(np.abs(c_t - c_j).max(-1), np.abs(a_t - a_j))
    mse = np.mean(np.concatenate([c_t - c_j, (a_t - a_j)[..., None]], -1) ** 2)
    assert 10 * np.log10(1 / mse) >= 60
    assert np.mean(err > 1e-3) <= 0.02
    assert err.max() <= 3e-2


def test_blur_scaling_changes_the_frame(frame):
    """blur_idx is applied: the same frame without it differs."""
    data, tm, (c_j, a_j) = frame
    renderer = instantiate(dict(_renderer_cfg(), blur_idx=None, model=tm, device="cpu"))
    out = renderer(**data, key=jax_rng.key(1))
    assert np.abs(out["alpha_pred"].numpy() - a_j).max() > 1e-2


def test_blur_sorted_frame_equals_dense_frame(frame):
    """The sorted path's per-block cone_scale and the dense path's whole
    chunk scale the blur slot alike."""
    data, tm, _ = frame
    c_s, a_s = _port_render(data, tm)
    c_d, a_d = _port_render(data, tm, sorted_blocks=False)
    # Same per-sample inputs and MLP rows; only the composite's reduction
    # length differs (tests/test_torch_render.py).
    np.testing.assert_allclose(c_s, c_d, rtol=0, atol=5e-7)
    np.testing.assert_allclose(a_s, a_d, rtol=0, atol=5e-7)


def _drops(log):
    """The (kind, count) of each capacity warning a render printed."""
    return re.findall(r"WARNING: (hit|sample) capacity exceeded, dropped (\d+) ", log)


def _jax_render():
    """One checkpoint written by the JAX package's CheckpointManager, and
    what the JAX package's Render on the grass_filtered render config at
    16x16 (five frames, radius 20 down to 5) wrote from it and the drops
    it warned of."""
    from nerftex_tpu.render.render import Render as JaxRender

    cfg = _config(size=RENDER_SIZE)
    with tempfile.TemporaryDirectory() as root:
        ckpt_dir = os.path.join(root, "source")
        jax_rng_streams.set_seed(3)
        jax_mlp._INIT_COUNTER[0] = 0
        params = jax_util.instantiate(jax_util.EasyDict(dict(cfg["model_config"],
                                                             n_parameters=[2, 3])))["model"].params
        JaxCheckpointManager(os.path.join(ckpt_dir, "checkpoints")).save(
            {"models": {"model": params}, "extra": {"step": 7}}, 7)
        jax_target = os.path.join(root, "jax")
        jax_rng_streams.set_seed(cfg["seed"])
        jax_log = io.StringIO()
        with contextlib.redirect_stdout(jax_log):
            JaxRender(**{k: v for k, v in dict(cfg, target_path=jax_target,
                                               source_path=ckpt_dir).items() if k != "module"})
        media = os.path.join(jax_target, "media", "test")
        names = sorted(os.listdir(media))
        return {"ckpt": file_bytes(os.path.join(ckpt_dir, "checkpoints", "ckpt-7.pkl")),
                "names": np.array(names), "drops": np.array(_drops(jax_log.getvalue())),
                **{f"media/{n}": file_bytes(os.path.join(media, n)) for n in names}}


@pytest.fixture(scope="module")
def renders(tmp_path_factory):
    """The JAX package's Render (recorded) and the port's main on the
    grass_filtered render config at 16x16 (five frames, radius 20 down to
    5), each restoring one checkpoint written by the JAX package's
    CheckpointManager."""
    root = tmp_path_factory.mktemp("render")
    ckpt_dir = str(root / "source")
    cfg = _config(size=RENDER_SIZE)
    want = recorded(MODULE, "renders")
    os.makedirs(os.path.join(ckpt_dir, "checkpoints"))
    with open(os.path.join(ckpt_dir, "checkpoints", "ckpt-7.pkl"), "wb") as f:
        f.write(want["ckpt"].tobytes())

    # The port's CLI on the same config, written out as a config module.
    port_target = str(root / "port")
    module = "_torch_main_grass_filtered_cfg"
    with open(root / f"{module}.py", "w") as f:
        f.write(f"config = {dict(cfg, target_path=port_target, source_path=ckpt_dir)!r}\n")
    cwd = os.getcwd()
    os.chdir(root)
    port_log = io.StringIO()
    try:
        with contextlib.redirect_stdout(port_log):
            port_main.main([f"{module}.py", "--device", "cpu"])
    finally:
        os.chdir(cwd)
        sys.modules.pop(module, None)
        if str(root) in sys.path:
            sys.path.remove(str(root))
    return want, port_target, [tuple(d) for d in want["drops"]], port_log.getvalue()


def test_render_writes_the_jax_file_names(renders):
    want, port_target, _, _ = renders
    names = list(want["names"])
    assert names == [f"{i}.png" for i in range(5)]
    assert sorted(os.listdir(os.path.join(port_target, "media", "test"))) == names
    with open(os.path.join(port_target, "config_render.py")) as f:
        assert "# GIT COMMIT HASH: " in f.read().splitlines()[-1]


@pytest.mark.parametrize("index", range(5))
def test_render_writes_the_jax_images(renders, index):
    """Every image, in the JAX draw order (the renderer's n-th keyless call
    renders under stream_key(STREAM_PERTURB, n)): the decoded PNGs within
    one u8 level, and the alpha channel drawn at all."""
    recording, port_target, _, _ = renders
    with open(os.path.join(port_target, "media", "test", f"{index}.png"), "rb") as f:
        got = decode_png_u8(f.read()).astype(np.int32)
    want = decode_png_u8(recording[f"media/{index}.png"].tobytes()).astype(np.int32)
    assert want.shape == got.shape == (RENDER_SIZE, RENDER_SIZE, 4)
    assert want[..., 3].max() > 100
    # A one-level difference is an f32 difference that crosses a rounding
    # boundary of the u8 encoding.  Measured here: images 0-3 equal, image 4
    # one level apart in 1 of its 1024 channel values.
    assert np.abs(want - got).max() <= 1
    assert np.mean(want != got) <= 0.05


def test_render_reports_the_jax_overflows(renders):
    """The config's own caps (max_hits 64, step cap 512 below n_samples
    1024) drop intervals and samples; each frame's warnings name the
    counts the JAX package's name, in the same order, and the port's
    restore line names the checkpoint."""
    _, _, jax_drops, port_log = renders
    assert _drops(port_log) == jax_drops
    assert len(jax_drops) >= 5
    assert "Restored model from " in port_log and "ckpt-7.pkl" in port_log


class _Frames:
    """A two-item test dataset of 8x12 frames for the Logger."""

    height, width, composite_bkgd, bkgd_color = 8, 12, False, (1, 1, 1.0)

    def cardinality(self):
        return 2

    def __iter__(self):
        return iter([{"index": 0}, {"index": 1}])


@pytest.mark.parametrize("write_exr,factor", [(False, 1), (False, 2), (True, 1), (True, 2)])
def test_logger_writes_the_jax_images(tmp_path, write_exr, factor):
    """The eval Logger's image path on fixed renderer outputs: premultiplied
    color and alpha to straight alpha (PNG) or kept as is (EXR), after the
    optional filtered downsample; the same files as the JAX Logger's."""
    from nerftex_tpu.render.logger import Logger as JaxLogger
    from nerftex_torch.render.logger import Logger
    from nerftex_torch.utils.exr import read_exr

    rs = np.random.RandomState(factor)
    alpha = rs.uniform(0, 1, (2, 1, 96)).astype(np.float32)
    color = (rs.uniform(0, 1, (2, 1, 96, 3)) * alpha[..., None]).astype(np.float32)

    def renderer(to_tensor):
        def render(index, **kwargs):
            return {"color_pred": to_tensor(color[index]), "alpha_pred": to_tensor(alpha[index])}
        return render

    kw = dict(checkpoint_variables={}, dataset=_Frames(), is_training=False,
              write_exr=write_exr, downsampling_factor=factor)
    JaxLogger(str(tmp_path / "jax"), renderer=renderer(np.asarray), **kw)
    Logger(str(tmp_path / "port"), renderer=renderer(torch.from_numpy), **kw)
    suffix = ".exr" if write_exr else ".png"
    for i in range(2):
        paths = [tmp_path / side / "media" / "test" / f"{i}{suffix}" for side in ("jax", "port")]
        if write_exr:
            want, got = (read_exr(str(p)) for p in paths)
            assert want.shape == (8 // factor, 12 // factor, 4)
            # filtered_downsample: the same products summed in another
            # order (tests/test_torch_data.py).
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        else:
            want, got = (decode_png_u8(p.read_bytes()).astype(np.int32) for p in paths)
            assert want.shape == (8 // factor, 12 // factor, 4)
            assert np.abs(got - want).max() <= (0 if factor == 1 else 1)


@contextlib.contextmanager
def _debug_nans(monkeypatch, on):
    """NERFTEX_DEBUG_NANS set (or unset) for the block; the checks and
    autograd's anomaly mode are off again after it."""
    from nerftex_torch.utils import debug

    if on:
        monkeypatch.setenv("NERFTEX_DEBUG_NANS", "1")
    else:
        monkeypatch.delenv("NERFTEX_DEBUG_NANS", raising=False)
    try:
        yield debug
    finally:
        monkeypatch.delenv("NERFTEX_DEBUG_NANS", raising=False)
        debug.maybe_enable_debug_checks()
        assert not torch.is_anomaly_enabled()


@pytest.mark.parametrize("debug_nans", [False, True])
def test_debug_nans_raises_on_a_nan_loss_through_main(tmp_path, monkeypatch, debug_nans):
    """configs/config_carpet_train.py through main on the CPU, cut to two
    steps of 8 rays x 16 samples at depth 3 and width 64, with a NaN
    injected into every loss: NERFTEX_DEBUG_NANS raises in the first step's
    backward pass (autograd's anomaly mode) or at its loss; without it the
    run completes and logs the NaN losses, as the JAX package's does."""
    from nerftex_torch.render import loss as port_loss
    from nerftex_torch.tools.synth import make_synthetic_tfrecord

    monkeypatch.setenv("NERFTEX_NO_TENSORBOARD", "1")
    cfg = copy.deepcopy(importlib.import_module("configs.config_carpet_train").config)
    proxy = cfg["train_dataset_config"]["proxy_config"]
    tfr = str(tmp_path / "train.tfr")
    make_synthetic_tfrecord(tfr, n_images=4, size=16,
                            n_parameters=tuple(cfg["model_config"]["n_parameters"]),
                            b_0=tuple(proxy["b_0"]), b_1=tuple(proxy["b_1"]))
    cfg["target_path"] = str(tmp_path / "logs")
    cfg["n_iters"] = 2
    cfg["train_dataset_config"]["data_loader_config"]["tfr_path"] = tfr
    cfg["train_dataset_config"]["pixel_sampler_config"].update(n_samples=8, downsample_factor=2)
    cfg["val_dataset_config"]["data_loader_config"].update(height=8, width=8)
    cfg["model_config"].update(depth=3, width=64, skips=[1])
    cfg["renderer_config"]["n_samples"] = 16
    cfg["logger_config"].update(i_summary=1, i_img=100, i_checkpoint=100)
    with open(tmp_path / "nan_train.py", "w") as f:
        f.write(f"config = {cfg!r}\n")
    real = port_loss.AlphaLoss.__call__
    monkeypatch.setattr(port_loss.AlphaLoss, "__call__",
                        lambda self, **kw: real(self, **kw) * float("nan"))
    monkeypatch.chdir(tmp_path)
    with _debug_nans(monkeypatch, debug_nans):
        if debug_nans:
            with pytest.raises((FloatingPointError, RuntimeError), match="(?i)nan|finite"):
                port_main.main(["nan_train.py", "--device", "cpu"])
            assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()
        else:
            port_main.main(["nan_train.py", "--device", "cpu"])
            assert not torch.is_anomaly_enabled()
    scalars = tmp_path / "logs" / "scalars.jsonl"
    losses = ([json.loads(line)["Loss"] for line in scalars.read_text().splitlines()]
              if scalars.exists() else [])
    if debug_nans:
        assert losses == []
    else:
        assert len(losses) == 2 and np.isnan(losses).all()


@pytest.mark.parametrize("debug_nans", [False, True])
def test_debug_nans_checks_each_rendered_frame(tmp_path, monkeypatch, debug_nans):
    """The eval Logger (Render's and the validation renders' path) on a
    renderer whose second frame holds a NaN: under NERFTEX_DEBUG_NANS it
    raises FloatingPointError after writing the first image; without it
    both images are written."""
    from nerftex_torch.render.logger import Logger

    color = torch.zeros(2, 1, 96, 3)
    alpha = torch.full((2, 1, 96), 0.5)
    color[1, 0, 7, 1] = float("nan")

    def renderer(index, **kwargs):
        return {"color_pred": color[index], "alpha_pred": alpha[index]}

    kw = dict(checkpoint_variables={}, dataset=_Frames(), is_training=False)
    with _debug_nans(monkeypatch, debug_nans) as debug:
        assert debug.maybe_enable_debug_checks() == debug_nans
        if debug_nans:
            with pytest.raises(FloatingPointError, match="rendered frame: color_pred"):
                Logger(str(tmp_path), renderer=renderer, **kw)
        else:
            Logger(str(tmp_path), renderer=renderer, **kw)
    written = sorted(os.listdir(tmp_path / "media" / "test"))
    assert written == (["0.png"] if debug_nans else ["0.png", "1.png"])


JAX_CASES = {"frame": _jax_frame, "renders": _jax_render}
