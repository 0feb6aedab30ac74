"""nerftex_torch stands alone: no file of the package, nor chip_smoke.py,
imports jax, optax, nerftex_tpu or the config shims that resolve to it; the
package (the serving and training modules included) imports with all of
them blocked; every render and train config the port supports resolves
inside the port, main trains one with all of them blocked, and an unported
reference path raises instead of reaching the JAX package; and an entry
point given no device raises when CUDA is absent instead of running on the
CPU."""

import ast
import os
import subprocess
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_threads import one_torch_thread  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "optax", "nerftex_tpu", "network", "instancer", "util", "data")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "nerftex_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return files


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_file_imports_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 15
    bad = [(os.path.relpath(p, ROOT), m) for p in files for m in _imported_roots(p)
           if m in FORBIDDEN]
    assert not bad, bad


def test_package_imports_with_jax_blocked():
    modules = sorted(
        os.path.relpath(p, ROOT)[:-3].replace(os.sep, ".").removesuffix(".__init__")
        for p in _port_files() if p.startswith(os.path.join(ROOT, "nerftex_torch"))
    )
    for m in ("nerftex_torch.utils.rng", "nerftex_torch.data.sampler",
              "nerftex_torch.data.distribution", "nerftex_torch.operating_points",
              "nerftex_torch.render.serve", "nerftex_torch.render.checkpoint",
              "nerftex_torch.main", "nerftex_torch.render.render", "nerftex_torch.render.logger",
              "nerftex_torch.data.dataset", "nerftex_torch.data.tfrecord",
              "nerftex_torch.data.pixel_sampler", "nerftex_torch.data.ray_sampler",
              "nerftex_torch.utils.image", "nerftex_torch.utils.exr",
              "nerftex_torch.ops.interpolate", "nerftex_torch.render.train",
              "nerftex_torch.render.loss", "nerftex_torch.tools.synth",
              "nerftex_torch.data.device_dataset", "nerftex_torch.parallel",
              "nerftex_torch.parallel.mesh", "nerftex_torch.tools.gen_assets",
              "nerftex_torch.tools.nerf2tfr", "nerftex_torch.tools.blur",
              "nerftex_torch.tools.create_dataset", "nerftex_torch.instancing.oracle",
              "nerftex_torch.utils.debug"):
        assert m in modules, m
    code = (
        "import sys\n"
        f"for name in {FORBIDDEN!r}:\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "print('ok', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.startswith("ok")


def test_entry_points_without_device_raise_without_cuda(monkeypatch):
    from nerftex_torch.instancing.instancer import Instancer
    from nerftex_torch.models.mlp import ParamNerf
    from nerftex_torch.utils.util import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    ff = {"module": "network.model.FourierFeatures", "n_freq_bands": 2}
    with pytest.raises(RuntimeError, match="CUDA"):
        ParamNerf(ff, ff, ff, [1, 6], depth=2, width=32)
    with pytest.raises(RuntimeError, match="CUDA"):
        Instancer(b_0=[-1, -1, -1], b_1=[1, 1, 1], instance_sampling_method="nearest",
                  transformations=[list(map(list, torch.eye(4).tolist()))])
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_wrappers_refuse_foreign_devices():
    """A tensor that is neither on the CPU nor on CUDA reaches no fallback."""
    from nerftex_torch.kernels import tex_gather

    uv = torch.zeros(4, 2, device="meta")
    with pytest.raises(ValueError):
        tex_gather.sample_channel(torch.zeros(2, 2, device="meta"), uv)


SUPPORTED_RENDER_CONFIGS = (
    "config_carpet_render", "config_carpet10k_render", "config_grass_render",
    "config_grass_filtered_render", "config_plush_render", "demo_carpet_render",
    "demo_grass_render", "demo_grass_filtered_render", "demo_grass_mip_render",
    "demo_plush_render", "full_carpet_render",
)


def _resolve_in_subprocess(configs, body):
    """Run ``body`` in a fresh interpreter after collecting every "module"
    path of each config in ``configs`` into ``paths`` ({config: [path]});
    returns its stdout.  The body ends by printing the jax and nerftex_tpu
    modules it finds in sys.modules."""
    code = (
        "import importlib, sys\n"
        "from nerftex_torch.utils import util\n"
        "def walk(node, out):\n"
        "    if isinstance(node, dict):\n"
        "        if isinstance(node.get('module'), str):\n"
        "            out.append(node['module'])\n"
        "        for v in node.values():\n"
        "            walk(v, out)\n"
        "    elif isinstance(node, (list, tuple)):\n"
        "        for v in node:\n"
        "            walk(v, out)\n"
        "    return out\n"
        f"paths = {{c: walk(importlib.import_module('configs.' + c).config, []) "
        f"for c in {tuple(configs)!r}}}\n"
        + body +
        "print('loaded', sorted(m for m in sys.modules\n"
        "                       if m.split('.')[0] in ('jax', 'nerftex_tpu', 'optax')))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_supported_render_configs_resolve_inside_the_port():
    """Every module path of every render config the port supports names a
    nerftex_torch object, and resolving them all imports no jax and no
    nerftex_tpu module."""
    out = _resolve_in_subprocess(SUPPORTED_RENDER_CONFIGS, (
        "for c, ps in paths.items():\n"
        "    assert len(ps) >= 10, (c, ps)\n"
        "    for p in ps:\n"
        "        obj = util.get_attr_from_path(p)\n"
        "        print(c, p, obj.__module__)\n"
    ))
    lines = out.splitlines()
    assert lines[-1] == "loaded []", lines[-1]
    resolved = [line.split() for line in lines[:-1]]
    assert {c for c, _, _ in resolved} == set(SUPPORTED_RENDER_CONFIGS)
    assert {p for _, p, _ in resolved} >= {
        "network.render.Render", "network.logger.Logger", "network.dataset.Dataset",
        "network.dataset.GenerateData", "network.pixel_sampler.Full",
        "network.ray_sampler.Proxy", "network.renderer.InstanceRenderer"}
    outside = [r for r in resolved if not r[2].startswith("nerftex_torch.")]
    assert not outside, outside


SUPPORTED_TRAIN_CONFIGS = (
    "config_carpet_train", "config_fur_train", "config_grass_train",
    "config_grass_filtered_train", "config_plush_train", "demo_carpet_train", "demo_fur_train",
    "demo_grass_train", "demo_grass_filtered_train", "demo_grass_mip_train",
    "demo_grass_mip_imp_train", "demo_plush_train", "full_carpet_train",
    "full_carpet_train_device",
)


def test_supported_train_configs_resolve_inside_the_port():
    """Every module path of every train config the port supports names a
    nerftex_torch object, with no jax and no nerftex_tpu module imported."""
    out = _resolve_in_subprocess(SUPPORTED_TRAIN_CONFIGS, (
        "for c, ps in paths.items():\n"
        "    for p in ps:\n"
        "        obj = util.get_attr_from_path(p)\n"
        "        print(c, p, obj.__module__)\n"
    ))
    lines = out.splitlines()
    assert lines[-1] == "loaded []", lines[-1]
    resolved = [line.split() for line in lines[:-1]]
    assert {c for c, _, _ in resolved} == set(SUPPORTED_TRAIN_CONFIGS)
    assert {p for _, p, _ in resolved} >= {
        "network.train.Train", "network.loss.AlphaLoss", "network.renderer.Renderer",
        "network.pixel_sampler.Proxy", "network.dataset.TFRecord", "network.logger.Logger"}
    outside = [r for r in resolved if not r[2].startswith("nerftex_torch.")]
    assert not outside, outside


# The offline dataset tools' reference paths and the port's module of each.
TOOL_PATHS = {
    "data.blur.process": "nerftex_torch.tools.blur",
    "data.blur.blur_png": "nerftex_torch.tools.blur",
    "data.blur.inv_cdf": "nerftex_torch.tools.blur",
    "data.nerf2tfr.convert": "nerftex_torch.tools.nerf2tfr",
    "data.create_dataset.render_views": "nerftex_torch.tools.create_dataset",
}


@pytest.mark.parametrize("path", [
    "data.blur.process", "data.nerf2tfr.convert", "data.create_dataset.render_views",
    "network.model.Model", "data.blur.blur_png", "data.blur.inv_cdf",
])
def test_unported_paths_raise_and_import_no_jax(path):
    """The offline dataset tools' reference paths resolve into
    nerftex_torch.tools; a reference path the port does not map (the JAX
    model wrapper) raises UnportedPathError (a NotImplementedError) that
    names it, instead of reaching nerftex_tpu through a shim; nothing of
    jax or nerftex_tpu is imported either way."""
    out = _resolve_in_subprocess((), (
        "try:\n"
        f"    print('resolved', util.get_attr_from_path({path!r}).__module__)\n"
        "except util.UnportedPathError as e:\n"
        "    assert isinstance(e, NotImplementedError)\n"
        "    print('raised', e)\n"
    ))
    lines = out.splitlines()
    if path in TOOL_PATHS:
        assert lines[0] == f"resolved {TOOL_PATHS[path]}", lines
    else:
        assert lines[0].startswith("raised") and repr(path) in lines[0], lines
    assert lines[-1] == "loaded []", lines[-1]


def _run_main_in(tmp_path, config_body):
    """nerftex_torch.main on a config module written to tmp_path (run from
    there on the CPU, with jax, optax and nerftex_tpu blocked); returns its
    stdout, which ends with the jax and nerftex_tpu modules loaded."""
    (tmp_path / "cfg.py").write_text(config_body)
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'optax', 'nerftex_tpu'):\n"
        "    sys.modules[name] = None\n"
        "from nerftex_torch import main\n"
        "try:\n"
        "    main.main(['cfg.py', '--device', 'cpu'])\n"
        "except NotImplementedError as e:\n"
        "    print('raised', e)\n"
        "print('loaded', sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'nerftex_tpu', 'optax') and sys.modules[m] is not None))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          env=dict(os.environ, PYTHONPATH=ROOT, NERFTEX_NO_TENSORBOARD="1"),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout.splitlines()


def test_main_trains_the_device_resident_config_without_jax(tmp_path):
    """The device-resident carpet config (device_resident, steps_per_dispatch
    100, bf16, save_encodings, net_chunk 16384), cut to CPU size (4 x 16^2
    swatches, depth 2, width 32), trains through main with jax, optax and
    nerftex_tpu blocked; nothing of it raises NotImplementedError now."""
    lines = _run_main_in(tmp_path, (
        "import copy\n"
        "from configs.full_carpet_train_device import config as _config\n"
        "from nerftex_torch.tools.synth import make_synthetic_tfrecord\n"
        "config = copy.deepcopy(_config)\n"
        "tfr = make_synthetic_tfrecord('train.tfr', n_images=4, size=16)\n"
        "config.update(target_path='logs', n_iters=4)\n"
        "config['train_dataset_config']['data_loader_config']['tfr_path'] = tfr\n"
        "config['train_dataset_config']['pixel_sampler_config'].update(n_samples=8, "
        "downsample_factor=2)\n"
        "config['val_dataset_config']['data_loader_config'].update(height=8, width=8)\n"
        "config['model_config'].update(depth=2, width=32, skips=[0])\n"
        "config['renderer_config'].update(n_samples=8, net_chunk=64)\n"
        "config['logger_config'].update(i_summary=1, i_img=4, i_checkpoint=4)\n"))
    assert lines[-1] == "loaded []", lines
    assert not any(line.startswith("raised") for line in lines), lines
    assert len((tmp_path / "logs" / "scalars.jsonl").read_text().splitlines()) == 4
    assert (tmp_path / "logs" / "checkpoints" / "ckpt-4.pkl").exists()
    assert (tmp_path / "logs" / "media" / "validation" / "4" / "0.png").exists()


def test_main_trains_a_train_config_without_jax(tmp_path):
    """configs/config_carpet_train.py, cut to CPU size, trains two steps
    through main on a synthetic TFRecord with jax, optax and nerftex_tpu
    blocked."""
    lines = _run_main_in(tmp_path, (
        "import copy\n"
        "from configs.config_carpet_train import config as _config\n"
        "from nerftex_torch.tools.synth import make_synthetic_tfrecord\n"
        "config = copy.deepcopy(_config)\n"
        "tfr = make_synthetic_tfrecord('train.tfr', n_images=4, size=16)\n"
        "config.update(target_path='logs', n_iters=2)\n"
        "config['train_dataset_config']['data_loader_config']['tfr_path'] = tfr\n"
        "config['train_dataset_config']['pixel_sampler_config'].update(n_samples=8, "
        "downsample_factor=2)\n"
        "config['val_dataset_config']['data_loader_config'].update(height=8, width=8)\n"
        "config['model_config'].update(depth=2, width=32, skips=[0])\n"
        "config['renderer_config']['n_samples'] = 8\n"
        "config['logger_config'].update(i_summary=1, i_img=2, i_checkpoint=2)\n"))
    assert lines[-1] == "loaded []", lines
    assert not any(line.startswith("raised") for line in lines), lines
    assert len((tmp_path / "logs" / "scalars.jsonl").read_text().splitlines()) == 2
    assert (tmp_path / "logs" / "checkpoints" / "ckpt-2.pkl").exists()
