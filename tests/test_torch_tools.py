"""nerftex_torch.tools against the JAX package's nerftex_tpu.tools on the
CPU, at small sizes: every file a tool writes is byte-equal to the JAX
tool's for the same input.

- gen_assets: generate() writes meshes/* as committed (seed 0), and
  generate_scale_anchors the JAX tool's bytes (at 1,000 anchors: the
  committed 10,000 take half a minute here, and chip_smoke.py checks them
  on the card);
- create_dataset's analytic backend on a 16 px, 4-view carpet config (the
  folder, json and PNGs), and its resume after a larger sampler count;
- nerf2tfr on that folder, unsharded and in shards of 3;
- blur.process with max_sigma 3 (sigmas, json and PNGs), with and
  without a dataset size increase;
- synth's torch backend (make_swatch_renderer) against the JAX package's
  make_swatch_renderer_jax and the numpy integrator at 48 px: within 2 u8
  levels of both at tests/test_toolchain.py's pose, and equal to the
  numpy integrator's u8 image on the first views of a dataset, where the
  JAX twin's float32 march is several levels off; the torch backend's
  records against the numpy backend's."""

import copy
import json
import os
import shutil

import numpy as np
import pytest
import torch

from nerftex_tpu.tools import blur as jax_blur
from nerftex_tpu.tools import create_dataset as jax_create_dataset
from nerftex_tpu.tools import gen_assets as jax_gen_assets
from nerftex_tpu.tools import nerf2tfr as jax_nerf2tfr
from nerftex_tpu.tools.synth import make_swatch_renderer_jax
from nerftex_tpu.tools.synth import make_synthetic_tfrecord as jax_synth
from nerftex_tpu.utils.util import EasyDict as JaxEasyDict
from nerftex_torch.data import tfrecord
from nerftex_torch.instancing import scene
from nerftex_torch.ops.rays import look_at
from nerftex_torch.tools import blur, create_dataset, gen_assets, nerf2tfr, synth
from nerftex_torch.utils.image import decode_png_u8
from nerftex_torch.utils.util import EasyDict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_U8_LEVELS = 2        # tests/test_toolchain.py:262
MAX_DIFFERING_SHARE = 0.2  # :263

CONFIG = {  # tests/test_toolchain.py's dataset
    "seed": 0,
    "resolution": 16,
    "angle": 0.63,
    "subsets": [{
        "name": "train",
        "cam_radius": 5,
        "pose_dist_config": {
            "module": "data.distribution.Hemisphere",
            "sampler_config": {"module": "data.sampler.Independent", "d": 2, "n": 4},
        },
        "parameter_dist_config": {
            "module": "data.distribution.Concat",
            "distribution_config_0": {
                "module": "data.distribution.AABB",
                "sampler_config": {"module": "data.sampler.Independent", "d": 4},
            },
            "distribution_config_1": {"module": "data.distribution.Sphere"},
        },
    }],
    "collections": [{
        "name": "Carpet",
        "hair_drivers": ["Length"],
        "material_drivers": ["Saturation", "UndercoatValue"],
        "light_drivers": ["Ambient", "LightDirection"],
    }],
    "pose_file_save_interval": 2,
}


def _files(directory):
    """{relative path: bytes} of every file under ``directory``."""
    out = {}
    for dirpath, _, names in os.walk(directory):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, directory)] = f.read()
    return out


def _assert_same_files(got_dir, want_dir):
    got, want = _files(got_dir), _files(want_dir)
    assert sorted(got) == sorted(want)
    for name, data in want.items():
        assert got[name] == data, name


def _both(tmp_path, name, run):
    """``run(directory, side)`` for the JAX package ("jax") and the port
    ("port") into the same path in turn (so paths written into the files
    agree); returns the two directories, moved apart."""
    target = tmp_path / name
    dirs = {}
    for side in ("jax", "port"):
        run(str(target), side)
        dirs[side] = tmp_path / f"{name}_{side}"
        shutil.move(str(target), str(dirs[side]))
    return dirs["jax"], dirs["port"]


def _render_views(target, side, n=4):
    """CONFIG's dataset at ``target`` with n views a sampler."""
    config = copy.deepcopy(CONFIG)
    config["target_path"] = target
    subset = config["subsets"][0]
    subset["pose_dist_config"]["sampler_config"]["n"] = n
    subset["parameter_dist_config"]["distribution_config_0"]["sampler_config"]["n"] = n
    if side == "jax":
        jax_create_dataset.render_views(JaxEasyDict(config), backend="analytic")
    else:
        create_dataset.render_views(EasyDict(config), backend="analytic")


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """The 4-view folder written by each package."""
    return _both(tmp_path_factory.mktemp("ds"), "carpet", _render_views)


# -- gen_assets -------------------------------------------------------------------------


def test_gen_assets_writes_the_committed_meshes(tmp_path):
    gen_assets.generate(str(tmp_path), seed=0)
    names = sorted(os.listdir(tmp_path))
    assert len(names) == 7
    for name in names:
        with open(os.path.join(ROOT, "meshes", name), "rb") as f:
            assert (tmp_path / name).read_bytes() == f.read(), name
    assert scene.vertex_normals is gen_assets.vertex_normals


def test_gen_assets_scale_anchors_are_the_jax_bytes(tmp_path):
    got = gen_assets.generate_scale_anchors(str(tmp_path / "port"), n=1000, seed=0)
    want = jax_gen_assets.generate_scale_anchors(str(tmp_path / "jax"), n=1000, seed=0)
    assert os.path.basename(got) == os.path.basename(want) == "cloth1k_anchor_points.ply"
    with open(got, "rb") as f, open(want, "rb") as g:
        assert f.read() == g.read()


# -- create_dataset, nerf2tfr, blur -------------------------------------------------------


def test_create_dataset_writes_the_jax_folder(datasets):
    """Four cam_* PNGs, transforms_train.json and config.json, byte for byte."""
    jax_dir, port_dir = datasets
    _assert_same_files(port_dir, jax_dir)
    assert len(os.listdir(port_dir / "train")) == 4


def test_create_dataset_resumes_as_jax(tmp_path, datasets):
    """Run again with six views a sampler: both packages append frames 4
    and 5 to the existing folder (the offset), the same bytes."""
    def run(target, side):
        shutil.copytree(datasets[0], target)
        _render_views(target, side, n=6)

    jax_dir, port_dir = _both(tmp_path, "resume", run)
    _assert_same_files(port_dir, jax_dir)
    assert len(os.listdir(port_dir / "train")) == 6


def test_create_dataset_blender_backend_needs_bpy(tmp_path):
    with pytest.raises(RuntimeError, match="bpy"):
        create_dataset.render_views(EasyDict(dict(CONFIG, target_path=str(tmp_path))),
                                    backend="blender")


@pytest.mark.parametrize("imgs_per_shard", [0, 3])
def test_nerf2tfr_writes_the_jax_records(tmp_path, datasets, imgs_per_shard):
    got = nerf2tfr.convert(str(datasets[0]), str(tmp_path / "port" / "train.tfr"),
                           imgs_per_shard=imgs_per_shard)
    want = jax_nerf2tfr.convert(str(datasets[0]), str(tmp_path / "jax" / "train.tfr"),
                                imgs_per_shard=imgs_per_shard)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    assert len(got) == (2 if imgs_per_shard else 1)
    for g, w in zip(got, want):
        with open(g, "rb") as f, open(w, "rb") as h:
            assert f.read() == h.read()
    assert sum(len(list(tfrecord.read_records(p))) for p in got) == 4


@pytest.mark.parametrize("increase", [1, 2])
def test_blur_writes_the_jax_folder(tmp_path, datasets, increase):
    """The sigmas (the json's first driver parameter 'Blur'), the json and
    the blurred PNGs equal the JAX tool's."""
    def run(target, side):
        tool = jax_blur if side == "jax" else blur
        tool.process(str(datasets[0]), target, subsets=("train",), max_sigma=3.0,
                     dataset_size_increase=increase)

    jax_dir, port_dir = _both(tmp_path, "blurred", run)
    _assert_same_files(port_dir, jax_dir)
    assert len(os.listdir(port_dir / "train")) == 4 * increase
    frames = json.loads((port_dir / "transforms_train.json").read_text())["frames"]
    assert [list(f["driver_parameters"])[0] for f in frames] == ["Blur"] * 4 * increase
    assert max(f["driver_parameters"]["Blur"] for f in frames) > 0


# -- synth's torch backend ----------------------------------------------------------------

B_0 = np.float32([-1.5, -1.3, -0.2])
B_1 = np.float32([1.3, 1.3, 1.9])


def _u8(rgba):
    return np.clip(rgba * 255 + 0.5, 0, 255).astype(np.int32)


def test_torch_swatch_renderer_matches_jax_and_numpy():
    """tests/test_toolchain.py's pose at 48 px: within 2 u8 levels of the
    JAX twin and of the numpy integrator, on fewer than a fifth of the
    pixels; then the first four views of a dataset (seed 0): equal to the
    numpy integrator's u8 image."""
    pose = look_at(np.array([2.0, -2.5, 2.2], np.float32)).astype(np.float32)
    params = np.float32([0.7, 0.3, 0.8, 0.2, 0.1, -0.2, -0.9])
    render = synth.make_swatch_renderer(48, 0.63, B_0, B_1, 1, device="cpu")
    got = render(pose, params).astype(np.int32)
    assert got.shape == (48, 48, 4) and got[..., 3].max() == 255
    for want in (np.asarray(make_swatch_renderer_jax(48, 0.63, B_0, B_1, 1)(pose, params)),
                 _u8(synth.render_swatch(pose, params, 1, 48, 0.63, B_0, B_1))):
        d = np.abs(got - want.astype(np.int32))
        assert d.max() <= MAX_U8_LEVELS, d.max()
        assert (d > 0).mean() < MAX_DIFFERING_SHARE
    jax_render = make_swatch_renderer_jax(48, 0.63, B_0, B_1, 1)
    jax_off = 0
    for pose, params in synth.swatch_views(4):
        want = _u8(synth.render_swatch(pose, params, 1, 48, 0.63, B_0, B_1))
        np.testing.assert_array_equal(render(pose, params), want)
        jax_off = max(jax_off, int(np.abs(np.asarray(jax_render(pose, params)) - want).max()))
    # Why the port marches in float64: the JAX twin's float32 march leaves
    # the numpy image by more than the 2 levels on these views.
    assert jax_off > MAX_U8_LEVELS, jax_off


def test_torch_backend_records(tmp_path):
    """make_synthetic_tfrecord(backend="torch") on the CPU: the numpy
    backend's records (the JAX package's bytes) but for the PNGs, whose
    pixels are the numpy backend's u8 image."""
    kw = dict(n_images=3, size=24, n_parameters=(2, 3), seed=3)
    jax_synth(str(tmp_path / "numpy.tfr"), **kw)
    synth.make_synthetic_tfrecord(str(tmp_path / "torch.tfr"), backend="torch", device="cpu",
                                  **kw)
    want = list(tfrecord.read_records(str(tmp_path / "numpy.tfr")))
    got = list(tfrecord.read_records(str(tmp_path / "torch.tfr")))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        g, w = tfrecord.parse_example(g), tfrecord.parse_example(w)
        assert set(g) == set(w)
        for key in set(w) - {"image"}:
            assert g[key] == w[key], key
        np.testing.assert_array_equal(decode_png_u8(g["image"]), decode_png_u8(w["image"]))


def test_torch_backend_refuses_a_missing_card(monkeypatch):
    """Asked for the card (or for nothing) without one, it raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            synth.make_swatch_renderer(16, 0.63, B_0, B_1, 1, device=device)
    with pytest.raises(ValueError, match="backend"):
        synth.make_synthetic_tfrecord("unused.tfr", backend="jax")
