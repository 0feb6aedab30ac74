"""nerftex_torch's data layer against the JAX package's, the same seed
through both: GenerateData records and Dataset items of the shipped render
configs, TFRecords written by either package and read by the other (and
their Dataset items), FileFolder, the RayDataset's index stream (shuffle,
epochs, take, cardinality), EXR and PNG round trips in both directions,
and filtered_downsample / interpolate_img."""

import copy
import importlib
import json
import os

import numpy as np
import pytest

from nerftex_tpu.data import dataset as jax_dataset
from nerftex_tpu.data import tfrecord as jax_tfr
from nerftex_tpu.ops import interpolate as jax_interp
from nerftex_tpu.tools.synth import make_synthetic_tfrecord
from nerftex_tpu.utils import exr as jax_exr
from nerftex_tpu.utils import image as jax_image
from nerftex_tpu.utils import rng as jax_rng_streams
from nerftex_tpu.utils import util as jax_util
from nerftex_torch.data import dataset
from nerftex_torch.data import tfrecord as tfr
from nerftex_torch.ops import interpolate
from nerftex_torch.utils import exr, image, rng
from nerftex_torch.utils.util import EasyDict, instantiate

BOX = {"module": "network.proxy.AABB", "b_0": [-1.5, -1.3, -0.2], "b_1": [1.3, 1.3, 1.9]}


def _both(config, seed=0):
    """instantiate(config) in the JAX package and in the port, each right
    after set_seed(seed)."""
    jax_rng_streams.set_seed(seed)
    want = jax_util.instantiate(jax_util.EasyDict(copy.deepcopy(config)))
    rng.set_seed(seed)
    got = instantiate(EasyDict(copy.deepcopy(config)))
    return want, got


def _assert_items_equal(want, got):
    """Every batch of two datasets equal, key by key, dtype included."""
    want, got = list(want), list(got)
    assert len(want) == len(got) > 0
    for a, b in zip(want, got):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def _assert_records_equal(want, got):
    assert len(want) == len(got)
    for i in range(len(want)):
        a, b = want[i], got[i]
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)


@pytest.mark.parametrize("scene", ["carpet", "grass_filtered", "carpet10k"])
def test_render_config_datasets_equal_jax(scene):
    """GenerateData's records (the Sphere over Concat(Independent, Grid)
    poses; grass_filtered's radius drawn from an AABB over a Grid) and the
    Dataset's items (Full pixels, Proxy rays) at the config's 512x512."""
    cfg = importlib.import_module(f"configs.config_{scene}_render").config
    want, got = _both(cfg["test_dataset_config"], seed=cfg["seed"])
    _assert_records_equal(want.source, got.source)
    for attr in ("height", "width", "focal", "composite_bkgd", "n_samples", "n_parameters"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert got.cardinality() == want.cardinality() == 5
    _assert_items_equal(want, got)


def test_generated_stream_equals_jax():
    """More than 256 records: GenerateData streams them (GeneratorSource),
    each pass from the start drawing anew, as the JAX package does."""
    cfg = {"module": "network.dataset.GenerateData", "height": 8, "width": 8,
           "pose_dist_config": {"module": "data.distribution.Sphere"},
           "parameter_dist_config": {"module": "data.distribution.Constant",
                                     "constants": [[0.5, 1.0], [0.25, 0.0]]},
           "dataset_size": 300}
    def records(package_rng, build):
        # The stream draws from the global numpy state as it is read.
        package_rng.set_seed(0)
        source = build(copy.deepcopy(cfg))[0]
        return type(source).__name__, len(source), [source[i] for i in (0, 1, 5, 2)]

    want = records(jax_rng_streams, lambda c: jax_util.instantiate(jax_util.EasyDict(c)))
    got = records(rng, lambda c: instantiate(EasyDict(c)))
    assert got[:2] == want[:2] == ("GeneratorSource", 300)
    for a, b in zip(want[2], got[2]):
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)


@pytest.fixture(scope="module")
def jax_tfrecord(tmp_path_factory):
    """A synthetic TFRecord written by the JAX package (four 16x16 swatch
    renders with n_parameters [1, 4])."""
    path = str(tmp_path_factory.mktemp("tfr") / "synth.tfr")
    return make_synthetic_tfrecord(path, n_images=4, size=16, n_parameters=(1, 4), seed=3)


def _tfrecord_dataset(path, pixel_sampler, composite_bkgd=False):
    return {
        "module": "network.dataset.Dataset",
        "data_loader_config": {"module": "network.dataset.TFRecord", "tfr_path": path,
                               "composite_bkgd": composite_bkgd},
        "pixel_sampler_config": dict(pixel_sampler),
        "ray_sampler_config": {"module": "network.ray_sampler.Proxy"},
        "proxy_config": BOX,
        "n_epochs": 2, "batchsize": 3, "shuffle_buffer_size": 3,
    }


@pytest.mark.parametrize("composite_bkgd", [False, True])
@pytest.mark.parametrize("pixel_sampler", [
    {"module": "network.pixel_sampler.Proxy", "n_samples": 32, "downsample_factor": 4},
    {"module": "network.pixel_sampler.Independent", "n_samples": 32},
    {"module": "network.pixel_sampler.Full"},
], ids=["proxy", "independent", "full"])
def test_jax_written_tfrecord_reads_equal(jax_tfrecord, pixel_sampler, composite_bkgd):
    """The port reads the JAX package's TFRecord as the JAX package does:
    the decoded records and the shuffled, batched, two-epoch item stream
    with its pixel draws."""
    want, got = _both(_tfrecord_dataset(jax_tfrecord, pixel_sampler, composite_bkgd), seed=5)
    _assert_records_equal(want.source, got.source)
    assert got.cardinality() == want.cardinality() == 3
    assert (got.height, got.width, got.focal) == (want.height, want.width, want.focal)
    jax_rng_streams.set_seed(9)
    items_want = list(want)
    rng.set_seed(9)
    _assert_items_equal(items_want, list(got))


@pytest.mark.parametrize("compression", [None, "GZIP"])
def test_port_written_tfrecord_reads_equal_in_jax(tmp_path, compression):
    """A TFRecord the port writes (its PNG encoder, tensors and framing) is
    read by the JAX package's loader as by the port's, and the two codecs
    write the same bytes."""
    rs = np.random.RandomState(0)
    payloads, jax_payloads = [], []
    for i in range(3):
        rgba = rs.uniform(0, 1, (8, 12, 4)).astype(np.float32)
        pose = rs.normal(size=(4, 4)).astype(np.float32)
        prm = rs.uniform(size=5).astype(np.float32)
        payloads.append(tfr.build_example({
            "image": image.encode_png(rgba), "pose": tfr.serialize_tensor(pose),
            "angle": 0.6, "parameters": tfr.serialize_tensor(prm),
            "count": np.asarray([i, 7], np.int64)}))
        jax_payloads.append(jax_tfr.build_example({
            "image": jax_image.encode_png(rgba), "pose": jax_tfr.serialize_tensor(pose),
            "angle": 0.6, "parameters": jax_tfr.serialize_tensor(prm),
            "count": np.asarray([i, 7], np.int64)}))
    assert payloads == jax_payloads
    path = str(tmp_path / "port.tfr")
    tfr.write_records(path, payloads, compression_type=compression)
    assert list(jax_tfr.read_records(path, compression, verify_crc=True)) == payloads
    assert list(tfr.read_records(path, compression, verify_crc=True)) == payloads
    want = jax_dataset.TFRecord(path, compression_type=compression)
    got = dataset.TFRecord(path, compression_type=compression)
    assert got[1:] == want[1:]
    _assert_records_equal(want[0], got[0])
    ex = tfr.parse_example(payloads[2])
    np.testing.assert_array_equal(ex["count"], [2, 7])
    np.testing.assert_array_equal(tfr.parse_tensor(ex["pose"]),
                                  jax_tfr.parse_tensor(ex["pose"]))


def test_file_folder_reads_equal(tmp_path):
    """FileFolder: PNGs and a transforms json with driver parameters, the
    indices picked by idxs."""
    rs = np.random.RandomState(1)
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    frames = []
    for i in range(4):
        jax_image.write_image(str(imgs / f"r_{i}.png"),
                              rs.uniform(0, 1, (10, 14, 4)).astype(np.float32))
        frames.append({"transform_matrix": rs.normal(size=(4, 4)).tolist(),
                       "driver_parameters": {"b": float(rs.uniform()), "a": float(i)}})
    with open(tmp_path / "transforms.json", "w") as f:
        json.dump({"camera_angle_x": 0.7, "frames": frames}, f)
    cfg = {"module": "network.dataset.FileFolder", "imgs_path": str(imgs),
           "poses_path": str(tmp_path / "transforms.json"), "idxs": [0, 2, 3],
           "composite_bkgd": True}
    want, got = _both(cfg)
    _assert_records_equal(want[0], got[0])
    assert got[1:] == want[1:] and got[1:3] == (10, 14)


def test_ray_dataset_index_stream_equals_jax():
    """Shuffle buffer, epochs, batching, take and cardinality over a list
    source, with the prefetch thread on and off."""
    records = [{"x": np.full(2, i, np.float32)} for i in range(7)]
    for prefetch in (0, 2):
        kw = dict(data_map=lambda r: r, batchsize=3, n_epochs=2, shuffle_buffer_size=4,
                  prefetch=prefetch)
        want = jax_dataset.RayDataset(jax_dataset.ListSource(records), **kw)
        got = dataset.RayDataset(dataset.ListSource(records), **kw)
        assert got.cardinality() == want.cardinality() == len(got) == 5
        jax_rng_streams.set_seed(4)
        w = list(want)
        rng.set_seed(4)
        _assert_items_equal(w, list(got))
        jax_rng_streams.set_seed(4)
        w = list(want.take(2))
        rng.set_seed(4)
        _assert_items_equal(w, list(got.take(2)))
    infinite = dataset.RayDataset(dataset.ListSource(records), lambda r: r, 2, None, 1)
    assert infinite.cardinality() == -1
    with pytest.raises(TypeError):
        len(infinite)


def test_float_pixel_locations_interpolate_the_image(jax_tfrecord, monkeypatch):
    """A pixel sampler that returns float locations samples the image
    bilinearly (interpolate_img), as the JAX package's Dataset does."""
    locs = np.random.RandomState(2).uniform(0, 15, (20, 2)).astype(np.float32)

    class FloatPixels:
        def __init__(self, **kwargs):
            pass

        def __call__(self, **kwargs):
            return locs

    import nerftex_torch.data.pixel_sampler as port_ps
    import network.pixel_sampler as jax_ps

    monkeypatch.setattr(port_ps, "Full", FloatPixels)
    monkeypatch.setattr(jax_ps, "Full", FloatPixels)
    cfg = _tfrecord_dataset(jax_tfrecord, {"module": "network.pixel_sampler.Full"})
    want, got = _both(dict(cfg, shuffle_buffer_size=1, n_epochs=1))
    w, g = next(iter(want)), next(iter(got))
    for k in ("color", "alpha"):
        # float32 bilinear weights, the same operations in both: equal here;
        # 1e-6 allows for a different fma contraction.
        np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(g["rays_d"], w["rays_d"])


def test_device_resident_dataset_raises():
    """A render config's dataset (Full pixels) cannot be device-resident:
    the sampler takes Proxy or Independent pixels only, and says so, as the
    JAX package's does (tests/test_torch_device_train.py covers the rest)."""
    cfg = importlib.import_module("configs.config_carpet_render").config
    with pytest.raises(ValueError, match="Proxy/Independent pixel samplers"):
        instantiate(dict(cfg["test_dataset_config"], device_resident=True))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_exr_round_trips_agree(tmp_path, channels):
    img = np.random.RandomState(channels).normal(size=(6, 9, channels)).astype(np.float32)
    exr.write_exr(str(tmp_path / "port.exr"), img)
    jax_exr.write_exr(str(tmp_path / "jax.exr"), img)
    assert (tmp_path / "port.exr").read_bytes() == (tmp_path / "jax.exr").read_bytes()
    np.testing.assert_array_equal(jax_exr.read_exr(str(tmp_path / "port.exr")), img)
    np.testing.assert_array_equal(exr.read_exr(str(tmp_path / "jax.exr")), img)
    image.write_image(str(tmp_path / "img.exr"), img)
    np.testing.assert_array_equal(jax_image.read_exr(str(tmp_path / "img.exr")), img)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_round_trips_agree(tmp_path, channels):
    img = np.random.RandomState(channels).uniform(-0.1, 1.1, (7, 5, channels)).astype(np.float32)
    data = image.encode_png(img)
    assert data == jax_image.encode_png(img)
    np.testing.assert_array_equal(jax_image.decode_png(data), image.decode_png(data))
    np.testing.assert_array_equal(jax_image.decode_png_u8(data), image.decode_png_u8(data))
    image.write_image(str(tmp_path / "port.png"), img)
    jax_image.write_image(str(tmp_path / "jax.png"), img)
    np.testing.assert_array_equal(image.read_image(str(tmp_path / "jax.png")),
                                  jax_image.read_image(str(tmp_path / "port.png")))


@pytest.mark.parametrize("shape,factor", [((16, 16), 2), ((17, 23), 3), ((64, 48), 4),
                                          ((512, 512), 8), ((20, 20), 1)])
def test_filtered_downsample_matches_jax(shape, factor):
    """The Gaussian kernel and the strided depthwise conv with XLA's SAME
    padding.  Both sum the same products in float32 in their own order, so
    they agree to the last few bits (measured: 6.6e-7 at most)."""
    img = np.random.RandomState(factor).uniform(0, 1, shape + (4,)).astype(np.float32)
    want = np.asarray(jax_interp.filtered_downsample(img, factor))
    got = interpolate.filtered_downsample(img, factor).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    size = int(factor * 0.5 * 6)
    np.testing.assert_allclose(interpolate.gaussian_kernel(size, factor * 0.5, 4).numpy(),
                               np.asarray(jax_interp.gaussian_kernel(size, factor * 0.5, 4)),
                               rtol=0, atol=1e-7)


def test_interpolate_img_matches_jax():
    """Bilinear lookups inside the image and past its borders (clamped)."""
    rs = np.random.RandomState(0)
    img = rs.uniform(0, 1, (13, 9, 3)).astype(np.float32)
    x = rs.uniform(-1.5, 14.0, (200, 2)).astype(np.float32)
    np.testing.assert_allclose(interpolate.interpolate_img(x, img).numpy(),
                               np.asarray(jax_interp.interpolate_img(x, img)), rtol=0, atol=1e-6)
