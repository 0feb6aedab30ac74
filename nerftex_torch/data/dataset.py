"""Dataset factory: image/pose/parameter sources -> per-step ray batches
(the port's own copy of nerftex_tpu/data/dataset.py).

A host-side numpy iterator with tf.data's semantics (streaming buffer
shuffle, epoch repeat, batching) and an optional background prefetch
thread.  Pixel and ray sampling run on the host; a renderer moves each
dense, fixed-shape batch to its own device.  The records and items are the
JAX package's for the same seed (utils/rng.set_seed seeds numpy).
"""

import itertools
import json
import os
import queue
import threading
from math import tan
from typing import Any, Tuple, Union

import numpy as np

from nerftex_torch.data import tfrecord as tfr
from nerftex_torch.data.device_dataset import DeviceResidentSampler
from nerftex_torch.ops.interpolate import interpolate_img
from nerftex_torch.ops.rays import look_at
from nerftex_torch.utils import trace, util
from nerftex_torch.utils.image import decode_png, read_image
from nerftex_torch.utils.util import EasyDict


# ---------------------------------------------------------------------------
# Record sources
# ---------------------------------------------------------------------------


class ListSource:
    def __init__(self, records: list):
        self.records = records

    def __len__(self):
        return len(self.records)

    def __getitem__(self, i):
        return self.records[i]


class LazyTFRecordSource:
    """Holds raw tf.Example payload parses; decodes images on access with a
    small LRU so multi-GB datasets never fully materialize as float32."""

    def __init__(self, examples, read_exr, composite_bkgd, bkgd_color, cache_size=128):
        self.examples = examples
        self.read_exr = read_exr
        self.composite_bkgd = composite_bkgd
        self.bkgd_color = np.asarray(bkgd_color, np.float32)
        self.cache_size = cache_size
        self._cache = {}
        self._order = []

    def __len__(self):
        return len(self.examples)

    def __getitem__(self, i):
        if i in self._cache:
            trace.count("decode.hit")
            return self._cache[i]
        trace.count("decode.miss")
        with trace.span("data.decode"):
            record = self._decode(self.examples[i])
        self._cache[i] = record
        self._order.append(i)
        if len(self._order) > self.cache_size:
            del self._cache[self._order.pop(0)]
        return record

    def _decode(self, ex) -> dict:
        record = {
            "pose": tfr.parse_tensor(ex["pose"]).astype(np.float32).reshape(4, 4),
            "parameters": tfr.parse_tensor(ex["parameters"]).astype(np.float32).reshape(-1),
        }
        if self.read_exr:
            img = tfr.parse_tensor(ex["image"]).astype(np.float32)
            record["image"] = img[..., :3]
            record["alpha"] = img[..., 3]
        else:
            img = decode_png(ex["image"])
            # Premultiplied color.
            if self.composite_bkgd:
                record["image"] = img[..., :3] * img[..., 3:] + (1 - img[..., 3:]) * self.bkgd_color
            else:
                record["image"] = img[..., :3] * img[..., 3:]
            record["alpha"] = img[..., 3]
        return record


class GeneratorSource:
    """Wraps a record-generator fn with a nominal length (regenerated per
    epoch pass; mirrors tf.data.Dataset.from_generator + take)."""

    def __init__(self, gen_fn, n):
        self.gen_fn = gen_fn
        self.n = n
        self._it = None
        self._next_idx = 0

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if self._it is None or i < self._next_idx:
            self._it = self.gen_fn()
            self._next_idx = 0
        while True:
            record = next(self._it)
            self._next_idx += 1
            if self._next_idx - 1 == i:
                return record


# ---------------------------------------------------------------------------
# The dataset iterable
# ---------------------------------------------------------------------------


class RayDataset:
    """Iterable of batched ray dicts with the reference's dataset attributes
    attached: height/width/focal/composite_bkgd/bkgd_color/n_samples/
    n_parameters."""

    def __init__(
        self,
        source,
        data_map,
        batchsize: int,
        n_epochs,
        shuffle_buffer_size: int,
        prefetch: int = 2,
    ):
        self.source = source
        self.data_map = data_map
        self.batchsize = batchsize
        self.n_epochs = n_epochs
        self.shuffle_buffer_size = shuffle_buffer_size
        self.prefetch = prefetch
        # Attributes set by Dataset() after construction.
        self.height = self.width = self.focal = None
        self.composite_bkgd = False
        self.bkgd_color = [1, 1, 1.0]
        self.n_samples = None
        self.n_parameters = None

    # -- iteration ------------------------------------------------------

    def _index_stream(self, limit_batches=None):
        """Shuffled, repeated record indices (tf.data shuffle->repeat)."""
        n = len(self.source)
        epoch = 0
        buffer = []
        emitted = 0
        limit = None if limit_batches is None else limit_batches * self.batchsize
        while self.n_epochs is None or epoch < self.n_epochs:
            for i in range(n):
                buffer.append((epoch, i))
                if len(buffer) >= max(1, self.shuffle_buffer_size):
                    k = np.random.randint(len(buffer)) if self.shuffle_buffer_size > 1 else 0
                    yield buffer.pop(k)
                    emitted += 1
                    if limit is not None and emitted >= limit:
                        return
            epoch += 1
        while buffer:
            k = np.random.randint(len(buffer)) if self.shuffle_buffer_size > 1 else 0
            yield buffer.pop(k)
            emitted += 1
            if limit is not None and emitted >= limit:
                return

    def _example_stream(self, limit_batches=None):
        batch = []
        for _, idx in self._index_stream(limit_batches):
            batch.append(self.data_map(self.source[idx]))
            if len(batch) == self.batchsize:
                yield _collate(batch)
                batch = []
        if batch:
            yield _collate(batch)

    def __iter__(self):
        return self.take(None)

    def take(self, n_batches):
        if self.prefetch and self.prefetch > 0:
            return _prefetch_iter(lambda: self._example_stream(n_batches), self.prefetch)
        return self._example_stream(n_batches)

    def cardinality(self) -> int:
        if self.n_epochs is None:
            return -1
        n = len(self.source) * self.n_epochs
        return -(-n // self.batchsize)

    def __len__(self):
        c = self.cardinality()
        if c < 0:
            raise TypeError("infinite dataset")
        return c


def _collate(batch: list) -> dict:
    return {key: np.stack([ex[key] for ex in batch]) for key in batch[0]}


def _prefetch_iter(stream_fn, depth: int):
    q = queue.Queue(maxsize=depth)
    sentinel = object()

    def worker():
        try:
            stream = iter(stream_fn())
            for index in itertools.count():
                # One batch made on this thread, a root span of its own
                # whose unit ("batch", index) no span id can equal.
                with trace.span("data.batch", unit=("batch", index)):
                    item = next(stream, sentinel)
                if item is sentinel:
                    break
                q.put(item)
        finally:
            q.put(sentinel)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    while True:
        with trace.span("data.wait"):
            item = q.get()
        if item is sentinel:
            return
        yield item


# ---------------------------------------------------------------------------
# Dataset factory (network.dataset.Dataset)
# ---------------------------------------------------------------------------


def Dataset(
    data_loader_config: EasyDict,
    pixel_sampler_config: EasyDict,
    ray_sampler_config: EasyDict = None,
    proxy_config: EasyDict = None,
    n_epochs: int = None,
    batchsize: int = 1,
    shuffle_buffer_size: int = 1,
    step=None,
    prefetch: int = 2,
    device_resident: bool = False,
    device=None,
) -> RayDataset:
    """Compose loader + pixel sampler + ray sampler + proxy into a batched
    ray dataset.

    device_resident=True also builds ``dataset.device_sampler``, a
    data.device_dataset.DeviceResidentSampler holding the dataset on
    ``device`` (CUDA unless given), which the training step samples from."""
    source, height, width, focal, composite_bkgd, bkgd_color = util.instantiate(
        data_loader_config
    )

    proxy = util.instantiate(proxy_config)

    pixel_sampler_config = EasyDict(pixel_sampler_config)
    pixel_sampler_config.update(
        {"height": height, "width": width, "focal": focal, "proxy": proxy, "step": step}
    )
    pixel_sampler = util.instantiate(pixel_sampler_config)

    ray_sampler = None
    if ray_sampler_config is not None:
        ray_sampler_config = EasyDict(ray_sampler_config)
        ray_sampler_config.update(
            {"height": height, "width": width, "focal": focal, "proxy": proxy, "step": step}
        )
        ray_sampler = util.instantiate(ray_sampler_config)

    def data_map(record: dict) -> dict:
        out = {"parameters": np.asarray(record["parameters"], np.float32)}

        loc = pixel_sampler(c2w=record["pose"])

        if ray_sampler is not None:
            rays_o, rays_d, t, cone_scale = ray_sampler(
                image_plane_loc=loc.astype(np.float32), c2w=record["pose"]
            )
            out.update({"rays_o": rays_o, "rays_d": rays_d, "t": t, "cone_scale": cone_scale})

        for channel in ("image", "alpha"):
            if channel in record:
                key = "color" if channel == "image" else "alpha"
                if loc.dtype.kind == "f":
                    out[key] = interpolate_img(loc, record[channel]).numpy()
                else:
                    out[key] = record[channel][loc[:, 0], loc[:, 1]]
        return out

    dataset = RayDataset(source, data_map, batchsize, n_epochs, shuffle_buffer_size, prefetch)
    dataset.height = height
    dataset.width = width
    dataset.focal = focal
    dataset.composite_bkgd = composite_bkgd
    dataset.bkgd_color = bkgd_color

    first = data_map(source[0])
    content = "rays_o" if "rays_o" in first else "color"
    dataset.n_samples = first[content].shape[0]
    dataset.n_parameters = first["parameters"].shape[-1]

    if device_resident:
        dataset.device_sampler = DeviceResidentSampler(
            source, pixel_sampler, ray_sampler, batchsize, height, width, focal, composite_bkgd,
            bkgd_color, device=device)
    return dataset


# ---------------------------------------------------------------------------
# Loaders
# ---------------------------------------------------------------------------


def TFRecord(
    tfr_path: str,
    composite_bkgd: bool = False,
    bkgd_color=(1, 1, 1.0),
    read_exr: bool = False,
    compression_type: str = None,
    cache_size: int = 128,
) -> Tuple[Any, int, int, float, bool, Any]:
    """Load a sharded TFRecord dataset.

    cache_size bounds the decoded-image LRU (set it to the dataset size for
    every image to decode exactly once)."""
    examples = []
    for path in tfr.list_tfrecord_files(tfr_path):
        for payload in tfr.read_records(path, compression_type):
            examples.append(tfr.parse_example(payload))
    if not examples:
        hint = (
            "  datasets/ is generated data — run "
            "`python scripts/make_demo_datasets.py` to rebuild every dataset "
            "the shipped configs reference."
            if "datasets/" in tfr_path or tfr_path.startswith("datasets")
            else ""
        )
        raise FileNotFoundError(f"no records found at {tfr_path}.{hint}")

    source = LazyTFRecordSource(
        examples, read_exr, composite_bkgd, bkgd_color, cache_size=cache_size
    )
    first = source[0]
    height, width = first["image"].shape[:2]
    angle = float(np.atleast_1d(examples[0]["angle"])[0])

    if read_exr:
        composite_bkgd = False

    return source, height, width, width / tan(angle / 2) / 2, composite_bkgd, bkgd_color


def FileFolder(
    imgs_path: str = None,
    poses_path: str = None,
    idxs: list = (),
    height: int = 256,
    width: int = 256,
    angle: float = 0.7,
    composite_bkgd: bool = False,
    bkgd_color=(1, 1, 1.0),
) -> Tuple[Any, int, int, float, bool, Any]:
    """NeRF-Blender spec: image folder + transforms json with
    driver_parameters."""
    records = []
    poses, parameters = [], []
    if poses_path is not None:
        poses, parameters, angle = load_poses(poses_path, idxs)
    imgs, alphas = [], []
    if imgs_path is not None:
        imgs, alphas, height, width = load_imgs(imgs_path, idxs, composite_bkgd, bkgd_color)

    n = max(len(poses), len(imgs))
    for i in range(n):
        record = {}
        if i < len(poses):
            record["pose"] = poses[i]
            record["parameters"] = parameters[i]
        else:
            record["parameters"] = np.zeros(0, np.float32)
        if i < len(imgs):
            record["image"] = imgs[i]
            record["alpha"] = alphas[i]
        records.append(record)

    return (
        ListSource(records),
        height,
        width,
        width / tan(angle / 2) / 2,
        composite_bkgd,
        bkgd_color,
    )


def load_imgs(imgs_path: str, idxs, composite_bkgd: bool, bkgd_color):
    """Load + premultiply PNG/JPG images."""
    names = sorted(n for n in os.listdir(imgs_path) if n[-4:] in (".png", ".jpg"))
    bkgd = np.asarray(bkgd_color, np.float32)
    imgs, alphas = [], []
    for name in (n for i, n in enumerate(names) if i in idxs):
        img = read_image(os.path.join(imgs_path, name))
        if composite_bkgd:
            imgs.append(img[..., :3] * img[..., 3:] + (1 - img[..., 3:]) * bkgd)
        else:
            imgs.append(img[..., :3] * img[..., 3:])
        alphas.append(img[..., 3])
    h, w = imgs[0].shape[:2]
    return imgs, alphas, h, w


def load_poses(pose_path: str, idxs):
    """Poses + insertion-ordered driver parameters."""
    with open(pose_path) as f:
        pose_dict = json.load(f)

    poses, parameters = [], []
    for frame in (p for i, p in enumerate(pose_dict["frames"]) if i in idxs):
        poses.append(np.asarray(frame["transform_matrix"], np.float32))
        if "driver_parameters" in frame:
            parameters.append(
                np.asarray(list(frame["driver_parameters"].values()), np.float32)
            )
        else:
            parameters.append(np.zeros(0, np.float32))

    return poses, parameters, pose_dict["camera_angle_x"]


def GenerateData(
    height: int = 256,
    width: int = 256,
    angle: float = 0.7,
    pose_dist_config: EasyDict = None,
    radius: Union[float, dict] = 5.0,
    offset: list = (0.0, 0.0, 0.0),
    parameter_dist_config: EasyDict = None,
    dataset_size: int = -1,
    composite_bkgd: bool = False,
    bkgd_color=(1, 1, 1.0),
) -> Tuple[Any, int, int, float, bool, Any]:
    """Synthetic poses/parameters from distributions."""
    if pose_dist_config is None:
        pose_dist_config = EasyDict({"module": "data.dist.Hemisphere"})
    if parameter_dist_config is None:
        parameter_dist_config = EasyDict({"module": "data.distribution.Constant"})

    pose_dist = util.instantiate(pose_dist_config)
    param_dist = util.instantiate(parameter_dist_config)

    if isinstance(radius, dict):
        rad = util.instantiate(radius)
    else:
        rad = lambda: radius  # noqa: E731

    min_dataset_size = max([dataset_size, pose_dist.sampler.n, param_dist.sampler.n])

    offset_arr = np.asarray(offset, np.float32)
    if min_dataset_size <= 256:
        records = []
        for _ in range(min_dataset_size):
            records.append(
                {
                    "pose": look_at(pose_dist() * rad(), offset=offset_arr),
                    "parameters": np.asarray(param_dist(), np.float32),
                }
            )
        source = ListSource(records)
    else:

        def generator():
            while True:
                yield {
                    "pose": look_at(pose_dist() * rad()),
                    "parameters": np.asarray(param_dist(), np.float32),
                }

        source = GeneratorSource(generator, min_dataset_size)

    return source, height, width, width / tan(angle / 2) / 2, composite_bkgd, bkgd_color
