"""Pack a NeRF-Blender style folder dataset into sharded TFRecords (the
port's own copy of nerftex_tpu/tools/nerf2tfr.py: the same records, byte
for byte).

Mirror of reference data/nerf2tfr.py:42-113: each example holds
{image: png bytes | serialized float32 tensor (exr), pose: serialized 4x4,
angle: float, parameters: serialized driver-parameter vector}.  Pure Python
(nerftex_torch.data.tfrecord), no TensorFlow needed.

    python -m nerftex_torch.tools.nerf2tfr <folder> <out.tfr> [--subset train]
        [--imgs_per_shard N] [--skip_params] [--compression_type GZIP|ZLIB]
"""

import argparse
import json
import os

import numpy as np

from nerftex_torch.data import tfrecord as tfr


def convert(
    in_path: str,
    out_path: str,
    subset: str = "train",
    skip_params: bool = False,
    imgs_per_shard: int = 0,
    compression_type: str = None,
) -> list:
    """Write the frames of <in_path>/transforms_<subset>.json as records
    to ``out_path`` (or to shards <base>-SSSSS-of-NNNNN<ext> of
    ``imgs_per_shard`` records); returns the paths written."""
    transforms_path = os.path.join(in_path, f"transforms_{subset}.json")
    with open(transforms_path) as f:
        meta = json.load(f)

    angle = float(meta["camera_angle_x"])
    frames = meta["frames"]

    payloads = []
    for frame in frames:
        file_path = frame["file_path"]
        img_path = os.path.join(in_path, file_path)
        candidates = [img_path, img_path + ".png", img_path + ".exr"]
        img_file = next((p for p in candidates if os.path.isfile(p)), None)
        if img_file is None:
            raise FileNotFoundError(f"no image for frame {file_path}")

        if img_file.endswith(".exr"):
            from nerftex_torch.utils.exr import read_exr

            arr = np.asarray(read_exr(img_file), np.float32)
            image_feature = tfr.serialize_tensor(arr)
        else:
            with open(img_file, "rb") as f:
                image_feature = f.read()

        pose = np.asarray(frame["transform_matrix"], np.float32)
        if skip_params or "driver_parameters" not in frame:
            params = np.zeros(0, np.float32)
        else:
            params = np.asarray(list(frame["driver_parameters"].values()), np.float32)

        payloads.append(
            tfr.build_example(
                {
                    "image": image_feature,
                    "pose": tfr.serialize_tensor(pose),
                    "angle": angle,
                    "parameters": tfr.serialize_tensor(params),
                }
            )
        )

    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    written = []
    if imgs_per_shard and imgs_per_shard > 0:
        n_shards = -(-len(payloads) // imgs_per_shard)
        base, ext = os.path.splitext(out_path)
        for s in range(n_shards):
            shard_path = f"{base}-{s:05d}-of-{n_shards:05d}{ext}"
            tfr.write_records(
                shard_path,
                payloads[s * imgs_per_shard : (s + 1) * imgs_per_shard],
                compression_type,
            )
            written.append(shard_path)
    else:
        tfr.write_records(out_path, payloads, compression_type)
        written.append(out_path)
    return written


def main():
    ap = argparse.ArgumentParser(description="NeRF folder dataset -> TFRecord shards.")
    ap.add_argument("in_path")
    ap.add_argument("out_path")
    ap.add_argument("--subset", default="train")
    ap.add_argument("--skip_params", action="store_true")
    ap.add_argument("--imgs_per_shard", type=int, default=0)
    ap.add_argument("--compression_type", default=None, choices=[None, "GZIP", "ZLIB"])
    args = ap.parse_args()
    for path in convert(
        args.in_path, args.out_path, args.subset, args.skip_params,
        args.imgs_per_shard, args.compression_type,
    ):
        print(path)


if __name__ == "__main__":
    main()
