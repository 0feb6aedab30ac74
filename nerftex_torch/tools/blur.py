"""Create prefiltered dataset copies: gaussian-blur each image with a random
sigma and prepend 'Blur' to the driver parameters (the port's own copy of
nerftex_tpu/tools/blur.py: the same sigmas, images and json for the same
input).

Mirror of reference data/blur.py: sigma sampled from a truncated-exponential
inverse CDF (blur.py:46-56), blurring is premultiplied-alpha and gamma aware
(blur.py:71-73; decode gamma 2.2 -> premultiply -> blur -> unpremultiply ->
re-encode), and the output transforms json carries 'Blur' as the FIRST driver
parameter (blur.py:114-116 — which is why grass_filtered configs use
blur_idx=0 and n_parameters=[2,3]).  scipy replaces skimage.

    python -m nerftex_torch.tools.blur <folder> <out folder> --max_sigma 4
        [--subsets train val] [--dataset_size_increase N] [--p 3]
"""

import argparse
import json
import math
import os

import numpy as np
from scipy.ndimage import gaussian_filter

from nerftex_torch.utils.image import encode_png, read_image


def inv_cdf(x, p):
    """Truncated-exponential inverse CDF over [0,1] (blur.py:46-51)."""
    if -1e-4 < p < 1e-4:
        return x
    return -np.log(1 - x * (1 - np.exp(-p))) / p


def blur_png(img: np.ndarray, sigma: float) -> np.ndarray:
    """Gamma/alpha-aware gaussian blur of an RGBA float image."""
    out = img.copy()
    out[:, :, :3] = out[:, :, :3] ** 2.2 * out[:, :, 3:]
    if sigma > 0:
        for c in range(out.shape[-1]):
            out[:, :, c] = gaussian_filter(out[:, :, c], sigma=sigma, mode="constant")
    out[:, :, :3] = (out[:, :, :3] / (out[:, :, 3:] + 1e-5)) ** (1 / 2.2)
    return np.clip(out, 0, 1)


def process(path_in, path_out, subsets=("train",), max_sigma=0.0, dataset_size_increase=1, p=3.0):
    """Blur every image of each subset of ``path_in`` (dataset_size_increase
    copies each, sigma drawn from inv_cdf(U, p) * max_sigma under numpy's
    global seed 0) into the new folder ``path_out``, with the sigma as the
    first driver parameter 'Blur' of each frame."""
    os.makedirs(path_out)

    for subset in subsets:
        imgs_path = os.path.join(path_in, subset)
        img_names = sorted(os.listdir(imgs_path))
        n_imgs = len(img_names)
        n_imgs_out = n_imgs * dataset_size_increase

        with open(os.path.join(path_in, f"transforms_{subset}.json")) as f:
            pose_dict = json.load(f)

        out_subset = os.path.join(path_out, subset)
        os.makedirs(out_subset)

        np.random.seed(0)
        sigma = (inv_cdf(np.random.rand(n_imgs_out), p) * max_sigma).tolist()

        min_chars = max(1, math.ceil(np.log10(max(n_imgs_out, 2))))
        fmt = "{:0" + str(min_chars) + "d}"

        names = img_names * dataset_size_increase
        for idx, (name, s) in enumerate(zip(names, sigma)):
            ext = os.path.splitext(name)[-1]
            prefix = name.split("_")[0]
            if ext == ".png":
                img = read_image(os.path.join(imgs_path, name))
                out = blur_png(img, s)
                out_name = prefix + "_" + fmt.format(idx) + ".png"
                with open(os.path.join(out_subset, out_name), "wb") as f:
                    f.write(encode_png(out))
            elif ext == ".exr":
                # Linear premultiplied HDR: plain gaussian blur, no gamma /
                # alpha games (reference blur.py:80-93 uses
                # filtered_downsample with factor 1).
                from nerftex_torch.utils.exr import read_exr, write_exr

                img = read_exr(os.path.join(imgs_path, name))
                out = img.copy()
                if s > 0:
                    for c in range(out.shape[-1]):
                        out[:, :, c] = gaussian_filter(out[:, :, c], sigma=s, mode="constant")
                write_exr(os.path.join(out_subset, prefix + "_" + fmt.format(idx) + ".exr"), out)
            else:
                raise ValueError(f"unsupported filetype {ext}")

        frames_out = []
        for i in range(n_imgs_out):
            frame = dict(pose_dict["frames"][i % n_imgs])
            img_path = frame["file_path"].split("_")[0]
            frame["file_path"] = img_path + "_" + fmt.format(i)
            updated = {"Blur": sigma[i]}
            updated.update(frame.get("driver_parameters", {}))
            frame["driver_parameters"] = updated
            frames_out.append(frame)

        with open(os.path.join(path_out, f"transforms_{subset}.json"), "w") as f:
            json.dump(
                {"camera_angle_x": pose_dict["camera_angle_x"], "frames": frames_out},
                f,
                sort_keys=False,
                indent=4,
            )


def main():
    ap = argparse.ArgumentParser(
        description="Blur dataset images with random sigma; record it as the first driver parameter."
    )
    ap.add_argument("path_in")
    ap.add_argument("path_out")
    ap.add_argument("--subsets", nargs="+", default=["train"])
    ap.add_argument("--max_sigma", type=float, default=0)
    ap.add_argument("--dataset_size_increase", type=int, default=1)
    ap.add_argument("--p", type=float, default=3)
    args = ap.parse_args()
    process(args.path_in, args.path_out, args.subsets, args.max_sigma, args.dataset_size_increase, args.p)


if __name__ == "__main__":
    main()
