"""Image IO: PNG through PIL, EXR through the port's codec (utils/exr.py).

The port's own copy of nerftex_tpu/utils/image.py: the same decoding
(float32 RGBA in [0, 1]) and the same u8 rounding on encode, so the two
packages write the same PNG bytes for the same image."""

import io

import numpy as np

from nerftex_torch.utils import exr


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> float32 [H,W,4] RGBA in [0,1] (alpha=1 where absent)."""
    from PIL import Image

    img = Image.open(io.BytesIO(data)).convert("RGBA")
    return np.asarray(img, np.float32) / 255.0


def decode_png_u8(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 [H,W,4] RGBA, the pre-normalization half of
    decode_png."""
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"), np.uint8)


def encode_png(img: np.ndarray) -> bytes:
    """float32 [H,W,C] in [0,1] -> PNG bytes."""
    from PIL import Image

    arr = np.clip(np.asarray(img) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    mode = {1: "L", 3: "RGB", 4: "RGBA"}[arr.shape[-1]]
    if arr.shape[-1] == 1:
        arr = arr[..., 0]
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, format="PNG")
    return buf.getvalue()


def read_image(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def write_image(path: str, img: np.ndarray) -> None:
    if path.endswith(".exr"):
        write_exr(path, img)
        return
    with open(path, "wb") as f:
        f.write(encode_png(img))


def write_exr(path: str, img: np.ndarray) -> None:
    """HDR output as an uncompressed OpenEXR file (utils/exr.py)."""
    exr.write_exr(path, img)


def read_exr(path: str) -> np.ndarray:
    return exr.read_exr(path)
