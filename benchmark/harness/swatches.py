"""The training cell's swatch set, made from the run's seed.

``n`` views of a procedural carpet swatch at ``size`` x ``size``: a camera
on the upper hemisphere at ``radius`` looking at the origin, the
material's parameters uniform in [0, 1) with the last three a downward
light direction (the carpet set's ranges); the image is a fibre layer over
[-1, 1]^2 of height 0.2 + 0.6 * parameters[0], its alpha the absorption
along each pixel's ray through the layer and its color a stripe pattern
lit by the light.  The images are drawn on the device in one pass per
view, encoded as PNG on the host and written as one TFRecord of
tf.Examples {"image": PNG, "pose": tensor [4, 4], "angle": float,
"parameters": tensor [P]} with the record framing's CRC-32C.  Every run
writes its set anew (into a temporary directory that the run removes), so
that every run of the cell pays the same set-up whether or not an earlier
run had the same seed.

The encoder (tf.Example, TensorProto, the record framing) is the
benchmark's own on purpose, like the rest of the traffic: the program's
nerftex_torch/data/tfrecord.py writes the same format, but a change to it
must not change what the cell is fed.  The CRC is computed for all records
together, eight bytes a step; one byte at a time in Python, as the
program's writer does it, a 512-view set would take minutes of set-up.
"""

import io
import os
import struct
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from benchmark.reference.render import look_at

_POLY = 0x82F63B78


def _tables():
    """The eight slicing tables of the reflected CRC-32C."""
    t0 = np.zeros(256, np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ _POLY if c & 1 else c >> 1
        t0[i] = c
    tables = [t0]
    for _ in range(7):
        prev = tables[-1]
        tables.append((prev >> np.uint32(8)) ^ t0[prev & 0xFF])
    return tables


def crc32c_many(payloads):
    """The CRC-32C of each payload, all computed together: eight bytes a
    step (slicing by eight), then the last bytes one at a time."""
    t = _tables()
    n = len(payloads)
    lens = np.array([len(p) for p in payloads])
    width = -(-int(lens.max()) // 8) * 8
    buf = np.zeros((n, width), np.uint8)
    for i, p in enumerate(payloads):
        buf[i, :len(p)] = np.frombuffer(p, np.uint8)
    words = buf.view("<u4")
    crc = np.full(n, 0xFFFFFFFF, np.uint32)
    full = lens // 8
    s8, s16, s24 = np.uint32(8), np.uint32(16), np.uint32(24)
    for j in range(int(full.max())):
        c = crc ^ words[:, 2 * j]
        hi = words[:, 2 * j + 1]
        nxt = (t[7][c & 0xFF] ^ t[6][(c >> s8) & 0xFF] ^ t[5][(c >> s16) & 0xFF]
               ^ t[4][c >> s24] ^ t[3][hi & 0xFF] ^ t[2][(hi >> s8) & 0xFF]
               ^ t[1][(hi >> s16) & 0xFF] ^ t[0][hi >> s24])
        crc = np.where(full > j, nxt, crc)
    rows = np.arange(n)
    for k in range(8):
        pos = full * 8 + k
        byte = buf[rows, np.minimum(pos, width - 1)]
        nxt = t[0][(crc ^ byte) & 0xFF] ^ (crc >> s8)
        crc = np.where(pos < lens, nxt, crc)
    return [int(c) ^ 0xFFFFFFFF for c in crc]


def _masked(crc):
    return ((crc >> 15) | (crc << 17)) % (1 << 32) + 0xA282EAD8 & 0xFFFFFFFF


def _varint(v):
    out = bytearray()
    while True:
        b, v = v & 0x7F, v >> 7
        out.append(b | 0x80 if v else b)
        if not v:
            return bytes(out)


def _len_field(field, payload):
    return _varint(field << 3 | 2) + _varint(len(payload)) + payload


def _tensor(arr):
    arr = np.ascontiguousarray(arr, np.float32)
    dims = b"".join(_len_field(2, _varint(1 << 3) + _varint(int(s))) for s in arr.shape)
    return _varint(1 << 3) + _varint(1) + _len_field(2, dims) + _len_field(4, arr.tobytes())


def example(features: dict) -> bytes:
    """A tf.Example of bytes and float features."""
    entries = []
    for key, value in features.items():
        if isinstance(value, bytes):
            feature = _len_field(1, _len_field(1, value))
        else:
            feature = _len_field(2, _len_field(1, np.float32(value).tobytes()))
        entries.append(_len_field(1, _len_field(1, key.encode()) + _len_field(2, feature)))
    return _len_field(1, b"".join(entries))


def views(n, n_parameters, radius, seed):
    """[(pose [4, 4] float32, parameters [P] float32)] of the set."""
    rng = np.random.default_rng([int(seed), 3])

    def hemisphere():
        z = rng.random()
        az = 2 * np.pi * rng.random()
        ring = np.sqrt(1 - z * z)
        return np.array([np.cos(az) * ring, np.sin(az) * ring, z])

    out = []
    for _ in range(n):
        pose = look_at(hemisphere() * radius)
        params = rng.random(sum(n_parameters)).astype(np.float32)
        params[-3:] = -hemisphere()
        out.append((pose, params))
    return out


def draw(pose, params, size, angle, device):
    """The view's straight-alpha RGBA as uint8 [size, size, 4]."""
    focal = size / np.tan(angle / 2) / 2
    idx = torch.arange(size * size, device=device)
    row, col = (idx // size).double(), (idx % size).double()
    dirs = torch.stack([(col + 0.5 - 0.5 * size) / focal, -(row + 0.5 - 0.5 * size) / focal,
                        -torch.ones_like(row)], -1)
    m = torch.as_tensor(pose, dtype=torch.float64, device=device)
    d = dirs @ m[:3, :3].T
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    o = m[:3, 3].expand_as(d)
    top = 0.2 + 0.6 * float(params[0])
    lo = torch.tensor([-1.0, -1.0, 0.0], dtype=torch.float64, device=device)
    hi = torch.tensor([1.0, 1.0, top], dtype=torch.float64, device=device)
    inv = 1.0 / d
    ta, tb = (lo - o) * inv, (hi - o) * inv
    t0 = torch.minimum(ta, tb).amax(-1).clamp(min=0)
    t1 = torch.maximum(ta, tb).amin(-1)
    length = (t1 - t0).clamp(min=0)
    alpha = 1 - torch.exp(-4.0 * length)
    p = o + d * ((t0 + t1) / 2)[:, None]
    light = torch.as_tensor(params[-3:], dtype=torch.float64, device=device)
    shade = 0.4 + 0.6 * (-light[2]).clamp(0, 1)
    stripe = 0.5 + 0.5 * torch.sin(12 * p[:, 0] + 7 * p[:, 1] * float(params[1]))
    rgb = torch.stack([stripe * float(params[2]), 0.5 * stripe + 0.3 * float(params[3]),
                       1 - stripe * float(params[4])], -1).clamp(0, 1) * shade
    img = torch.cat([rgb, alpha[:, None]], -1).reshape(size, size, 4)
    return (img * 255 + 0.5).clamp(0, 255).to(torch.uint8).cpu().numpy()


def png(img):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img, "RGBA").save(buf, format="PNG", compress_level=1)
    return buf.getvalue()


def swatch_set(spec: dict, seed: int, directory: str, device) -> str:
    """Write the seed's set as ``train.tfr`` in ``directory``; its path."""
    path = os.path.join(directory, "train.tfr")
    vs = views(spec["views"], spec["n_parameters"], spec["radius"], seed)
    images = [draw(pose, params, spec["size"], spec["angle"], device) for pose, params in vs]
    # The encoder releases the interpreter lock: one thread per core.
    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        pngs = list(pool.map(png, images))
    payloads = [example({"image": data, "pose": _tensor(pose), "angle": float(spec["angle"]),
                         "parameters": _tensor(params)})
                for data, (pose, params) in zip(pngs, vs)]
    headers = [struct.pack("<Q", len(p)) for p in payloads]
    crcs = crc32c_many(headers + payloads)
    n = len(payloads)
    with open(path, "wb") as f:
        for i, p in enumerate(payloads):
            f.write(headers[i] + struct.pack("<I", _masked(crcs[i])) + p
                    + struct.pack("<I", _masked(crcs[n + i])))
    return path
