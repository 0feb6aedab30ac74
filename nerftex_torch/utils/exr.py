"""Minimal OpenEXR 2.0 codec: uncompressed scanline float images (the
port's own copy of nerftex_tpu/utils/exr.py, numpy only).

Writes single-part scanline files with NO_COMPRESSION and FLOAT channels —
readable by any standard OpenEXR implementation — and reads back the same
subset (FLOAT or HALF channels, uncompressed).  The eval Logger's
``write_exr`` and the TFRecord loader's EXR images use it.

Format reference: OpenEXR file layout (openexr.com/en/latest/OpenEXRFileLayout.html).
"""

import struct

import numpy as np

_MAGIC = 20000630
_PT_UINT, _PT_HALF, _PT_FLOAT = 0, 1, 2
_PT_DTYPE = {_PT_HALF: np.dtype("<f2"), _PT_FLOAT: np.dtype("<f4")}

# Channel naming per OpenEXR convention; chlist must be sorted by name.
_CHANNEL_NAMES = {1: ["Y"], 3: ["R", "G", "B"], 4: ["R", "G", "B", "A"]}


def _attr(name: str, typ: str, value: bytes) -> bytes:
    return name.encode() + b"\0" + typ.encode() + b"\0" + struct.pack("<i", len(value)) + value


def write_exr(path: str, img: np.ndarray) -> None:
    """float [H,W] or [H,W,C] (C in {1,3,4}) -> uncompressed FLOAT EXR."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    names = _CHANNEL_NAMES.get(c)
    if names is None:
        raise ValueError(f"unsupported channel count {c}")

    order = sorted(range(c), key=lambda i: names[i])  # chlist is name-sorted
    chlist = b""
    for i in order:
        chlist += names[i].encode() + b"\0"
        chlist += struct.pack("<iBBBBii", _PT_FLOAT, 0, 0, 0, 0, 1, 1)
    chlist += b"\0"

    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header = (
        _attr("channels", "chlist", chlist)
        + _attr("compression", "compression", b"\0")  # NO_COMPRESSION
        + _attr("dataWindow", "box2i", box)
        + _attr("displayWindow", "box2i", box)
        + _attr("lineOrder", "lineOrder", b"\0")  # increasing Y
        + _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
        + _attr("screenWindowCenter", "v2f", struct.pack("<2f", 0.0, 0.0))
        + _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
        + b"\0"
    )

    preamble = struct.pack("<ii", _MAGIC, 2) + header
    table_pos = len(preamble)
    row_bytes = 8 + c * w * 4  # y + size prefix + channel rows
    first_block = table_pos + 8 * h
    offsets = struct.pack("<%dQ" % h, *(first_block + y * row_bytes for y in range(h)))

    rows = np.ascontiguousarray(img[:, :, order].transpose(0, 2, 1), dtype="<f4")
    with open(path, "wb") as f:
        f.write(preamble)
        f.write(offsets)
        size = struct.pack("<i", c * w * 4)
        for y in range(h):
            f.write(struct.pack("<i", y) + size + rows[y].tobytes())


def _read_null_str(buf: bytes, pos: int):
    end = buf.index(b"\0", pos)
    return buf[pos:end].decode(), end + 1


def read_exr(path: str) -> np.ndarray:
    """Uncompressed scanline EXR (FLOAT/HALF) -> float32 [H,W,C], channels
    reordered to R,G,B,A / Y where those names are present."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    if version & 0x200 or version & 0x1000:  # tiled / multi-part
        raise ValueError(f"{path}: only single-part scanline EXR supported")

    pos = 8
    channels, compression, data_window = None, None, None
    while True:
        if buf[pos] == 0:  # header terminator
            pos += 1
            break
        name, pos = _read_null_str(buf, pos)
        typ, pos = _read_null_str(buf, pos)
        (size,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        val = buf[pos : pos + size]
        pos += size
        if name == "channels":
            channels = []
            p = 0
            while val[p] != 0:
                cname, p = _read_null_str(val, p)
                ptype, _, _, _, _, xs, ys = struct.unpack_from("<iBBBBii", val, p)
                p += 16
                if xs != 1 or ys != 1:
                    raise ValueError(f"{path}: subsampled channels unsupported")
                channels.append((cname, ptype))
        elif name == "compression":
            compression = val[0]
        elif name == "dataWindow":
            data_window = struct.unpack("<4i", val)

    if compression != 0:
        raise ValueError(f"{path}: only NO_COMPRESSION EXR supported (got {compression})")
    x0, y0, x1, y1 = data_window
    w, h = x1 - x0 + 1, y1 - y0 + 1

    pos += 8 * h  # skip the scanline offset table (blocks follow in order)
    out = np.empty((h, w, len(channels)), np.float32)
    for row in range(h):
        _, size = struct.unpack_from("<ii", buf, pos)
        pos += 8
        p = pos
        for ci, (_, ptype) in enumerate(channels):
            dt = _PT_DTYPE.get(ptype)
            if dt is None:
                raise ValueError(f"{path}: UINT channels unsupported")
            out[row, :, ci] = np.frombuffer(buf, dt, w, p).astype(np.float32)
            p += w * dt.itemsize
        pos += size

    names = [c[0] for c in channels]
    want = next(
        (o for o in (["R", "G", "B", "A"], ["R", "G", "B"], ["Y"]) if set(o) == set(names)),
        None,
    )
    if want is not None:
        out = out[:, :, [names.index(n) for n in want]]
    return out
