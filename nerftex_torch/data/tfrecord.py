"""Pure-Python TFRecord / tf.Example / TensorProto codec (the port's own
copy of nerftex_tpu/data/tfrecord.py).

Datasets are TFRecords of tf.Example protos with {image: png-or-serialized-
float-tensor bytes, pose: serialized 4x4 tensor, angle: float, parameters:
serialized vector}.  This module reads and writes that exact wire format
with no TensorFlow dependency: the record framing (length + masked crc32c),
the small fixed proto schema, and float32 TensorProtos.
"""

import gzip
import os
import struct
import zlib

import numpy as np

# ---------------------------------------------------------------------------
# crc32c (Castagnoli), table-driven — required by the TFRecord framing.
# ---------------------------------------------------------------------------

_CRC_TABLE = []


def _build_table():
    poly = 0x82F63B78
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        _CRC_TABLE.append(crc)


_build_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) % (1 << 32) + 0xA282EAD8 & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Record framing
# ---------------------------------------------------------------------------


def read_records(path: str, compression_type: str = None, verify_crc: bool = False):
    """Yield raw record payloads from one TFRecord file."""
    if compression_type == "GZIP":
        opener = gzip.open
    else:
        opener = open
    with opener(path, "rb") as f:
        data = f.read()
    if compression_type == "ZLIB":
        data = zlib.decompress(data)

    pos = 0
    n = len(data)
    while pos + 12 <= n:
        (length,) = struct.unpack_from("<Q", data, pos)
        if verify_crc:
            (len_crc,) = struct.unpack_from("<I", data, pos + 8)
            if masked_crc(data[pos : pos + 8]) != len_crc:
                raise ValueError(f"corrupt TFRecord length crc at offset {pos}")
        payload = data[pos + 12 : pos + 12 + length]
        if verify_crc:
            (data_crc,) = struct.unpack_from("<I", data, pos + 12 + length)
            if masked_crc(payload) != data_crc:
                raise ValueError(f"corrupt TFRecord data crc at offset {pos}")
        yield payload
        pos += 12 + length + 4


def write_records(path: str, payloads, compression_type: str = None) -> None:
    chunks = []
    for payload in payloads:
        header = struct.pack("<Q", len(payload))
        chunks.append(header)
        chunks.append(struct.pack("<I", masked_crc(header)))
        chunks.append(payload)
        chunks.append(struct.pack("<I", masked_crc(payload)))
    blob = b"".join(chunks)
    if compression_type == "GZIP":
        with gzip.open(path, "wb") as f:
            f.write(blob)
        return
    if compression_type == "ZLIB":
        blob = zlib.compress(blob)
    with open(path, "wb") as f:
        f.write(blob)


# ---------------------------------------------------------------------------
# Minimal protobuf wire helpers
# ---------------------------------------------------------------------------


def _read_varint(data: bytes, pos: int):
    result = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _write_varint(value: int) -> bytes:
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _iter_fields(data: bytes):
    """Yield (field_number, wire_type, value) triples from a proto message.
    value is bytes for length-delimited, int for varint, raw 4/8 bytes for
    fixed32/64."""
    pos = 0
    n = len(data)
    while pos < n:
        tag, pos = _read_varint(data, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            value, pos = _read_varint(data, pos)
        elif wire == 1:
            value = data[pos : pos + 8]
            pos += 8
        elif wire == 2:
            length, pos = _read_varint(data, pos)
            value = data[pos : pos + length]
            pos += length
        elif wire == 5:
            value = data[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, value


def _field(field: int, wire: int, payload: bytes) -> bytes:
    return _write_varint(field << 3 | wire) + payload


def _len_field(field: int, payload: bytes) -> bytes:
    return _field(field, 2, _write_varint(len(payload)) + payload)


# ---------------------------------------------------------------------------
# tf.Example
# ---------------------------------------------------------------------------


def parse_example(payload: bytes) -> dict:
    """tf.Example bytes -> {name: bytes | np.float32[] | np.int64[]}.

    Schema: Example{1: Features}, Features{1: repeated FeatureEntry},
    FeatureEntry{1: key, 2: Feature}, Feature{1: BytesList, 2: FloatList,
    3: Int64List}, each list {1: repeated values}."""
    out = {}
    for f, _, features in _iter_fields(payload):
        if f != 1:
            continue
        for f2, _, entry in _iter_fields(features):
            if f2 != 1:
                continue
            key = None
            feature = None
            for f3, _, v in _iter_fields(entry):
                if f3 == 1:
                    key = v.decode("utf-8")
                elif f3 == 2:
                    feature = v
            if key is None or feature is None:
                continue
            for f4, _, flist in _iter_fields(feature):
                if f4 == 1:  # bytes_list
                    vals = [v for f5, _, v in _iter_fields(flist) if f5 == 1]
                    out[key] = vals[0] if len(vals) == 1 else vals
                elif f4 == 2:  # float_list (may be packed)
                    vals = []
                    for f5, wire5, v in _iter_fields(flist):
                        if f5 != 1:
                            continue
                        if wire5 == 2:
                            vals.extend(np.frombuffer(v, "<f4"))
                        else:
                            vals.append(struct.unpack("<f", v)[0])
                    out[key] = np.asarray(vals, np.float32)
                elif f4 == 3:  # int64_list
                    vals = []
                    for f5, wire5, v in _iter_fields(flist):
                        if f5 != 1:
                            continue
                        if wire5 == 2:
                            pos = 0
                            while pos < len(v):
                                x, pos = _read_varint(v, pos)
                                vals.append(x)
                        else:
                            vals.append(v)
                    out[key] = np.asarray(vals, np.int64)
    return out


def build_example(features: dict) -> bytes:
    """{name: bytes | float array | int array} -> tf.Example bytes."""
    entries = []
    for key, value in features.items():
        if isinstance(value, bytes):
            feature = _len_field(1, _len_field(1, value))
        elif isinstance(value, (float, np.floating)) or (
            isinstance(value, np.ndarray) and value.dtype.kind == "f"
        ):
            arr = np.atleast_1d(np.asarray(value, np.float32))
            packed = arr.astype("<f4").tobytes()
            feature = _len_field(2, _len_field(1, packed))
        elif isinstance(value, (int, np.integer)) or (
            isinstance(value, np.ndarray) and value.dtype.kind in "iu"
        ):
            arr = np.atleast_1d(np.asarray(value, np.int64))
            packed = b"".join(_write_varint(int(x) & 0xFFFFFFFFFFFFFFFF) for x in arr)
            feature = _len_field(3, _len_field(1, packed))
        else:
            raise TypeError(f"unsupported feature type for {key}: {type(value)}")
        entry = _len_field(1, key.encode("utf-8")) + _len_field(2, feature)
        entries.append(_len_field(1, entry))
    return _len_field(1, b"".join(entries))


# ---------------------------------------------------------------------------
# TensorProto (tf.io.serialize_tensor / parse_tensor), float32 + common types
# ---------------------------------------------------------------------------

_DTYPES = {1: np.float32, 2: np.float64, 3: np.int32, 9: np.int64}
_DTYPE_CODES = {np.dtype(np.float32): 1, np.dtype(np.float64): 2, np.dtype(np.int32): 3, np.dtype(np.int64): 9}


def parse_tensor(payload: bytes) -> np.ndarray:
    dtype = np.float32
    shape = []
    content = b""
    float_vals = []
    for f, wire, v in _iter_fields(payload):
        if f == 1:
            dtype = _DTYPES.get(v, np.float32)
        elif f == 2:  # TensorShapeProto {2: repeated Dim{1: size}}
            for f2, _, dim in _iter_fields(v):
                if f2 != 2:
                    continue
                for f3, _, size in _iter_fields(dim):
                    if f3 == 1:
                        shape.append(size)
        elif f == 4:
            content = v
        elif f == 5 and wire == 2:  # packed float_val fallback
            float_vals.extend(np.frombuffer(v, "<f4"))
    if content:
        arr = np.frombuffer(content, dtype).copy()
    else:
        arr = np.asarray(float_vals, dtype)
    return arr.reshape(shape) if shape else arr


def serialize_tensor(array: np.ndarray) -> bytes:
    array = np.ascontiguousarray(array)
    code = _DTYPE_CODES[array.dtype]
    dims = b"".join(
        _len_field(2, _field(1, 0, _write_varint(int(s)))) for s in array.shape
    )
    out = _field(1, 0, _write_varint(code))
    out += _len_field(2, dims)
    out += _len_field(4, array.tobytes())
    return out


def list_tfrecord_files(tfr_path: str) -> list:
    if os.path.isdir(tfr_path):
        return sorted(
            os.path.join(tfr_path, name) for name in os.listdir(tfr_path)
        )
    if any(c in tfr_path for c in "*?["):
        import glob

        return sorted(glob.glob(tfr_path))
    return [tfr_path]
