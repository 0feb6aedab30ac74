"""Minimal PLY mesh IO (ascii + binary_little_endian).

A frozen copy of nerftex_torch/instancing/ply.py, kept with the benchmark
so that the reference reads the scene's meshes without the program:
``read_ply`` reads vertex positions, optional normals (nx, ny, nz),
optional UVs (s,t or u,v or texture_u/texture_v) and triangle faces,
polygons fan-triangulated.
"""

import numpy as np

_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}

_UV_NAMES = (("s", "t"), ("u", "v"), ("texture_u", "texture_v"))


class PlyData:
    def __init__(self, V, F=None, N=None, UV=None):
        self.V = np.asarray(V, np.float32).reshape(-1, 3)
        self.F = np.asarray(F, np.int32).reshape(-1, 3) if F is not None and len(F) else np.zeros((0, 3), np.int32)
        self.N = np.asarray(N, np.float32).reshape(-1, 3) if N is not None else None
        self.UV = np.asarray(UV, np.float32).reshape(-1, 2) if UV is not None else None


def read_ply(path: str) -> PlyData:
    with open(path, "rb") as f:
        data = f.read()

    header_end = data.find(b"end_header\n")
    if header_end < 0:
        raise ValueError(f"{path}: not a PLY file (no end_header)")
    header = data[:header_end].decode("ascii", "replace").splitlines()
    body = data[header_end + len(b"end_header\n"):]

    if not header or header[0].strip() != "ply":
        raise ValueError(f"{path}: missing ply magic")

    fmt = None
    elements = []  # (name, count, [(prop_name, dtype)|('list', count_t, item_t, name)])
    for line in header[1:]:
        parts = line.strip().split()
        if not parts or parts[0] == "comment":
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append([parts[1], int(parts[2]), []])
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append(("list", _TYPES[parts[2]], _TYPES[parts[3]], parts[4]))
            else:
                elements[-1][2].append((parts[2], _TYPES[parts[1]]))

    if fmt not in ("ascii", "binary_little_endian"):
        raise ValueError(f"{path}: unsupported format {fmt}")

    parsed = {}
    if fmt == "ascii":
        tokens = body.decode("ascii").split()
        pos = 0
        for name, count, props in elements:
            scalars = {p[0]: [] for p in props if p[0] != "list"}
            lists = {p[3]: [] for p in props if p[0] == "list"}
            for _ in range(count):
                for p in props:
                    if p[0] == "list":
                        n = int(tokens[pos]); pos += 1
                        lists[p[3]].append([float(tokens[pos + k]) for k in range(n)])
                        pos += n
                    else:
                        scalars[p[0]].append(float(tokens[pos])); pos += 1
            parsed[name] = (scalars, lists)
    else:
        offset = 0
        for name, count, props in elements:
            has_list = any(p[0] == "list" for p in props)
            if not has_list:
                dt = np.dtype([(p[0], "<" + p[1]) for p in props])
                arr = np.frombuffer(body, dt, count, offset)
                offset += dt.itemsize * count
                parsed[name] = ({p[0]: arr[p[0]] for p in props}, {})
            else:
                scalars = {p[0]: [] for p in props if p[0] != "list"}
                lists = {p[3]: [] for p in props if p[0] == "list"}
                for _ in range(count):
                    for p in props:
                        if p[0] == "list":
                            cnt_dt = np.dtype("<" + p[1])
                            n = int(np.frombuffer(body, cnt_dt, 1, offset)[0])
                            offset += cnt_dt.itemsize
                            item_dt = np.dtype("<" + p[2])
                            vals = np.frombuffer(body, item_dt, n, offset)
                            offset += item_dt.itemsize * n
                            lists[p[3]].append(vals.tolist())
                        else:
                            dt = np.dtype("<" + p[1])
                            scalars[p[0]].append(float(np.frombuffer(body, dt, 1, offset)[0]))
                            offset += dt.itemsize
                parsed[name] = (scalars, lists)

    vscalars, _ = parsed.get("vertex", ({}, {}))
    V = np.stack([np.asarray(vscalars[c], np.float32) for c in "xyz"], -1)
    N = None
    if all(c in vscalars for c in ("nx", "ny", "nz")):
        N = np.stack([np.asarray(vscalars[c], np.float32) for c in ("nx", "ny", "nz")], -1)
    UV = None
    for u_name, v_name in _UV_NAMES:
        if u_name in vscalars and v_name in vscalars:
            UV = np.stack(
                [np.asarray(vscalars[u_name], np.float32), np.asarray(vscalars[v_name], np.float32)], -1
            )
            break

    F = []
    if "face" in parsed:
        _, flists = parsed["face"]
        for key in ("vertex_indices", "vertex_index"):
            if key in flists:
                for poly in flists[key]:
                    for k in range(1, len(poly) - 1):  # fan triangulation
                        F.append([poly[0], poly[k], poly[k + 1]])
                break

    return PlyData(V, np.asarray(F, np.int32) if F else None, N, UV)
