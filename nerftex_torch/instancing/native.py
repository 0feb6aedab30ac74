"""ctypes loader for the repo's native scene-compiler library.

Compiles native/scene_compiler.cpp with the flags of native/Makefile into
nerftex_torch/_build/ at first use, so the closest-point bake and the
batched first-hit casts match the JAX package's native path on the same
machine.  Where no C++ compiler is
available the caller uses the numpy path instead, as the JAX package does.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SOURCE = os.path.join(_ROOT, "native", "scene_compiler.cpp")
_LIB_PATH = os.path.join(_ROOT, "nerftex_torch", "_build", "libscene_compiler.so")
_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-shared"]

_STATE = {}


def get_lib():
    """The loaded library, or None when it cannot be built here."""
    if "lib" in _STATE:
        return _STATE["lib"]
    _STATE["lib"] = None
    cxx = os.environ.get("CXX") or shutil.which("g++")
    fresh = (os.path.exists(_LIB_PATH)
             and os.path.getmtime(_LIB_PATH) >= os.path.getmtime(_SOURCE))
    if not fresh:
        if cxx is None:
            return None
        os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
        tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
        proc = subprocess.run([cxx, *_FLAGS, "-o", tmp, _SOURCE], capture_output=True,
                              timeout=300)
        if proc.returncode != 0:
            return None
        os.replace(tmp, _LIB_PATH)
    lib = ctypes.CDLL(_LIB_PATH)
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.nt_closest_points.argtypes = [
        f32p, ctypes.c_int64, f32p, f32p, f32p, ctypes.c_int64, i32p, f32p, f32p,
    ]
    lib.nt_closest_points.restype = None
    lib.nt_ray_mesh_first_hit.argtypes = [
        f32p, f32p, ctypes.c_int64, f32p, f32p, f32p, ctypes.c_int64,
        ctypes.c_float, f32p, i32p, f32p, f32p,
    ]
    lib.nt_ray_mesh_first_hit.restype = None
    _STATE["lib"] = lib
    return lib


def closest_points(queries, tri_a, tri_b, tri_c):
    """(tri_idx [N], bary [N,3], dist [N]) of the closest triangle to each
    query point, or None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    queries = np.ascontiguousarray(queries, np.float32)
    tri_a = np.ascontiguousarray(tri_a, np.float32)
    tri_b = np.ascontiguousarray(tri_b, np.float32)
    tri_c = np.ascontiguousarray(tri_c, np.float32)
    n, t = len(queries), len(tri_a)
    out_tri = np.empty(n, np.int32)
    out_bary = np.empty((n, 3), np.float32)
    out_dist = np.empty(n, np.float32)
    lib.nt_closest_points(queries, n, tri_a, tri_b, tri_c, t, out_tri, out_bary, out_dist)
    return out_tri, out_bary, out_dist


def ray_mesh_first_hit(rays_o, rays_d, v0, e1, e2, t_max=100.0):
    """Batched Moller-Trumbore first-hit casts -> (t [N] (inf = miss),
    tri [N], u [N], v [N]), or None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    rays_o = np.ascontiguousarray(rays_o, np.float32)
    rays_d = np.ascontiguousarray(rays_d, np.float32)
    v0 = np.ascontiguousarray(v0, np.float32)
    e1 = np.ascontiguousarray(e1, np.float32)
    e2 = np.ascontiguousarray(e2, np.float32)
    n, t = len(rays_o), len(v0)
    out_t = np.empty(n, np.float32)
    out_tri = np.empty(n, np.int32)
    out_u = np.empty(n, np.float32)
    out_v = np.empty(n, np.float32)
    lib.nt_ray_mesh_first_hit(rays_o, rays_d, n, v0, e1, e2, t, t_max, out_t, out_tri, out_u,
                              out_v)
    return out_t, out_tri, out_u, out_v
