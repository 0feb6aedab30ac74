"""Build and load the port's CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C interface, compiled
by ``nvcc`` for ``sm_90a`` into a shared library and loaded with ctypes.
Builds happen at first use (or all at once through ``build``, one nvcc
process per source, started together) into ``nerftex_torch/_build/``, keyed by a hash
of the source and the flags, so an edited source is rebuilt and an
unchanged one is reused.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")

# kernel name -> (source file, extra nvcc flags)
SOURCES = {
    "tex_fetch": ("tex_fetch.cu", []),
    "mlp_fused": ("mlp_fused.cu", []),
    "selk_resolve": ("selk_resolve.cu", []),
    "shadow_query": ("shadow_query.cu", []),
    "per_ray": ("per_ray.cu", []),
}
_BASE_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

_P, _I = ctypes.c_void_p, ctypes.c_int
# kernel name -> (C entry point, its argument types); set once, at load
ENTRIES = {
    "tex_fetch": ("nt_tex_fetch", [_I, _P, _I, _I, _P, _P, ctypes.c_longlong, _P]),
    "mlp_fused": ("nt_mlp_fused", [_I, _P, _P, _I, _I, _P, _P, _P, _I, _P, _I, _P]),
    "selk_resolve": ("nt_selk_resolve", [_P] * 7 + [_I, _I, _I, _I, ctypes.c_float] + [_P] * 4),
    "shadow_query": ("nt_shadow_query", [_P, _P, _I] + [_P] * 4 + [_I] + [_P] * 6 + [_I]
                     + [_P] * 4),
    "per_ray": ("nt_per_ray", [_P, _P, _I, _I, _I, _I, _P, _I] + [_P] * 5 + [_I] + [_P] * 5
                + [_I] + [_P] * 2 + [_I, _I, ctypes.c_float, ctypes.c_float, _P, _I, _I,
                                     ctypes.c_float, _I] + [_P] * 5),
}

_LOADED = {}  # name -> (library, entry point)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                           "with the CUDA toolkit")
    return path


def library_path(name: str) -> str:
    src, flags = SOURCES[name]
    h = hashlib.sha256()
    with open(os.path.join(CSRC, src), "rb") as f:
        h.update(f.read())
    h.update(" ".join(_BASE_FLAGS + flags).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names=None) -> dict:
    """Compile the named kernels (default: all) that are not built yet, one
    nvcc process per source, all started together.  Returns
    {name: seconds} for the ones compiled; raises with nvcc's output on a
    failed build."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not os.path.exists(library_path(n))]
    if not todo:
        return {}
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        src, flags = SOURCES[name]
        tmp = f"{library_path(name)}.{os.getpid()}.tmp"
        cmd = [nvcc, *_BASE_FLAGS, *flags, "-o", tmp, os.path.join(CSRC, src)]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT))
    seconds, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out.decode(errors='replace')}")
            continue
        os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def entry(name: str):
    """The C entry point of kernel ``name`` with its argument types set,
    the library built and loaded first if needed."""
    if name not in _LOADED:
        build([name])
        lib = ctypes.CDLL(library_path(name))
        lib.nt_error_string.argtypes = [ctypes.c_int]
        lib.nt_error_string.restype = ctypes.c_char_p
        fn_name, argtypes = ENTRIES[name]
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _LOADED[name] = (lib, fn)
    return _LOADED[name][1]


def check(name: str, rc: int) -> None:
    """Raise if a launch of kernel ``name`` returned a CUDA error code."""
    if rc != 0:
        msg = _LOADED[name][0].nt_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
