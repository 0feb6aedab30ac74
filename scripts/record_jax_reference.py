"""Record the JAX package's side of the port's parity tests.

Each module below names its recorded cases in ``JAX_CASES`` (see
tests/_jax_reference.py): the case and the function of the test module that
runs the JAX side of it, with the test's config, inputs, seeds and keys.
This script runs every case and writes tests/jax_reference/<module>.npz,
one key prefix "<case>/" per case.  The tests read those files and never
run this script.

Re-record when a recorded case's JAX-side computation or inputs change; a
new parity test whose JAX side is slow adds its case to its module's
JAX_CASES (and its module here) in the same change.

``--check`` recomputes every case and compares it bit for bit with the
files: it names each case that differs or is missing and exits 1.

Run from the repo root (JAX on the CPU, as tests/conftest.py sets it up):
    JAX_PLATFORMS=cpu python scripts/record_jax_reference.py [--check] [module ...]
"""

import argparse
import importlib
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(ROOT, "tests")
MODULES = (
    "test_torch_compact",
    "test_torch_device_train",
    "test_torch_grass",
    "test_torch_instancer",
    "test_torch_main",
    "test_torch_mip",
    "test_torch_models",
    "test_torch_parallel",
    "test_torch_plush",
    "test_torch_render",
    "test_torch_selk",
    "test_torch_serve",
    "test_torch_shadows",
    "test_torch_train",
)


def _jax_on_the_cpu():
    """tests/conftest.py's JAX: the CPU platform with 8 virtual devices."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")


def record(module: str) -> dict:
    """Every case of ``module``: {"<case>/<name>": array}."""
    mod = importlib.import_module(module)
    arrays = {}
    for case, compute in mod.JAX_CASES.items():
        start = time.perf_counter()
        out = compute()
        for name, value in out.items():
            arrays[f"{case}/{name}"] = np.asarray(value)
        print(f"{module}::{case}  {time.perf_counter() - start:.1f} s", flush=True)
    return arrays


def differences(arrays: dict, path: str) -> list:
    """The cases whose arrays differ from the file's in name, dtype, shape
    or any bit."""
    with np.load(path) as z:
        saved = {k: z[k] for k in z.files}
    bad = set()
    for key in set(arrays) | set(saved):
        got, want = arrays.get(key), saved.get(key)
        if (got is None or want is None or got.dtype != want.dtype or got.shape != want.shape
                or got.tobytes() != want.tobytes()):
            bad.add(key.split("/", 1)[0])
    return sorted(bad)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--check", action="store_true",
                        help="recompute and compare with the files; write nothing")
    parser.add_argument("modules", nargs="*", default=list(MODULES),
                        help="test modules to record (default: all)")
    args = parser.parse_args(argv)
    _jax_on_the_cpu()
    sys.path[:0] = [ROOT, TESTS]
    from _jax_reference import DIR, path

    failed = []
    for module in args.modules:
        arrays = record(module)
        if args.check:
            if not os.path.exists(path(module)):
                failed.append(f"{module}: no recording")
                continue
            failed += [f"{module}::{case}" for case in differences(arrays, path(module))]
        else:
            os.makedirs(DIR, exist_ok=True)
            np.savez_compressed(path(module), **arrays)
            print(f"wrote {os.path.relpath(path(module), ROOT)}  "
                  f"{os.path.getsize(path(module))} bytes", flush=True)
    for name in failed:
        print(f"DIFFERS  {name}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
