"""The JAX package's side of the port's parity tests, read from a recording.

A parity test holds the port to the JAX package on fixed inputs, seeds and
keys.  Where the JAX side is slow (a whole render, a Train run op by op, a
Pallas kernel in interpret mode, a full-width init), it is computed once by
scripts/record_jax_reference.py and read back here.  A test module with
such cases names them in ``JAX_CASES``: the case (the test id with its
parameters, or the name of the module fixture whose JAX side several tests
share) and the function in the module that computes it, returning a dict of
numpy arrays.  The recorder writes them to tests/jax_reference/<module>.npz
under the keys "<case>/<name>"."""

import hashlib
import os

import numpy as np

DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "jax_reference")
RECORD = "JAX_PLATFORMS=cpu python scripts/record_jax_reference.py"


def path(module: str) -> str:
    return os.path.join(DIR, f"{module}.npz")


def recorded(module: str, case: str) -> dict:
    """The arrays recorded for ``case`` of tests/<module>.py, by name."""
    prefix = f"{case}/"
    if not os.path.exists(path(module)):
        raise LookupError(f"no recording {path(module)}: run `{RECORD}`")
    with np.load(path(module)) as z:
        arrays = {k[len(prefix):]: z[k] for k in z.files if k.startswith(prefix)}
    if not arrays:
        raise LookupError(f"{path(module)} has no case {case!r}: run `{RECORD}`")
    return arrays


def group(arrays: dict, prefix: str) -> dict:
    """The arrays under ``prefix`` ("weights/", ...), the prefix cut off."""
    return {k[len(prefix):]: v for k, v in arrays.items() if k.startswith(prefix)}


def sha256(array) -> str:
    """The SHA-256 of an array's bytes (C order), in hex."""
    return hashlib.sha256(np.ascontiguousarray(array).tobytes()).hexdigest()


def file_bytes(path: str) -> np.ndarray:
    """A file's bytes as a uint8 array (a checkpoint or an image a JAX run
    wrote)."""
    with open(path, "rb") as f:
        return np.frombuffer(f.read(), np.uint8)
