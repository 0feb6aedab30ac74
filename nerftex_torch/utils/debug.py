"""Opt-in numerics checks (counterpart of nerftex_tpu/utils/cache.py
``maybe_enable_debug_checks``, the reference's tf.debugging.check_numerics
calls, renderer.py:140-141).

``NERFTEX_DEBUG_NANS=1`` makes a run raise on its first non-finite value,
as ``jax_debug_nans`` does for the JAX package: autograd's anomaly mode
with NaN checks (a backward pass raises at the op whose gradient went
NaN), a finite check of each training step's loss (``Train``) and of each
rendered frame's outputs (the Logger, for ``Render`` and the validation
renders), and the device-resident step run eagerly (the checks read the
device, which a CUDA graph capture refuses).  Without the variable
nothing changes and no check runs.

The JAX package's other half of utils/cache.py, its persistent compilation
cache, has no counterpart here: kernels/build.py caches the nvcc builds.
"""

import os

import torch

from nerftex_torch.utils import trace

_STATE = {"on": False}


def maybe_enable_debug_checks() -> bool:
    """Turn the checks on when NERFTEX_DEBUG_NANS is set (and off again
    when a later call finds it unset); returns whether they are on."""
    on = bool(os.environ.get("NERFTEX_DEBUG_NANS"))
    if on or _STATE["on"]:
        torch.autograd.set_detect_anomaly(on, check_nan=on)
    _STATE["on"] = on
    return on


def debug_checks_enabled() -> bool:
    return _STATE["on"]


def check_finite(what: str, **tensors) -> None:
    """With the checks on, raise FloatingPointError (jax_debug_nans's
    error) naming the first of ``tensors`` that holds a NaN or an inf."""
    if not _STATE["on"]:
        return
    for name, x in tensors.items():
        with trace.host_read("finite"):
            finite = bool(torch.isfinite(torch.as_tensor(x)).all())
        if not finite:
            raise FloatingPointError(f"NERFTEX_DEBUG_NANS: {what}: {name} is not finite")
