"""Process-wide random streams (counterpart of nerftex_tpu/utils/rng.py).

Host code draws from the global numpy seed (the data distributions); device
randomness flows through JAX-compatible keys (utils.jax_rng) derived from
one base seed: key = fold_in(fold_in(key(base), stream_id), step), so a
stream's draws are the JAX package's for the same seed and step.
"""

import numpy as np

from nerftex_torch.utils import jax_rng

_BASE_SEED = 0

# Stable stream ids, as the JAX package numbers them.
STREAM_PERTURB = 1       # stratified-sample jitter
STREAM_NOISE = 2         # raw_noise_std density noise
STREAM_IMPORTANCE = 3    # sample_pdf's uniform draws
STREAM_INSTANCER = 4     # instancer sample offsets + overlap selection
STREAM_FALSE_COLOR = 5   # per-instance debug colors
STREAM_DATA = 6          # device-side data augmentation


def set_seed(seed: "int | None") -> None:
    """Set the global seed (numpy for host code, base key for device code)."""
    global _BASE_SEED
    if seed is None:
        return
    _BASE_SEED = int(seed)
    np.random.seed(seed)


def base_key():
    return jax_rng.key(_BASE_SEED)


def stream_key(stream_id: int, step: int = 0):
    """Per-stream, per-step key; independent across streams and steps."""
    return jax_rng.fold_in(jax_rng.fold_in(base_key(), stream_id), step)
