"""JAX's default random streams, bit for bit, in PyTorch.

A frozen copy of the draws of nerftex_torch/utils/jax_rng.py that the
reference needs: it derives the program's draws (the marching offsets of
each frame, the training step's jitter) from the same keys without
importing the program.  The generator is threefry2x32 with
``jax_threefry_partitionable`` on, a counter-based hash:

  key(seed)           key data [seed >> 32, seed & 0xffffffff]
  fold_in(key, data)  threefry(key, counters (0, data))
  split(key, num)     row i = threefry(key, counters (0, i))
  uniform(key, shape) bits1 ^ bits2 of threefry(key, the flat iota over
                      shape as (hi, lo) words), the top 23 bits as the
                      mantissa of a float in [1, 2), minus 1

``block_keys`` and ``uniform_rows`` derive and draw for many keys at once,
as the render path does for its ray blocks.  A key is an int64 tensor [2]
holding two uint32 words; all uint32 arithmetic runs in int64 with a
32-bit mask.
"""

import math

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 (20 rounds) of the counter pairs (x0, x1), int64
    tensors of uint32 values, under the key words k0, k1 (int64 tensors
    that broadcast against the counters)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def _words(key):
    """The key's two words as 0-d int64 tensors where the key lies."""
    if not isinstance(key, torch.Tensor):
        key = torch.as_tensor(np.asarray(key, np.int64))
    key = key.reshape(2).to(torch.int64)
    return key[0], key[1]


def key(seed: int) -> torch.Tensor:
    """``jax.random.key_data(jax.random.key(seed))`` for a 64-bit seed (JAX
    with 64-bit types off first cuts the seed to its low 32 bits)."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return torch.tensor([seed >> 32, seed & _MASK], dtype=torch.int64)


def fold_in(key, data) -> torch.Tensor:
    """``jax.random.fold_in``: the key hashed with the counters (0, data);
    ``data`` is an int or a 0-d int64 tensor on the key's device."""
    k0, k1 = _words(key)
    if isinstance(data, torch.Tensor):
        x1 = data.reshape(1).to(torch.int64) & _MASK
    else:
        x1 = torch.tensor([int(data) & _MASK], dtype=torch.int64, device=k0.device)
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(x1), x1)
    return torch.cat([y0, y1])


def block_keys(key, n: int, index: int = 0) -> torch.Tensor:
    """[n, 2] keys, row b = split(fold_in(key, b))[index]: the key that the
    JAX render path draws ray block b's numbers from (index 0) or shades
    sorted block b under (index 1)."""
    k0, k1 = _words(key)
    zeros = torch.zeros(n, dtype=torch.int64, device=k0.device)
    y0, y1 = threefry2x32(k0, k1, zeros, torch.arange(n, dtype=torch.int64, device=k0.device))
    return torch.stack(threefry2x32(y0, y1, zeros, torch.full_like(zeros, index)), -1)


def uniform_rows(keys: torch.Tensor, width: int, device="cpu") -> torch.Tensor:
    """[n, width] float32: row r is ``uniform(keys[r], (width,))``."""
    keys = keys.to(device)
    counters = torch.arange(int(width), dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(keys[:, :1], keys[:, 1:], torch.zeros_like(counters), counters)
    return _unit_float(y0 ^ y1)


def split(key, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (partitionable): [num, 2] keys."""
    k0, k1 = _words(key)
    counters = torch.arange(num, dtype=torch.int64, device=k0.device)
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(counters), counters)
    return torch.stack([y0, y1], -1)


def bits_at(key, counters: torch.Tensor) -> torch.Tensor:
    """The 32 random bits (int64) that ``jax.random.bits`` puts at flat
    positions ``counters`` (an int64 tensor) of any draw under ``key``."""
    k0, k1 = _words(key)
    y0, y1 = threefry2x32(k0, k1, counters >> 32, counters & _MASK)
    return y0 ^ y1


def _unit_float(bits: torch.Tensor) -> torch.Tensor:
    """Float32 in [0, 1) from 32 random bits: the top 23 as the mantissa of
    a float in [1, 2), minus 1."""
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return mant.view(torch.float32) - 1.0


def uniform_at(key, counters: torch.Tensor) -> torch.Tensor:
    """Float32 uniforms in [0, 1) at flat positions ``counters``."""
    return _unit_float(bits_at(key, counters))


def uniform(key, shape, device="cpu") -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` (float32) on ``device``."""
    shape = tuple(int(s) for s in shape)
    counters = torch.arange(math.prod(shape), dtype=torch.int64, device=device).reshape(shape)
    return uniform_at(key, counters)
