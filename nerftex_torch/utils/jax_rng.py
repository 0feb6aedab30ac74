"""JAX's default random streams, bit for bit, in PyTorch.

The JAX package draws its per-ray marching offsets and per-sample overlap
picks from ``jax.random`` keys.  Its default generator is threefry2x32 with
``jax_threefry_partitionable`` on: a counter-based hash, so the same draws
can be computed anywhere.  This module reproduces the calls the render
path makes:

  key(seed)           key data [seed >> 32, seed & 0xffffffff]
  fold_in(key, data)  threefry(key, counters (0, data))
  split(key, num)     row i = threefry(key, counters (0, i))
  uniform(key, shape) bits1 ^ bits2 of threefry(key, the flat iota over
                      shape as (hi, lo) words), the top 23 bits as the
                      mantissa of a float in [1, 2), minus 1
  uniform_range       uniform(key, shape, minval=, maxval=): u * (max - min)
                      + min as one fused multiply-add, as XLA's CPU backend
                      contracts it (the parameter init draws so)
  normal(key, shape)  sqrt(2) erfinv(u), u uniform on (-1, 1), with XLA's
                      single-precision erfinv (Giles' polynomial)

  randint(key, shape, minval, maxval)
                      ``jax.random.randint`` for int32: two 32-bit words
                      per value from ``split(key)``, reduced into the span
                      with uint32 wraparound

A key is an int64 tensor [2] holding two uint32 words.  Its words stay
tensors where the key lies and are never read back to the host, and the
``data`` of ``fold_in`` may be a 0-d int64 tensor: a key and a step on the
card derive and draw on the card, so a CUDA graph can capture the draws
(the training step's).  A key on the CPU draws on the device it is given.
``block_keys`` and ``uniform_rows`` derive and draw for many keys at once
(one threefry over all of them), as the render path does for its ray
blocks.  All uint32 arithmetic runs in int64 with a 32-bit mask, because
PyTorch's uint32 support is partial; every add and rotation is masked back
to 32 bits.
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


def _positions(shape, device, full_width: int = None, rows: torch.Tensor = None) -> torch.Tensor:
    """The flat positions (int64, ``shape``) that a draw of ``shape`` takes
    from its key: the iota over ``shape``; with ``full_width``, those of
    the leading ``shape[-1]`` columns of a draw ``full_width`` wide; with
    ``rows`` (int64 indices of the flattened leading dimensions), those of
    rows ``rows`` of a larger draw.  Position (row, column) is row * width +
    column whatever the number of rows, so a shard of a batch draws exactly
    its rows of the whole batch's draw."""
    if (full_width is None and rows is None) or not shape:
        return torch.arange(math.prod(shape), dtype=torch.int64, device=device).reshape(shape)
    width = shape[-1] if full_width is None else int(full_width)
    if rows is None:
        rows = torch.arange(math.prod(shape[:-1]), dtype=torch.int64, device=device)
    counters = (rows.to(device=device, dtype=torch.int64).reshape(-1, 1) * width
                + torch.arange(shape[-1], dtype=torch.int64, device=device)[None, :])
    return counters.reshape(shape)


def uniform(key, shape, device="cpu", full_width: int = None, rows=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` (float32) on ``device``.

    With ``full_width``, the leading ``shape[-1]`` columns of
    ``uniform(key, shape[:-1] + (full_width,))``, computed without drawing
    the rest; with ``rows``, rows ``rows`` of a larger draw (_positions)."""
    shape = tuple(int(s) for s in shape)
    return uniform_at(key, _positions(shape, device, full_width, rows))


def randint(key, shape, minval: int, maxval: int, device="cpu") -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32 values, as
    an int64 tensor on ``device``): 32 bits from each of ``split(key)``'s
    two keys, hi % span * ((2^16 % span)^2 % span) + lo % span, reduced
    mod span, every product and sum with uint32 wraparound; span = maxval -
    minval, or 1 when that is not positive."""
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    span = int(maxval) - int(minval)
    span = span if span > 0 else 1
    multiplier = ((2**16 % span) ** 2 & _MASK) % span
    k_hi, k_lo = split(key)
    counters = torch.arange(n, dtype=torch.int64, device=device)
    hi, lo = bits_at(k_hi, counters), bits_at(k_lo, counters)
    offset = ((((hi % span) * multiplier) & _MASK) + lo % span) & _MASK
    return (int(minval) + offset % span).reshape(shape)


def _fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 a * b + c with one rounding, as a fused multiply-add: the
    product of two float32 values is exact in float64, so only the sum
    rounds there before the cast back (the double rounding this risks is
    rarer than 2^-29 per value)."""
    return (a.double() * b + c).float()


def uniform_range(key, shape, minval: float, maxval: float, device="cpu",
                  full_width: int = None, rows=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` as the
    JAX package computes it on the CPU: max(min, u * (max - min) + min),
    the bounds rounded to float32 first and the scale-and-shift fused.
    ``full_width`` and ``rows`` as in ``uniform``."""
    lo = float(np.float32(minval))
    hi = float(np.float32(maxval))
    u = uniform(key, shape, device=device, full_width=full_width, rows=rows)
    return torch.clamp_min(_fma32(u, float(np.float32(hi - lo)), lo), lo)


# XLA's ErfInv for float32 (M. Giles, "Approximating the erfinv function"):
# a polynomial in w - 2.5 for w = -log1p(-x^2) < 5, in sqrt(w) - 3 beyond.
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
                 -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
                 -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 erfinv by XLA's polynomial, each step a fused multiply-add.
    PyTorch's log1p and XLA's differ by an ulp on about 1% of arguments, so
    this agrees with XLA to a few ulps (torch.erfinv is ~50 ulps away)."""
    w = -torch.log1p(-x * x)
    small = w < 5.0
    ws = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0).double()
    p = torch.where(small, _ERFINV_SMALL[0], _ERFINV_LARGE[0])
    for a, b in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        p = _fma32(p, ws, torch.where(small, a, b).double())
    return torch.where(x.abs() == 1, x * float("inf"), p * x)


def normal(key, shape, device="cpu", full_width: int = None, rows=None) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` (float32) on ``device``;
    ``full_width`` and ``rows`` as in ``uniform``."""
    lo = float(np.nextafter(np.float32(-1), np.float32(0)))
    u = uniform_range(key, shape, lo, 1.0, device, full_width=full_width, rows=rows)
    return float(np.float32(np.sqrt(2))) * erfinv(u)
