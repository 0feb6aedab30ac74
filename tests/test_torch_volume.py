"""The port's volume-rendering primitives and normal draws against the JAX
package's on the same inputs and keys: stratified_z_vals with and without
jitter (the same uniform draws), composite with and without density noise,
background and map_exr, sample_pdf with det True and False, and
jax_rng.normal and uniform_range against jax.random."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerftex_tpu.ops import volume as jax_volume
from nerftex_torch.ops import volume
from nerftex_torch.utils import jax_rng

R, S = 96, 32


def _t(seed=0):
    """[R, 2] ray intervals, a fifth of them zeroed (sanitized misses)."""
    rs = np.random.RandomState(seed)
    t0 = rs.uniform(2, 4, R).astype(np.float32)
    t = np.stack([t0, t0 + rs.uniform(0.1, 2, R).astype(np.float32)], -1)
    t[::5] = 0
    return t


@pytest.mark.parametrize("perturb", [False, True])
def test_stratified_z_vals_match_jax(perturb):
    t = _t()
    want = np.asarray(jax_volume.stratified_z_vals(jnp.asarray(t), S, perturb,
                                                   jax.random.key(3)))
    got = volume.stratified_z_vals(torch.tensor(t), S, perturb, jax_rng.key(3)).numpy()
    # The same uniform draws (bit-equal); XLA fuses the linspace blend and
    # lower + (upper - lower) * u into fused multiply-adds, which PyTorch
    # rounds in two steps: one float32 rounding of values below 6.
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if perturb:
        flat = volume.stratified_z_vals(torch.tensor(t), S, False).numpy()
        assert np.abs(got - flat).max() > 1e-3


def _composite_inputs(seed=1):
    rs = np.random.RandomState(seed)
    z = np.sort(rs.uniform(2, 5, (R, S)).astype(np.float32), -1)
    return (rs.normal(size=(R, S, 3)).astype(np.float32),
            rs.normal(scale=3, size=(R, S)).astype(np.float32), z,
            rs.normal(size=(R, 3)).astype(np.float32))


@pytest.mark.parametrize("noise,bkgd,exr", [(0.0, False, False), (0.1, False, False),
                                            (0.0, True, False), (0.5, True, True),
                                            (0.0, False, True)])
def test_composite_matches_jax(noise, bkgd, exr):
    color, density, z, rays_d = _composite_inputs()
    kw = dict(composite_bkgd=bkgd, bkgd_color=[0.2, 0.5, 1.0], raw_noise_std=noise,
              map_exr=exr)
    want = jax_volume.composite(jnp.asarray(color), jnp.asarray(density), jnp.asarray(z),
                                jnp.asarray(rays_d), noise_key=jax.random.key(5), **kw)
    got = volume.composite(torch.tensor(color), torch.tensor(density), torch.tensor(z),
                           torch.tensor(rays_d), noise_key=jax_rng.key(5), **kw)
    # float32 products and sums in other orders (cumprod, the S-term
    # sums) and the noise's erfinv a few ulps from XLA's: relative 1e-6
    # of values up to ~10 (depth), measured <= 2e-6 absolute.
    for name, w, g in zip(("color", "alpha", "weights", "depth"), want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5, err_msg=name)
    if noise:
        quiet = volume.composite(torch.tensor(color), torch.tensor(density), torch.tensor(z),
                                 torch.tensor(rays_d), **dict(kw, raw_noise_std=0.0))
        assert (quiet[1] - got[1]).abs().max() > 1e-4


@pytest.mark.parametrize("det", [True, False])
def test_sample_pdf_matches_jax(det):
    rs = np.random.RandomState(2)
    bins = np.sort(rs.uniform(2, 5, (R, S - 1)).astype(np.float32), -1)
    weights = rs.uniform(0, 1, (R, S - 2)).astype(np.float32) ** 4
    weights[::7] = 0  # all-empty rays: the 1e-5 floor and the denom guard
    want = np.asarray(jax_volume.sample_pdf(jnp.asarray(bins), jnp.asarray(weights), 16,
                                            det=det, key=jax.random.key(9)))
    got = volume.sample_pdf(torch.tensor(bins), torch.tensor(weights), 16, det=det,
                            key=jax_rng.key(9)).numpy()
    u = (np.broadcast_to(np.linspace(0, 1, 16, dtype=np.float32), want.shape) if det
         else np.asarray(jax.random.uniform(jax.random.key(9), want.shape)))
    # Both invert the same cdf, summed in other orders (XLA's reductions
    # are not sequential): a sample in a bin of tiny pdf moves by the cdf's
    # rounding over that pdf (up to 2.5e-4 here, at the u = 1 end), so the
    # check is the inverse-cdf property itself: every sample of either
    # package is its quantile u of the exact (float64) cdf, to 1e-6 plus
    # the cdf's slope times 1e-6 (two float32 ulps of samples below 5).
    w = weights.astype(np.float64) + 1e-5
    cdf = np.concatenate([np.zeros((R, 1)), np.cumsum(w / w.sum(-1, keepdims=True), -1)], -1)
    idx = np.clip(np.stack([np.searchsorted(cdf[r], u[r], "right") for r in range(R)]) - 1,
                  0, S - 3)
    mass = np.take_along_axis(np.diff(cdf, axis=-1), idx, -1)
    slope = mass / np.take_along_axis(np.diff(bins, axis=-1), idx, -1)
    for name, z in (("jax", want), ("port", got)):
        f = np.stack([np.interp(z[r], bins[r], cdf[r]) for r in range(R)])
        assert np.all(np.abs(f - u) <= 1e-6 + slope * 1e-6), name
    # Where the sampled bin holds 1% of the mass or more, the samples agree
    # to a few float32 ulps of values below 5.
    np.testing.assert_allclose(got[mass > 1e-2], want[mass > 1e-2], rtol=0, atol=5e-6)
    assert (mass > 1e-2).mean() > 0.3


@pytest.mark.parametrize("shape", [(64, 257), (3, 4096)])
def test_normal_matches_jax(shape):
    want = np.asarray(jax.random.normal(jax.random.key(7), shape))
    got = jax_rng.normal(jax_rng.key(7), shape).numpy()
    # The same uniforms and erfinv polynomial; XLA's log1p and PyTorch's
    # differ by an ulp on ~1% of arguments: measured <= 2.4e-7 relative.
    np.testing.assert_allclose(got, want, rtol=5e-7, atol=1e-7)
    assert np.mean(got == want) > 0.95


@pytest.mark.parametrize("fan_in,fan_out", [(81, 256), (337, 256), (128, 3)])
def test_uniform_range_is_jax_bit_for_bit(fan_in, fan_out):
    limit = (6.0 / (fan_in + fan_out)) ** 0.5
    key = jax.random.split(jax.random.fold_in(jax.random.key(0), 1000), 8)[3]
    want = np.asarray(jax.random.uniform(key, (fan_in, fan_out), jnp.float32, -limit, limit))
    tkey = jax_rng.split(jax_rng.fold_in(jax_rng.key(0), 1000), 8)[3]
    got = jax_rng.uniform_range(tkey, (fan_in, fan_out), -limit, limit).numpy()
    np.testing.assert_array_equal(got, want)


def test_split_four_gives_the_renderers_keys():
    """render_rays splits its key into (jitter, coarse noise, fine noise,
    importance) with split(key, 4), as the JAX renderer does."""
    for seed, data in ((0, 0), (7, 4096)):
        want = np.asarray(jax.random.key_data(
            jax.random.split(jax.random.fold_in(jax.random.key(seed), data), 4)))
        got = jax_rng.split(jax_rng.fold_in(jax_rng.key(seed), data), 4).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int64))
