"""nerftex_torch texture fetch (kernels/tex_gather.py) against the JAX
package's two fetch paths: the quad row gather (device._sample_channel_quads)
and the Pallas one-hot kernel in interpret mode (sample_channel_quads_pallas);
the byte-quad table's admission against the JAX byte table's."""

import os
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerftex_tpu.instancing.device import _sample_channel_quads
from nerftex_tpu.kernels.tex_gather import build_byte_tableT, sample_channel_quads_pallas
from nerftex_torch.kernels import tex_gather

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _byte_tex(w, h, seed=0):
    b = np.random.RandomState(seed).randint(0, 256, (w, h)).astype(np.uint8)
    return b.astype(np.float32) / np.float32(255.0)


def _quads(tex):
    right = np.concatenate([tex[1:], tex[-1:]], 0)
    down = np.concatenate([tex[:, 1:], tex[:, -1:]], 1)
    right_down = np.concatenate([right[:, 1:], right[:, -1:]], 1)
    return jnp.asarray(np.stack([tex, down, right, right_down], -1))


@pytest.fixture(scope="module")
def tex():
    return _byte_tex(256, 256, seed=3)


def test_corners_exact_on_texel_grid(tex):
    """At texel centres the lerp weights are 0/1, so the fetch returns the
    corner value itself: exact in both implementations."""
    w, h = tex.shape
    i = np.array([0, 1, 17, 128, 254, 255])
    j = np.array([0, 255, 3, 200, 254, 1])
    uv = np.stack([i / np.float32(w - 1), j / np.float32(h - 1)], -1).astype(np.float32)
    got = tex_gather.sample_channel(torch.tensor(tex), torch.tensor(uv)).numpy()
    want = np.asarray(_sample_channel_quads(_quads(tex), jnp.asarray(uv), (w, h)))
    np.testing.assert_array_equal(got, tex[i, j])
    np.testing.assert_array_equal(want, tex[i, j])


def test_plain_fetch_matches_both_jax_paths(tex):
    rs = np.random.RandomState(4)
    uv = rs.uniform(-0.05, 1.05, (7, 37, 2)).astype(np.float32)   # clamps, odd shape
    got = tex_gather.sample_channel(torch.tensor(tex), torch.tensor(uv)).numpy()
    assert got.shape == (7, 37)
    gather = np.asarray(_sample_channel_quads(_quads(tex), jnp.asarray(uv), tex.shape))
    tbT = jnp.asarray(build_byte_tableT(tex)).astype(jnp.bfloat16)
    pallas = np.asarray(sample_channel_quads_pallas(tbT, jnp.asarray(uv), tex.shape,
                                                    interpret=True))
    # Same corners; the lerp may differ by <= 2 ulp where XLA contracts an
    # fma (PARITY.md, tests/test_tex_kernel.py pin 4e-7).
    np.testing.assert_allclose(got, gather, rtol=0, atol=4e-7)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=4e-7)


def test_non_byte_texture_and_odd_dims():
    """The port fetches any f32 channel (the TPU kernel only byte-valued
    ones); dims that are not powers of two and a width of 2."""
    rs = np.random.RandomState(6)
    for w, h in ((60, 40), (2, 9)):
        tex = rs.rand(w, h).astype(np.float32)
        uv = rs.uniform(0, 1, (300, 2)).astype(np.float32)
        got = tex_gather.sample_channel(torch.tensor(tex), torch.tensor(uv)).numpy()
        want = np.asarray(_sample_channel_quads(_quads(tex), jnp.asarray(uv), (w, h)))
        np.testing.assert_allclose(got, want, rtol=0, atol=4e-7)


def test_cpu_tensor_takes_the_plain_version(tex):
    before = tex_gather.sample_channel.launches
    uv = torch.rand(10, 2)
    out = tex_gather.sample_channel(torch.tensor(tex), uv)
    assert torch.equal(out, tex_gather.sample_channel_plain(torch.tensor(tex), uv))
    assert tex_gather.sample_channel.launches == before


def _png_channel(name):
    from nerftex_torch.instancing.scene import load_texture_channels

    return load_texture_channels(os.path.join(ROOT, "meshes", name))[0]


@pytest.mark.parametrize("case", ["smooth_checkerboard.png", "checkerboard.png", "non_byte",
                                  "odd_dims", "near_byte"])
def test_byte_quad_admission_matches_jax(case):
    """The port admits a channel to the byte_quad variant exactly when the
    JAX package builds its byte table for it."""
    rs = np.random.RandomState(8)
    if case.endswith(".png"):
        tex = _png_channel(case)
    elif case == "non_byte":
        tex = rs.rand(40, 24).astype(np.float32)
    elif case == "odd_dims":
        tex = _byte_tex(61, 37, seed=9)
    else:  # one texel a float32 ulp off its byte value
        tex = _byte_tex(16, 16, seed=10)
        tex[3, 5] = np.nextafter(tex[3, 5], np.float32(2))
    quads = tex_gather.byte_quads(torch.tensor(tex))
    assert (quads is None) == (build_byte_tableT(tex) is None)
    assert (quads is None) == (case in ("non_byte", "near_byte"))
    if quads is not None:
        w, h = tex.shape
        assert quads.dtype == torch.uint8 and tuple(quads.shape) == (w - 1, h - 1, 4)
        b = np.round(tex * 255).astype(np.uint8)
        np.testing.assert_array_equal(quads[:, :, 0].numpy(), b[:-1, :-1])
        np.testing.assert_array_equal(quads[:, :, 3].numpy(), b[1:, 1:])


def _round_f32(exact):
    """A rational rounded to the nearest float32, ties to even."""
    f = np.float32(float(exact))
    near = [np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))]
    return min(near, key=lambda v: (abs(Fraction(float(v)) - exact), int(v.view(np.uint32)) & 1))


def test_byte_values_are_the_correctly_rounded_division():
    """b / 255 in float32 for every byte, as torch's division and the PNG
    loader's numpy division give it, and as the kernel computes it: q = b * r
    (r = 1/255 in float32) corrected by fma(fma(-q, 255, b), r, q), each
    step rounded once (exact rational arithmetic here)."""
    want = np.arange(256).astype(np.float32) / np.float32(255.0)
    got = torch.arange(256, dtype=torch.float32) / 255.0
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tex_gather.BYTE_VALUES, want)
    for b in range(256):
        assert Fraction(float(want[b])) == Fraction(float(_round_f32(Fraction(b, 255))))
        r = Fraction(float(np.float32(1) / np.float32(255)))
        q = Fraction(float(_round_f32(b * r)))
        e = Fraction(float(_round_f32(-q * 255 + b)))
        assert _round_f32(e * r + q) == want[b]


@pytest.mark.parametrize("name", ["smooth_checkerboard.png", "checkerboard.png"])
def test_quad_fetch_matches_plain_and_pallas(name):
    """The byte_quad variant's plain version against the f32 fetch (bit for
    bit) and the JAX Pallas kernel in interpret mode (4e-7)."""
    tex = _png_channel(name)
    rs = np.random.RandomState(11)
    uv = rs.uniform(-0.05, 1.05, (5, 41, 2)).astype(np.float32)
    t_tex, t_uv = torch.tensor(tex), torch.tensor(uv)
    quads = tex_gather.byte_quads(t_tex)
    got = tex_gather.sample_channel(t_tex, t_uv, quads)
    assert torch.equal(got, tex_gather.sample_channel_plain(t_tex, t_uv))
    assert torch.equal(got, tex_gather.fetch_quads_plain(quads, *tex.shape, t_uv))
    tbT = jnp.asarray(build_byte_tableT(tex)).astype(jnp.bfloat16)
    pallas = np.asarray(sample_channel_quads_pallas(tbT, jnp.asarray(uv), tex.shape,
                                                    interpret=True))
    np.testing.assert_allclose(got.numpy(), pallas, rtol=0, atol=4e-7)
