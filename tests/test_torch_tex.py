"""nerftex_torch texture fetch (kernels/tex_gather.py) against the JAX
package's two fetch paths: the quad row gather (device._sample_channel_quads)
and the Pallas one-hot kernel in interpret mode (sample_channel_quads_pallas)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerftex_tpu.instancing.device import _sample_channel_quads
from nerftex_tpu.kernels.tex_gather import build_byte_tableT, sample_channel_quads_pallas
from nerftex_torch.kernels import tex_gather


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
