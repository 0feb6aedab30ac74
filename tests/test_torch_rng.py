"""nerftex_torch.utils.jax_rng against jax.random, bit for bit: keys,
fold_in, split and uniform; and the port's key path against the per-ray
offsets JAX drew for the bench frame (tests/torch_bench_inputs.npz)."""

import os

import jax
import numpy as np
import pytest
import torch

from nerftex_torch.instancing.instancer import Instancer
from nerftex_torch.utils import jax_rng

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = (0, 1, 42, 123456789, 0xFFFFFFFF)


def _data(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_split_match_jax(seed):
    k = jax.random.key(seed)
    tk = jax_rng.key(seed)
    np.testing.assert_array_equal(tk.numpy(), _data(k))
    for d in (0, 1, 2048, 0x7FFFFFFF):
        np.testing.assert_array_equal(jax_rng.fold_in(tk, d).numpy(),
                                      _data(jax.random.fold_in(k, d)), err_msg=str(d))
    for num in (2, 3):
        np.testing.assert_array_equal(jax_rng.split(tk, num).numpy(),
                                      _data(jax.random.split(k, num)))
    # Chains, as the renderer derives its keys.
    chain = jax.random.split(jax.random.fold_in(jax.random.fold_in(k, 7), 0x7FFFFFFF))[0]
    t_chain = jax_rng.split(jax_rng.fold_in(jax_rng.fold_in(tk, 7), 0x7FFFFFFF))[0]
    np.testing.assert_array_equal(t_chain.numpy(), _data(chain))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(7,), (64, 13), (2048, 8)])
def test_uniform_matches_jax_bitwise(seed, shape):
    k = jax.random.fold_in(jax.random.key(seed), 3)
    want = np.asarray(jax.random.uniform(k, shape))
    got = jax_rng.uniform(jax_rng.fold_in(jax_rng.key(seed), 3), shape).numpy()
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert got.min() >= 0.0 and got.max() < 1.0


def test_uniform_leading_columns_of_a_wider_draw():
    """The sorted path draws a block's pick uniforms at its step bucket's
    width and keeps the first S_b columns."""
    k = jax.random.key(5)
    want = np.asarray(jax.random.uniform(k, (33, 160)))[:, :97]
    got = jax_rng.uniform(jax_rng.key(5), (33, 97), full_width=160).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_key_path_reproduces_bench_offsets():
    """The offsets the port draws from key(1) for the 512x512 bench frame
    (one render chunk of 262144 rays, ray blocks of 1024) are the ones JAX
    draws (scripts/make_torch_bench_inputs.py jax_u_offsets)."""
    from scripts.make_torch_bench_inputs import jax_u_offsets

    want = jax_u_offsets(jax.random.key(1), 512 * 512, 262144, 1024)
    inst = Instancer(b_0=[-1, -1, -1], b_1=[1, 1, 1], instance_sampling_method="nearest",
                     transformations=[np.eye(4)], ray_block=1024, device="cpu")
    # Renderer.__call__ folds in the chunk's first ray, InstanceRenderer
    # splits off the instancer's key.
    k_inst = jax_rng.split(jax_rng.fold_in(jax_rng.key(1), 0))[0]
    n = want.shape[0]
    rays = torch.zeros(n, 3)
    got = inst.device_instancer._prepare(rays, rays, torch.zeros(n, 1), k_inst)[3]
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
