"""nerftex_torch models against the JAX package on the same inputs and the
same transplanted weights: FourierFeatures, ParamNerf (plain forward, f32
and bf16) and Nerf, the fused MLP's plain version against the Pallas kernel
in interpret mode, and the weight transplant."""

import os
import sys

import jax
import numpy as np
import pytest
import torch

import nerftex_tpu.models.mlp as jax_mlp
from nerftex_tpu.kernels.mlp_pallas import make_fused_apply
from nerftex_tpu.models.encodings import FourierFeatures as JaxFourier
from nerftex_tpu.utils import rng
from nerftex_tpu.utils import util as jax_util
from nerftex_torch.kernels import mlp_fused as fused
from nerftex_torch.models.encodings import FourierFeatures
from nerftex_torch.render.checkpoint import flatten_params, load_jax_params
from nerftex_torch.utils.util import instantiate

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _jax_reference import group, recorded  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

TESTS = os.path.dirname(os.path.abspath(__file__))
MODULE = "test_torch_models"


def _cfg(n_pos_bands=10, n_dir_bands=4, n_param_bands=4, **kw):
    def ff(n):
        return {"module": "network.model.FourierFeatures", "n_freq_bands": n}

    cfg = {"module": "network.model.ParamNerf", "pos_embedding": ff(n_pos_bands),
           "dir_embedding": ff(n_dir_bands), "param_embedding": ff(n_param_bands),
           "n_parameters": [1, 6]}
    cfg.update(kw)
    return cfg


def _jax_model(**kw):
    rng.set_seed(0)
    jax_mlp._INIT_COUNTER[0] = 0
    return jax_util.instantiate(jax_util.EasyDict(_cfg(**kw)))["model"]


def _port_model(weights, **kw):
    """The port's ParamNerf of ``_cfg(**kw)`` with the given JAX weights."""
    tm = instantiate(_cfg(**kw), device="cpu")
    load_jax_params(tm, weights)
    return tm


def _pair(**kw):
    """(JAX model, port ParamNerf with the JAX weights) from one config."""
    jm = _jax_model(**kw)
    return jm, _port_model(jax.tree.map(np.asarray, jm.params), **kw)


def _input_weights(scene):
    """The full-width seed-0 weights of tests/torch_<scene>_inputs.npz."""
    return group(dict(np.load(os.path.join(TESTS, f"torch_{scene}_inputs.npz"))), "param/")


def _jax_pallas(kw, n_prm, seed, weights_from=None):
    """The Pallas kernel's output in interpret mode on _inputs(200) with the
    JAX init's weights of ``_cfg(**kw)``: recorded with those weights, or
    checked equal to tests/torch_<weights_from>_inputs.npz's."""
    jm = _jax_model(**kw)
    flat = flatten_params(jax.tree.map(np.asarray, jm.params))
    out = {}
    if weights_from is None:
        out.update({f"weights/{k}": v for k, v in flat.items()})
    else:
        stored = _input_weights(weights_from)
        assert set(stored) == set(flat), weights_from
        for k, v in flat.items():
            np.testing.assert_array_equal(stored[k], v, err_msg=f"{weights_from} {k}")
    pos, dirs, prm = _inputs(200, n_prm=n_prm, seed=seed)
    pallas = make_fused_apply(jm.static_topology, interpret=True, tile=128)
    c_j, d_j = (np.asarray(v) for v in pallas(jm.params, pos, dirs, prm))
    return {**out, "color": c_j, "density": d_j}


def _inputs(n, n_prm=7, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.uniform(-1, 1, (n, 3)).astype(np.float32),
            rs.normal(size=(n, 3)).astype(np.float32),
            rs.uniform(0, 1, (n, n_prm)).astype(np.float32))


SMALL = dict(depth=3, width=64, skips=[1])


@pytest.fixture(scope="module")
def small_f32():
    return _pair(**SMALL)


@pytest.mark.parametrize("n_bands", [0, 4, 10])
def test_fourier_features_match_jax(n_bands):
    x = np.random.RandomState(n_bands).uniform(-2, 2, (50, 3)).astype(np.float32)
    want = np.asarray(JaxFourier(n_bands)(x))
    got = FourierFeatures(n_bands)(torch.tensor(x)).numpy()
    assert got.shape == want.shape
    # Same band order; sin/cos of the same f32 arguments up to libm ulps.
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_fourier_bf16_operand_rounds_only_the_lift():
    x = torch.tensor(np.random.RandomState(1).uniform(-2, 2, (20, 3)).astype(np.float32))
    got = FourierFeatures(4, matmul_precision="bfloat16")(x)
    xb = x.to(torch.bfloat16).float()
    want = torch.cat([x, FourierFeatures(4)(xb)[:, 3:]], -1)
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
        FourierFeatures(4, matmul_precision="tf32")


def test_param_nerf_f32_forward_and_fused_plain_match_jax(small_f32):
    jm, tm = small_f32
    pos, dirs, prm = _inputs(300)
    c_j, d_j = (np.asarray(v) for v in jm.apply(jm.params, pos, dirs, prm))
    args = (torch.tensor(pos), torch.tensor(dirs), torch.tensor(prm))
    with torch.no_grad():
        c_f, d_f = tm(*args)
    c_i, d_i = tm.infer(*args)
    for got, want in ((c_f, c_j), (d_f, d_j), (c_i, c_j), (d_i, d_j)):
        assert got.shape == want.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_param_nerf_bf16_forward_matches_jax():
    jm, tm = _pair(compute_dtype="bfloat16", **SMALL)
    pos, dirs, prm = _inputs(300, seed=3)
    c_j, d_j = (np.asarray(v) for v in jm.apply(jm.params, pos, dirs, prm))
    with torch.no_grad():
        c_t, d_t = tm(torch.tensor(pos), torch.tensor(dirs), torch.tensor(prm))
    # Both round every partial product and bias add to bf16 (2^-8 relative);
    # a product accumulated in another order can round one step apart, so
    # allow a few bf16 ulps of the output scale.
    scale = max(1.0, float(np.abs(c_j).max()), float(np.abs(d_j).max()))
    np.testing.assert_allclose(c_t.numpy(), c_j, rtol=0, atol=3 * 2**-8 * scale)
    np.testing.assert_allclose(d_t.numpy(), d_j, rtol=0, atol=3 * 2**-8 * scale)


GEO_ONLY = dict(n_pos_bands=4, n_dir_bands=2, n_param_bands=2, n_parameters=[2, 0],
                param_depth=1, depth=3, width=64, skips=[1], color_depth=2)


@pytest.mark.parametrize("variant", ["carpet_width", "param_mlp_geo_only"])
def test_fused_plain_matches_pallas_interpret(variant):
    """The fused kernel's plain version against the Pallas kernel run in
    interpret mode (as tests/test_pallas_mlp.py runs it)."""
    want = recorded(MODULE, f"test_fused_plain_matches_pallas_interpret[{variant}]")
    if variant == "carpet_width":
        tm = _port_model(_input_weights("bench"))
        n_prm = 7
    else:
        tm = _port_model(group(want, "weights/"), **GEO_ONLY)
        n_prm = 2
    pos, dirs, prm = _inputs(200, n_prm=n_prm, seed=5)
    c_j, d_j = want["color"], want["density"]
    c_t, d_t = tm.infer(torch.tensor(pos), torch.tensor(dirs), torch.tensor(prm))
    np.testing.assert_allclose(c_t.numpy(), c_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(d_t.numpy(), d_j, rtol=0, atol=1e-5)


def test_fused_pack_layout(small_f32):
    _, tm = small_f32
    packed = tm.packed()
    assert packed.pos_dim == 63 + 9 and packed.dir_dim == 27 + 54
    assert (packed.pos_pad, packed.dir_pad) == (80, 96)
    # trunk 3 + alpha + bottleneck + color_depth 1 + pre_color + color
    assert len(packed.table) == 8
    assert packed.table[:, 6].max() <= fused.MAX_WIDTH
    assert (packed.table[:, 0] % 16 == 0).all()   # 32-byte aligned bf16 tiles
    assert packed.macs == sum(m.weight.numel() for m in tm.modules()
                              if isinstance(m, torch.nn.Linear))
    # The cached layout follows the parameters and the compute dtype.
    assert tm.packed() is packed
    tm.compute_dtype = torch.bfloat16
    assert tm.packed().weights.dtype == torch.bfloat16
    tm.compute_dtype = torch.float32
    with torch.no_grad():
        tm.color.bias.add_(1.0)
    assert tm.packed() is not packed
    with torch.no_grad():
        tm.color.bias.sub_(1.0)


@pytest.mark.parametrize("topology", ["bench", "plush"])
def test_fused_slab_image_unpacks_to_each_layer(topology):
    """The wgmma variant's [K/8][n_pad][8] image of every layer, read back
    as [K_pad, n_pad], is the layer's packed weights exactly; every 64-deep
    K slab starts at w_off + 64 * n_pad."""
    kw = {"bench": {"n_parameters": [1, 6]},
          "plush": {"n_parameters": [1, 4], "param_depth": 0, "color_depth": 1}}[topology]
    tm = instantiate(_cfg(depth=2, skips=[0], compute_dtype="bfloat16", **kw), device="cpu")
    packed = tm.packed()
    assert packed.slabs.dtype == torch.bfloat16
    assert packed.slabs.shape == packed.weights.shape
    for w_off, _, s0, k0, s1, k1, n_pad, *_ in packed.table.tolist():
        k = k0 + (k1 if s1 >= 0 else 0)
        rows = packed.weights[w_off:w_off + k * n_pad].view(k, n_pad)
        image = packed.slabs[w_off:w_off + k * n_pad].view(k // 8, n_pad, 8)
        assert torch.equal(image.permute(0, 2, 1).reshape(k, n_pad), rows)
        for k_slab in range(0, k, 64):
            depth = min(64, k - k_slab)
            slab = packed.slabs[w_off + k_slab * n_pad:w_off + (k_slab + depth) * n_pad]
            assert torch.equal(slab.view(depth // 8, n_pad, 8).permute(0, 2, 1).reshape(depth, n_pad),
                               rows[k_slab:k_slab + depth])
    assert len(packed.table) == 2 + 2 + kw.get("color_depth", 1) + 2
    assert (packed.table[:, 4] >= 0).sum() == 2                    # the skip and the dir concat
    tm.compute_dtype = torch.float32
    assert tm.packed().slabs is None


# The frames' ParamNerf topologies (bench: chip_smoke.model_config; plush and
# grass: configs/config_{plush,grass}_render.py, the same widths).
TOPOLOGIES = {"bench": {"n_parameters": [1, 6]},
              "plush": {"n_parameters": [1, 4], "param_depth": 0, "color_depth": 1}}
MLP_F32_TOL = 1e-4    # x max(1, max|reference|), chip_smoke.py's f32 MLP tolerance


def _tf32(x):
    """float32 -> tf32 by masking: round to nearest at the 13th bit, ties
    away from zero, then clear the 13 low bits."""
    bits = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
    return ((bits + 0x1000) & ~0x1FFF).astype(np.uint32).view(np.float32)


def _unpack_tf32(packed, w_off, k, n_pad):
    """(hi, lo) [K_pad, n_pad] of one layer read back from the tf32 image:
    [K/8][hi, lo][2][n_pad][4], each block's rows in TF32_ROW_ORDER."""
    image = packed.tf32_slabs[2 * w_off:2 * (w_off + k * n_pad)].view(k // 8, 2, 2, n_pad, 4)
    out = []
    for half in range(2):
        rows = torch.empty(k // 8, 8, n_pad)
        rows[:, list(fused.TF32_ROW_ORDER)] = image[:, half].permute(0, 1, 3, 2).reshape(
            k // 8, 8, n_pad)
        out.append(rows.reshape(k, n_pad))
    return out


@pytest.mark.parametrize("topology", sorted(TOPOLOGIES))
def test_fused_tf32_image_unpacks_to_each_layer(topology):
    """The wgmma_tf32x3 variant's hi/lo image of every layer, read back,
    holds tf32 values (13 low bits clear) whose sum is the layer's packed
    f32 weights to 2^-21 relative, hi being the weights rounded to tf32;
    every 16-deep K slab of both starts at 2 * (w_off + 16 * n_pad)."""
    tm = instantiate(_cfg(depth=2, skips=[0], **TOPOLOGIES[topology]), device="cpu")
    packed = tm.packed()
    assert packed.slabs is None and packed.tf32_slabs.dtype == torch.float32
    assert packed.tf32_slabs.numel() == 2 * packed.weights.numel()
    assert (packed.tf32_slabs.view(torch.int32) & 0x1FFF == 0).all()
    for w_off, _, s0, k0, s1, k1, n_pad, *_ in packed.table.tolist():
        k = k0 + (k1 if s1 >= 0 else 0)
        w = packed.weights[w_off:w_off + k * n_pad].view(k, n_pad)
        hi, lo = _unpack_tf32(packed, w_off, k, n_pad)
        assert torch.equal(hi, torch.tensor(_tf32(w.numpy())))
        assert torch.equal(lo, torch.tensor(_tf32((w - hi).numpy())))
        assert ((hi + lo - w).abs() <= 2.0**-21 * w.abs()).all()
        for k_slab in range(0, k, 16):
            slab = packed.tf32_slabs[2 * (w_off + k_slab * n_pad):2 * (w_off + (k_slab + 16) * n_pad)]
            rows = torch.empty(2, 8, n_pad)
            rows[:, list(fused.TF32_ROW_ORDER)] = slab.view(2, 2, 2, n_pad, 4)[:, 0].permute(
                0, 1, 3, 2).reshape(2, 8, n_pad)
            assert torch.equal(rows.reshape(16, n_pad), hi[k_slab:k_slab + 16])


def _tf32x3_chain(packed, pos_map, dir_map, products=3):
    """The wgmma_tf32x3 kernel's arithmetic on the CPU: per k8 step, the A
    operand is the activation at columns 8s + TF32_ROW_ORDER[m] and B the
    tf32 image read at the kernel's descriptor addresses (core matrices of
    8 rows x 16 bytes, lbo = 16 n_pad bytes along K, 128 bytes per 8 rows
    along N, lo 2 lbo after hi); the activation is split by masking, and
    each step adds a_lo w_hi + a_hi w_lo + a_hi w_hi to an f32 sum
    (``products=1``: a_hi w_hi alone, single-pass TF32)."""
    image = packed.tf32_slabs.numpy()
    bufs = {fused.BUF_POS: np.zeros((len(pos_map), packed.pos_pad), np.float32),
            fused.BUF_DIR: np.zeros((len(dir_map), packed.dir_pad), np.float32)}
    bufs[fused.BUF_POS][:, :packed.pos_dim] = pos_map
    bufs[fused.BUF_DIR][:, :packed.dir_dim] = dir_map
    out = np.zeros((len(pos_map), 4), np.float32)
    order = np.array(fused.TF32_ROW_ORDER)
    m = np.arange(8)[:, None]
    for w_off, b_off, s0, k0, s1, k1, n_pad, dst, n_out, col, relu in packed.table.tolist():
        x = np.concatenate([bufs[s0], bufs[s1]], 1) if s1 >= 0 else bufs[s0]
        n = np.arange(n_pad)[None, :]
        lbo = 16 * n_pad
        core = (m // 4) * lbo + (n // 8) * 128 + (n % 8) * 16 + (m % 4) * 4   # bytes in a block
        acc = np.zeros((len(x), n_pad), np.float32)
        for s in range(x.shape[1] // 8):
            block = 8 * w_off + 64 * n_pad * s                                 # image is 2x, f32
            b_hi = image[(block + core) // 4]
            b_lo = image[(block + 2 * lbo + core) // 4]
            a = x[:, 8 * s + order]
            a_hi = _tf32(a)
            a_lo = _tf32(a - a_hi)
            acc += a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi if products == 3 else a_hi @ b_hi
        y = acc + packed.biases[b_off:b_off + n_pad].numpy()
        if relu:
            y = np.maximum(y, 0)
        if dst == fused.OUT:
            out[:, col:col + n_out] = y[:, :n_out]
        else:
            bufs[dst] = y
    return out


@pytest.mark.parametrize("topology", sorted(TOPOLOGIES))
def test_tf32x3_rehearsal_matches_pallas_interpret(topology):
    """The 3xTF32 arithmetic and operand layout of the f32 kernel, emulated
    on the CPU at the full 8x256 width, against the Pallas kernel in
    interpret mode at chip_smoke.py's f32 tolerance; single-pass TF32 on
    the same image misses it."""
    want = recorded(MODULE, f"test_tf32x3_rehearsal_matches_pallas_interpret[{topology}]")
    tm = _port_model(_input_weights(topology), **TOPOLOGIES[topology])
    n_prm = sum(TOPOLOGIES[topology]["n_parameters"])
    pos, dirs, prm = _inputs(200, n_prm=n_prm, seed=11)
    ref = np.concatenate([want["color"], want["density"]], -1)
    pos_map, dir_map = tm.feature_maps(torch.tensor(pos), torch.tensor(dirs), torch.tensor(prm))
    packed = tm.packed()
    got = _tf32x3_chain(packed, pos_map.numpy(), dir_map.numpy())
    tol = MLP_F32_TOL * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    single = float(np.abs(_tf32x3_chain(packed, pos_map.numpy(), dir_map.numpy(), products=1)
                          - ref).max())
    print(f"{topology}: max |3xTF32 - Pallas| {err:.3g}, single pass {single:.3g}, tol {tol:.3g}")
    assert err <= tol
    assert single > tol


def test_load_jax_params_checks_keys_and_shapes(small_f32):
    jm, tm = small_f32
    flat = flatten_params(jax.tree.map(np.asarray, jm.params))
    assert flat["trunk/0/w"].shape == (72, 64)
    load_jax_params(tm, flat)
    assert torch.equal(tm.trunk[0].weight, torch.tensor(flat["trunk/0/w"]).T)
    with pytest.raises(KeyError):
        load_jax_params(tm, {k: v for k, v in flat.items() if k != "alpha/b"})
    bad = dict(flat, **{"alpha/w": np.zeros((3, 1), np.float32)})
    with pytest.raises(ValueError):
        load_jax_params(tm, bad)


def test_nerf_matches_jax():
    rng.set_seed(0)
    jax_mlp._INIT_COUNTER[0] = 0
    ff = {"module": "network.model.FourierFeatures", "n_freq_bands": 6}
    cfg = {"module": "network.model.Nerf", "pos_embedding": ff,
           "dir_embedding": dict(ff, n_freq_bands=2), "depth": 4, "width": 64, "skips": [2]}
    jm = jax_util.instantiate(jax_util.EasyDict(cfg))["model"]
    tm = instantiate(cfg, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params))
    pos, dirs, prm = _inputs(100, n_prm=0, seed=7)
    c_j, d_j = (np.asarray(v) for v in jm.apply(jm.params, pos, dirs, prm))
    args = (torch.tensor(pos), torch.tensor(dirs), torch.tensor(prm))
    with torch.no_grad():
        c_f, d_f = tm(*args)
    c_i, d_i = tm.infer(*args)
    for got, want in ((c_f, c_j), (d_f, d_j), (c_i, c_j), (d_i, d_j)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


JAX_CASES = {
    "test_fused_plain_matches_pallas_interpret[carpet_width]":
        lambda: _jax_pallas({}, 7, 5, weights_from="bench"),
    "test_fused_plain_matches_pallas_interpret[param_mlp_geo_only]":
        lambda: _jax_pallas(GEO_ONLY, 2, 5),
    **{f"test_tf32x3_rehearsal_matches_pallas_interpret[{topology}]":
       (lambda topology=topology: _jax_pallas(TOPOLOGIES[topology],
                                              sum(TOPOLOGIES[topology]["n_parameters"]), 11,
                                              weights_from=topology))
       for topology in TOPOLOGIES},
}
