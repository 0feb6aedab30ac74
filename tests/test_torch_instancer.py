"""nerftex_torch's device instancer against the JAX DeviceInstancer on the
carpet scene (cloth mesh, 900 patches, checkerboard, nearest overlap
selection, directional light), on 64 rays of the bench view with
deterministic offsets: discrete tables exact (the nearest pick up to
knife-edge ties), float tables within a few float32 ulps of their
magnitude; and the port's own culled, unculled, sorted and dense paths
agree exactly."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerftex_tpu.instancing.device import DeviceInstancer as JaxDeviceInstancer
from nerftex_tpu.instancing.scene import Scene as JaxScene
from nerftex_torch.instancing.instancer import Instancer
from nerftex_torch.ops.rays import frame_rays
from nerftex_torch.utils import jax_rng

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _jax_reference import recorded  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULE = "test_torch_instancer"
MESH = os.path.join(ROOT, "meshes", "cloth_mesh.ply")
ANCHORS = os.path.join(ROOT, "meshes", "cloth_anchor_points.ply")
SCENE_KW = dict(
    b_0=[-1.4, -1.2, -0.1], b_1=[1.2, 1.2, 1.8],
    textures=[os.path.join(ROOT, "meshes", "smooth_checkerboard.png"), "", "", "", "light"],
    jitter_amount=1.0, instance_sampling_method="nearest", seed=0,
)
DEV_KW = dict(max_hits=16, ray_block=32, max_steps_per_ray=320, cull_budget=448,
              tri_cull_budget=384, deterministic_offset=True)
N_SAMPLES, STEP = 1024, 0.002


def _rays():
    """64 rays of the 512x512 bench view, an 8x8 grid over the carpet."""
    data = frame_rays(512, 512, np.array([0.47, -0.65, 0.6]) * 6.0, 0.55,
                      [1, 1, 1, 0.1, 0, 0, 1.0])
    rows, cols = np.meshgrid(np.arange(200, 328, 16), np.arange(180, 308, 16), indexing="ij")
    idx = (rows * 512 + cols).reshape(-1)
    o, d = data["rays_o"][0][idx], data["rays_d"][0][idx]
    p = np.repeat(data["parameters"], len(idx), 0)
    return o, d, p


@pytest.fixture(scope="module")
def setup():
    inst = Instancer(mesh_path=MESH, patch_scale=0.09, patch_origins_path=ANCHORS,
                     device="cpu", **SCENE_KW, **DEV_KW)
    return inst.device_instancer, _rays()


def _jax_instancer():
    js = JaxScene(**SCENE_KW)
    js.distribute_instances_on_mesh(MESH, 0.09, ANCHORS)
    return JaxDeviceInstancer(js, **DEV_KW)


PER_RAY_KEYS = ("hit", "n_steps", "inst_idx", "kvalid", "tiny", "tk0", "tk1", "sel_a", "sel_b",
                "t_offset", "alpha_last", "light_dir_w", "cum_incl", "arc_corr", "total",
                "overflow_hits", "overflow_steps")


def _jax_per_ray():
    """The JAX per-ray stage's tables of each 32-ray block:
    "<first ray>/<table>"."""
    jd = _jax_instancer()
    o, d, p = _rays()
    out = {}
    for i in range(0, len(o), 32):
        sl = slice(i, i + 32)
        jr = jd._per_ray(jnp.asarray(o[sl]), jnp.asarray(d[sl]), jnp.asarray(p[sl]), 320, STEP,
                         jax.random.key(0))
        out.update({f"{i}/{k}": np.asarray(jr[k]) for k in PER_RAY_KEYS})
    return out


def _jax_model_input():
    o, d, p = _rays()
    jo = _jax_instancer().get_model_input(o, d, p, N_SAMPLES, STEP, key=jax.random.key(0))
    return {k: np.asarray(jo[k]) for k in ("hit", "dists", "alpha_weight", "alpha_last",
                                            "color_last", "t", "instance_id", "pts", "rays_d",
                                            "parameters")}


def _assert_float(got, want, name, ulps=8, scale=None):
    """Within ``ulps`` float32 ulps of ``scale`` (default: the largest
    magnitude in ``want``, at least 1)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want), err_msg=name)
    fin = np.isfinite(want)
    if scale is None:
        scale = max(1.0, float(np.abs(want[fin]).max())) if fin.any() else 1.0
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=ulps * 2**-23 * scale,
                               err_msg=name)


def test_per_ray_tables_match_jax(setup):
    td, (o, d, p) = setup
    recording = recorded(MODULE, "test_per_ray_tables_match_jax")
    for i in range(0, len(o), 32):
        sl = slice(i, i + 32)
        jr = {k: recording[f"{i}/{k}"] for k in PER_RAY_KEYS}
        tr = td._per_ray(torch.tensor(o[sl]), torch.tensor(d[sl]), torch.tensor(p[sl]), 320,
                         STEP, torch.full((32,), 0.5))
        for k in ("hit", "n_steps", "inst_idx", "kvalid", "tiny"):
            np.testing.assert_array_equal(tr[k].numpy(), np.asarray(jr[k]), err_msg=k)
        # Arc lengths are sums of differences of world t (|t| <= T_FAR clip,
        # ~8 here): their error scale is that of t, not their own.
        t_scale = float(np.abs(np.asarray(jr["tk1"])[np.asarray(jr["kvalid"])]).max())
        for k in ("tk0", "tk1", "sel_a", "sel_b", "t_offset", "alpha_last", "light_dir_w"):
            _assert_float(tr[k].numpy(), jr[k], k)
        for k in ("cum_incl", "arc_corr", "total"):
            _assert_float(tr[k].numpy(), jr[k], k, scale=t_scale)
        assert int(tr["overflow_hits"]) == int(jr["overflow_hits"])
        assert int(tr["overflow_steps"]) == int(jr["overflow_steps"]) == 0
    assert tr["hit"].any() and int(tr["n_steps"].max()) > 0


def _near_ties(td, o, d, t, inst_a, inst_b):
    """For samples where two implementations picked different instances:
    True where the two anchors are equidistant from the sample point up to
    the float32 error of the nearest-pick formula d2 = a + 2 t b + t^2,
    whose terms (|o - c|^2 and t^2, ~10) cancel to d2 (~1e-3)."""
    c = td.ds.origins.double().numpy()
    p = o.astype(np.float64) + d.astype(np.float64) * t.astype(np.float64)[:, None]
    da = np.sum((p - c[inst_a]) ** 2, -1)
    db = np.sum((p - c[inst_b]) ** 2, -1)
    terms = np.sum((o.astype(np.float64) - c[inst_a]) ** 2, -1) + t.astype(np.float64) ** 2
    return np.abs(da - db) <= 64 * 2.0**-24 * terms


def test_model_input_matches_jax(setup):
    td, (o, d, p) = setup
    jo = recorded(MODULE, "test_model_input_matches_jax")
    to = td.get_model_input(o, d, p, N_SAMPLES, STEP, key=jax_rng.key(0))
    np.testing.assert_array_equal(to["hit"].numpy(), np.asarray(jo["hit"]))
    valid = to["dists"].numpy() > 0
    assert valid.sum() > 5000
    for k in ("alpha_weight", "alpha_last", "color_last"):
        _assert_float(to[k].numpy(), jo[k], k)
    # Sample t and the last spacing derive from arc lengths: world-t scale.
    t_scale = float(np.abs(np.asarray(jo["t"])).max())
    for k in ("t", "dists"):
        _assert_float(to[k].numpy(), jo[k], k, scale=t_scale)

    # The nearest pick is exact except on knife edges: samples whose two
    # nearest anchors tie within the pick formula's float32 cancellation
    # error, where last-ulp differences of its inputs (XLA contracts fmas,
    # PyTorch rounds each operation) decide (ROADMAP Queue 3).
    got_id, want_id = to["instance_id"].numpy(), np.asarray(jo["instance_id"])
    r, s = np.nonzero(got_id != want_id)
    assert len(r) <= 1e-3 * valid.sum()
    assert _near_ties(td, o[r], d[r], to["t"].numpy()[r, s], got_id[r, s], want_id[r, s]).all()

    # Local frames multiply world coordinates (|x| ~ 4) by 1/patch_scale.
    same = got_id == want_id
    for k in ("pts", "rays_d", "parameters"):
        _assert_float(to[k].numpy()[same], np.asarray(jo[k])[same], k, ulps=64)


def test_culls_are_exact(setup):
    """The fan culls are speed tiers: the same tables with them off."""
    td, (o, d, p) = setup
    culled = td.get_model_input(o, d, p, N_SAMPLES, STEP, key=jax_rng.key(0))
    budgets = (td.cull_budget, td.tri_cull_budget)
    td.cull_budget = td.tri_cull_budget = 0
    try:
        full = td.get_model_input(o, d, p, N_SAMPLES, STEP, key=jax_rng.key(0))
    finally:
        td.cull_budget, td.tri_cull_budget = budgets
    for k, v in culled.items():
        assert torch.equal(v, full[k]), k


def test_sorted_blocks_equal_dense_grid(setup):
    """render_grid_sorted hands each sorted block's model input to the
    shading callback; padded back to the dense grid it equals
    get_model_input exactly."""
    td, (o, d, p) = setup
    cap = min(N_SAMPLES, td.max_steps_per_ray)
    keys = ("pts", "rays_d", "t", "dists", "parameters", "instance_id", "alpha_weight")

    def pad(v):
        widths = [0, 0] * (v.dim() - 2) + [0, cap - v.shape[1]]
        return torch.nn.functional.pad(v, widths)

    def shade_block(inst, extra, key):
        valid = inst["dists"] > 0
        out = []
        for k in keys:
            m = valid if inst[k].dim() == 2 else valid[..., None]
            out.append(pad(torch.where(m, inst[k], torch.zeros_like(inst[k]))))
        return tuple(out) + (inst["hit"],)

    def empty_block(ray, extra):
        n = ray["hit"].shape[0]
        zeros = [torch.zeros((n, cap) + ((3,) if k in ("pts", "rays_d") else (7,)
                                         if k == "parameters" else ()),
                             dtype=torch.int32 if k == "instance_id" else torch.float32)
                 for k in keys]
        return tuple(zeros) + (ray["hit"],)

    outs, aux = td.render_grid_sorted(o, d, p, N_SAMPLES, STEP, shade_block,
                                      key=jax_rng.key(0), empty_block=empty_block)
    dense = td.get_model_input(o, d, p, N_SAMPLES, STEP, key=jax_rng.key(0))
    valid = dense["dists"] > 0
    for k, got in zip(keys + ("hit",), outs):
        want = dense[k]
        if k != "hit":
            m = valid if want.dim() == 2 else valid[..., None]
            want = torch.where(m, want, torch.zeros_like(want))
        assert torch.equal(got, want), k
    assert torch.equal(aux["hit"], dense["hit"])


@pytest.mark.parametrize("pallas_selk", [False, True])
def test_pallas_selk_is_ignored(setup, monkeypatch, pallas_selk):
    """The port has no pallas_selk knob: an Instancer built with either
    value resolves every pick through kernels.selk_resolve (its plain
    version for these CPU tensors) and gives the same model input."""
    import nerftex_torch.instancing.device as device

    td, (o, d, p) = setup
    calls = []
    real = device.selk_resolve

    def counted(*args, **kwargs):
        calls.append(kwargs["method"])
        return real(*args, **kwargs)

    monkeypatch.setattr(device, "selk_resolve", counted)
    inst = Instancer(mesh_path=os.path.join(ROOT, "meshes", "cloth_mesh.ply"), patch_scale=0.09,
                     patch_origins_path=os.path.join(ROOT, "meshes", "cloth_anchor_points.ply"),
                     device="cpu", pallas_selk=pallas_selk, **SCENE_KW, **DEV_KW)
    got = inst.device_instancer.get_model_input(o, d, p, N_SAMPLES, STEP, key=jax_rng.key(0))
    assert calls and set(calls) == {"nearest"}
    want = td.get_model_input(o, d, p, N_SAMPLES, STEP, key=jax_rng.key(0))
    for k, v in got.items():
        assert torch.equal(v, want[k]), k


def _assert_render_layout(tables):
    """The layout selk_resolve.cu's windowed search relies on: in every row
    the valid hit slots are a prefix, tk0 is non-decreasing over it and
    +inf past it, and each valid slot is a finite interval tk0 < tk1.
    Returns the number of valid slots per ray."""
    kv, tk0, tk1 = tables["kvalid"], tables["tk0"], tables["tk1"]
    n = kv.sum(-1)
    assert torch.equal(kv, torch.arange(kv.shape[-1])[None, :] < n[:, None])
    assert (tk0[~kv] == float("inf")).all()
    assert (tk0[:, 1:] >= tk0[:, :-1])[kv[:, 1:]].all()
    assert torch.isfinite(tk0[kv]).all() and torch.isfinite(tk1[kv]).all()
    assert (tk0 < tk1)[kv].all()
    return n


def test_per_ray_tables_are_in_render_layout(setup):
    """The bench view's per-ray tables."""
    td, (o, d, p) = setup
    n = torch.cat([_assert_render_layout(
        td._per_ray(torch.tensor(o[i:i + 32]), torch.tensor(d[i:i + 32]),
                    torch.tensor(p[i:i + 32]), 320, STEP, torch.full((32,), 0.5)))
        for i in range(0, len(o), 32)])
    assert int(n.max()) >= 2 and int((n == 0).sum()) < len(n)


def test_plush_per_ray_tables_are_in_render_layout():
    """A 16x16 plush view at the plush frame's max_hits (128) and ray
    block cut to 64."""
    import math

    inp = np.load(os.path.join(ROOT, "tests", "torch_plush_inputs.npz"))
    angle = float(inp["angle"])
    data = frame_rays(16, 16, inp["eye"], angle, inp["parameters"], (-0.9, -0.6, -0.8),
                      (0.9, 0.8, 0.9), focal=16 / math.tan(angle / 2) / 2)
    inst = Instancer(b_0=[-1.1, -1.1, -0.2], b_1=[1.1, 1.1, 1.1],
                     textures=["", os.path.join(ROOT, "meshes", "checkerboard.png"), "light"],
                     mesh_path=os.path.join(ROOT, "meshes", "stanford_bunny.ply"),
                     patch_scale=0.04, jitter_amount=0.3, instance_sampling_method="nearest_blend",
                     max_hits=128, ray_block=64, max_steps_per_ray=1280, cull_budget=384,
                     tri_cull_budget=1024, device="cpu").device_instancer
    o, d = (torch.tensor(data[k][0]) for k in ("rays_o", "rays_d"))
    p = torch.tensor(data["parameters"]).expand(len(o), -1)
    n = torch.cat([_assert_render_layout(
        inst._per_ray(o[i:i + 64], d[i:i + 64], p[i:i + 64], 1280, 0.0005,
                      torch.full((64,), 0.5)))
        for i in range(0, len(o), 64)])
    assert int(n.max()) >= 2 and int((n == 0).sum()) < len(n)


JAX_CASES = {
    "test_per_ray_tables_match_jax": _jax_per_ray,
    "test_model_input_matches_jax": _jax_model_input,
}
