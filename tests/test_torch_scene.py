"""nerftex_torch's host scene compiler and device scene tables against the
JAX package's on meshes/cloth_mesh.ply with its anchors and the
checkerboard texture: every table must be equal."""

import os

import numpy as np
import pytest

from nerftex_tpu.instancing import ply as jax_ply
from nerftex_tpu.instancing.device import DeviceScene as JaxDeviceScene
from nerftex_tpu.instancing.scene import Scene as JaxScene
from nerftex_torch.instancing import ply, scene as scene_mod
from nerftex_torch.instancing.device import DeviceScene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = os.path.join(ROOT, "meshes", "cloth_mesh.ply")
ANCHORS = os.path.join(ROOT, "meshes", "cloth_anchor_points.ply")
SCENE_KW = dict(
    b_0=[-1.4, -1.2, -0.1], b_1=[1.2, 1.2, 1.8],
    textures=[os.path.join(ROOT, "meshes", "smooth_checkerboard.png"), "", "", "", "light"],
    jitter_amount=1.0, instance_sampling_method="nearest", seed=0,
)


@pytest.fixture(scope="module")
def scenes():
    js = JaxScene(**SCENE_KW)
    js.distribute_instances_on_mesh(MESH, 0.09, ANCHORS)
    ts = scene_mod.Scene(**SCENE_KW)
    ts.distribute_instances_on_mesh(MESH, 0.09, ANCHORS)
    return js, ts


def test_read_ply_matches(scenes):
    for path in (MESH, ANCHORS):
        a, b = jax_ply.read_ply(path), ply.read_ply(path)
        for k in ("V", "F", "N", "UV"):
            x, y = getattr(a, k), getattr(b, k)
            assert (x is None) == (y is None), k
            if x is not None:
                np.testing.assert_array_equal(x, y, err_msg=k)


def test_scene_tables_equal(scenes):
    js, ts = scenes
    assert ts.n_instances() == js.n_instances() == 900
    for k in ("forward", "inverse", "dir_inverse", "origins", "anchor_uv", "uv_jacobian",
              "instance_tri_candidates", "texture_channels"):
        np.testing.assert_array_equal(np.asarray(getattr(ts, k)), np.asarray(getattr(js, k)),
                                      err_msg=k)
    for k in ("n_parameters", "light_dir_idx", "light_strength_idx",
              "texture_parameter_idxs", "patch_scale", "patch_max_extent"):
        assert getattr(ts, k) == getattr(js, k), k
    assert (ts.n_parameters, ts.light_dir_idx) == (7, 4)
    for k in ("V", "F", "N", "UV"):
        np.testing.assert_array_equal(getattr(ts.base_mesh, k), getattr(js.base_mesh, k))


def test_device_scene_tables_equal(scenes):
    js, ts = scenes
    jd = JaxDeviceScene(js)
    td = DeviceScene(ts, "cpu")
    for k in ("inv_rot", "inv_trans", "dir_inv", "origins", "b_0", "b_1", "tri_v0", "tri_e1",
              "tri_e2", "tri_center", "tri_radius", "anchor_uv", "uv_jacobian",
              "inst_center", "inst_radius"):
        np.testing.assert_array_equal(getattr(td, k).numpy(), np.asarray(getattr(jd, k)),
                                      err_msg=k)
    assert [tuple(c.shape) for c in td.tex_channels] == jd.tex_dims == [(256, 256)]
    stack = np.asarray(jd.tex_channels)
    for i, (w, h) in enumerate(jd.tex_dims):
        np.testing.assert_array_equal(td.tex_channels[i].numpy(), stack[i, :w, :h])
    for k in ("n_instances", "n_tris", "uniform_scale", "patch_scale", "light_dir_idx",
              "light_strength_idx", "texture_parameter_idxs", "use_mean_distance"):
        assert getattr(td, k) == getattr(jd, k), k


def test_numpy_closest_points_agree_with_native(scenes):
    """The port's closest-point bake without the native library stays within
    float32 rounding of the native one (both pick the same triangles)."""
    _, ts = scenes
    mesh = ts.base_mesh
    pts = np.asarray(ts.origins, np.float32)[::37]
    native = scene_mod.closest_points_on_mesh(pts, mesh)
    rows = [scene_mod.closest_point_on_mesh(p, mesh) for p in pts]
    np.testing.assert_array_equal(native[0], [r[0] for r in rows])
    np.testing.assert_allclose(native[1], np.stack([r[1] for r in rows]), rtol=0, atol=1e-5)
