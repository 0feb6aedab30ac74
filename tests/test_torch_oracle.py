"""nerftex_torch's host oracle (instancing/oracle.py), Scene.get_parameters,
sample_texture and native.ray_mesh_first_hit against the JAX package's, on
the same inputs: discrete outputs equal, floats within 1e-6.  Then the
port's device instancer (on the CPU, through its kernels' plain versions)
against the port's oracle at the limits tests/test_device_instancer.py
pins, and a mutated oracle that the comparison must catch."""

import copy
import os

import numpy as np
import pytest
import torch

from nerftex_torch.instancing import native
from nerftex_torch.instancing import oracle
from nerftex_torch.instancing.device import DeviceInstancer
from nerftex_torch.instancing.scene import (Scene, SceneMesh, closest_point_on_mesh,
                                            closest_point_triangles, sample_texture)
from nerftex_torch.utils import jax_rng

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = os.path.join(ROOT, "meshes")
FLOAT_TOL = 1e-6
CPU = torch.device("cpu")


def _jax():
    from nerftex_tpu.instancing import oracle as jax_oracle
    from nerftex_tpu.instancing import scene as jax_scene

    return jax_oracle, jax_scene


def _floor(z, half=5.0):
    V = np.array([[-half, -half, z], [half, -half, z], [half, half, z], [-half, half, z]],
                 np.float32)
    return V, np.array([[0, 1, 2], [0, 2, 3]], np.int32)


def _translate(dx=0.0, dy=0.0, dz=0.0):
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = [dx, dy, dz]
    return m


def _down(n, z=5.0, spread=0.3, seed=0):
    rs = np.random.RandomState(seed)
    o = np.concatenate([rs.uniform(-spread, spread, (n, 2)), np.full((n, 1), z)], -1)
    return o.astype(np.float32), np.tile(np.float32([0, 0, -1.0]), (n, 1))


def _with_down(o, d, n=3, seed=0):
    """The scene test's own ray and n more straight down through the boxes."""
    o2, d2 = _down(n, seed=seed)
    return np.concatenate([o, o2]), np.concatenate([d, d2])


# The six scenes of tests/test_scene.py's oracle tests, each built with
# either package's Scene and SceneMesh: (scene, rays_o, rays_d, parameters,
# n_pts, step).
def _single_box(S, M):
    scene = S(b_0=[-0.5, -0.5, 0.0], b_1=[0.5, 0.5, 0.5])
    scene.add_instance(np.eye(4, dtype=np.float32))
    o, d = _with_down(np.float32([[0, 0, 5.0]]), np.float32([[0, 0, -1.0]]))
    return scene, o, d, np.zeros((len(o), 0), np.float32), 64, 0.05


def _two_disjoint_boxes(S, M):
    scene = S(b_0=[-0.5] * 3, b_1=[0.5] * 3)
    scene.add_instance(np.eye(4, dtype=np.float32))
    scene.add_instance(_translate(dz=2.0))
    o, d = _with_down(np.float32([[0, 0, 5.0]]), np.float32([[0, 0, -1.0]]))
    return scene, o, d, np.zeros((len(o), 0), np.float32), 128, 0.1


def _mesh_terminator(S, M):
    scene = S(b_0=[-0.5] * 3, b_1=[0.5] * 3)
    scene.add_instance(np.eye(4, dtype=np.float32))
    scene.base_mesh = M(*_floor(-2.0))
    o, d = _with_down(np.float32([[0, 0, 5.0]]), np.float32([[0, 0, -1.0]]))
    return scene, o, d, np.zeros((len(o), 0), np.float32), 64, 0.1


def _mesh_cut(S, M):
    scene = S(b_0=[-0.5] * 3, b_1=[0.5] * 3)
    scene.add_instance(np.eye(4, dtype=np.float32))
    scene.base_mesh = M(*_floor(0.0))
    o, d = _with_down(np.float32([[0, 0, 5.0]]), np.float32([[0, 0, -1.0]]))
    return scene, o, d, np.zeros((len(o), 0), np.float32), 64, 0.05


def _overlap(method):
    def build(S, M):
        scene = S(b_0=[-0.5] * 3, b_1=[0.5] * 3, instance_sampling_method=method)
        scene.add_instance(np.eye(4, dtype=np.float32))
        # Co-located for random (the scene test's); offset for the blend, so
        # that the weights differ from sample to sample.
        scene.add_instance(np.eye(4, dtype=np.float32) if method == "random"
                           else _translate(dx=0.3))
        o, d = _with_down(np.float32([[0.15, 0, 5.0]]), np.float32([[0, 0, -1.0]]))
        return scene, o, d, np.zeros((len(o), 0), np.float32), 32, 0.1 if method == "random" \
            else 0.05
    return build


def _shadowing(S, M):
    scene = S(b_0=[-0.5] * 3, b_1=[0.5] * 3, cast_shadow_rays=True, textures=["light"])
    scene.add_instance(np.eye(4, dtype=np.float32))
    scene.add_instance(_translate(dz=3.0))
    o = np.float32([[5.0, 0, 0], [5.0, 2.0, 0], [5.0, 0.2, 0.3]])
    d = np.tile(np.float32([-1.0, 0, 0]), (3, 1))
    return scene, o, d, np.tile(np.float32([0, 0, 1.0]), (3, 1)), 32, 0.1


SCENES = {
    "single_box": _single_box,
    "two_disjoint_boxes": _two_disjoint_boxes,
    "mesh_terminator_and_occlusion": _mesh_terminator,
    "mesh_cut": _mesh_cut,
    "overlap_random": _overlap("random"),
    "overlap_nearest_blend": _overlap("nearest_blend"),
    "shadowing": _shadowing,
}


def _assert_outputs_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=FLOAT_TOL, err_msg=k)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_oracle_matches_jax_oracle(name):
    """All ten outputs on each of test_scene.py's scenes, the draws from
    the same RandomState seed."""
    jax_oracle, jax_scene = _jax()
    scene, o, d, prm, n_pts, step = SCENES[name](Scene, SceneMesh)
    jscene, *_ = SCENES[name](jax_scene.Scene, jax_scene.SceneMesh)
    got = oracle.get_model_input(scene, o, d, prm, n_pts, step, np.random.RandomState(3))
    want = jax_oracle.get_model_input(jscene, o, d, prm, n_pts, step, np.random.RandomState(3))
    assert want["hit"].any()
    _assert_outputs_equal(got, want)
    if name == "shadowing":
        # The blocker shadows the lower box: the local light points down.
        n = int((got["dists"][0] > 0).sum())
        np.testing.assert_allclose(got["parameters"][0, :n], np.tile([0, 0, -1.0], (n, 1)))


def _rotated_instances(S, n=12, seed=5, **kw):
    scene = S(b_0=[-0.5] * 3, b_1=[0.5] * 3, **kw)
    rs = np.random.RandomState(seed)
    for _ in range(n):
        u, _, vt = np.linalg.svd(rs.randn(3, 3))
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = (u @ vt) * 0.4
        m[:3, 3] = rs.uniform(-1, 1, 3)
        scene.add_instance(m)
    return scene


def test_geometry_queries_match_jax_oracle():
    """ray_box_events over rotated instances, mesh_first_hit and
    is_shadowed over them and a cloth floor, and shade_mesh on a textured
    auxiliary mesh, on random points and directions."""
    jax_oracle, jax_scene = _jax()
    scenes = []
    for S, M in ((Scene, SceneMesh), (jax_scene.Scene, jax_scene.SceneMesh)):
        scene = _rotated_instances(S, cast_shadow_rays=True, textures=["light"])
        scene.base_mesh = M(*_floor(-1.5))
        scene.add_mesh(os.path.join(MESHES, "cloth_mesh.ply"),
                       os.path.join(MESHES, "checkerboard.png"))
        scene.aux_meshes[0].V[:, 2] -= 1.0
        scenes.append(scene)
    scene, jscene = scenes
    rs = np.random.RandomState(0)
    pts = rs.uniform(-1.5, 1.5, (120, 3)).astype(np.float32)
    dirs = rs.randn(120, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    n_events = n_shadowed = n_hits = 0
    for p, d in zip(pts, dirs):
        got, want = oracle.ray_box_events(scene, p, d), jax_oracle.ray_box_events(jscene, p, d)
        assert got == want
        n_events += len(got[0])
        shadowed = oracle.is_shadowed(scene, p, d)
        assert shadowed == jax_oracle.is_shadowed(jscene, p, d)
        n_shadowed += shadowed
        for mesh, jmesh in ((scene.base_mesh, jscene.base_mesh),
                            (scene.aux_meshes[0], jscene.aux_meshes[0])):
            hit, jhit = oracle.mesh_first_hit(mesh, p, d), jax_oracle.mesh_first_hit(jmesh, p, d)
            assert (hit is None) == (jhit is None)
            if hit is None:
                continue
            n_hits += 1
            assert hit[1] == jhit[1]
            np.testing.assert_allclose(hit[0], jhit[0], rtol=0, atol=FLOAT_TOL)
            np.testing.assert_allclose(hit[2], jhit[2], rtol=0, atol=FLOAT_TOL)
            hit_pt = p + hit[0] * d
            np.testing.assert_allclose(
                oracle.shade_mesh(scene, mesh, hit_pt, hit[1], hit[2], d),
                jax_oracle.shade_mesh(jscene, jmesh, hit_pt, jhit[1], jhit[2], d),
                rtol=0, atol=FLOAT_TOL)
    # Every branch was taken.
    assert n_events > 20 and 0 < n_shadowed < len(pts) and n_hits > 20


def _cloth_scene(S, **kw):
    scene = S(b_0=[-1.4, -1.2, -0.1], b_1=[1.2, 1.2, 1.8],
              textures=[os.path.join(MESHES, "smooth_checkerboard.png"), "", "", "", "light"],
              instance_sampling_method="nearest", seed=0, **kw)
    scene.distribute_instances_on_mesh(os.path.join(MESHES, "cloth_mesh.ply"), 0.09,
                                       os.path.join(MESHES, "cloth_anchor_points.ply"))
    return scene


@pytest.fixture(scope="module")
def cloth():
    return _cloth_scene(Scene)


def test_get_parameters_and_sample_texture_match_jax(cloth):
    _, jax_scene = _jax()
    jscene = _cloth_scene(jax_scene.Scene)
    rs = np.random.RandomState(1)
    pts = np.concatenate([rs.uniform(-0.8, 0.8, (24, 2)), rs.uniform(-0.1, 0.3, (24, 1))],
                         -1).astype(np.float32)
    prm = np.float32([0.9, 1, 1, 0.1, 0, 0, -1.0])
    got = np.stack([cloth.get_parameters(p, prm) for p in pts])
    want = np.stack([jscene.get_parameters(p, prm) for p in pts])
    np.testing.assert_allclose(got, want, rtol=0, atol=FLOAT_TOL)
    assert np.ptp(got[:, 0]) > 0.1 and np.array_equal(got[:, 1:], want[:, 1:])
    uv = rs.uniform(-0.1, 1.1, (64, 2)).astype(np.float32)
    for ch, jch in zip(cloth.texture_channels, jscene.texture_channels):
        np.testing.assert_allclose(sample_texture(ch, uv), jax_scene.sample_texture(jch, uv),
                                   rtol=0, atol=FLOAT_TOL)


def test_native_ray_mesh_first_hit_matches_oracle_and_jax():
    """tests/test_native.py's ray casts: the port's binding against its
    oracle's mesh_first_hit and against the JAX package's binding."""
    if native.get_lib() is None:
        pytest.skip("the native library cannot be built here")
    from nerftex_tpu.instancing import native as jax_native

    rs = np.random.RandomState(3)
    mesh = SceneMesh(rs.randn(120, 3).astype(np.float32),
                     np.arange(120, dtype=np.int32).reshape(40, 3))
    rs = np.random.RandomState(2)
    rays_o = rs.randn(30, 3).astype(np.float32) * 3
    rays_d = rs.randn(30, 3).astype(np.float32)
    # and 30 rays aimed at triangles' centroids
    aim = mesh.V[mesh.F[rs.randint(0, 40, 30)]].mean(1) + rs.randn(30, 3).astype(np.float32) * 0.1
    start = rs.randn(30, 3).astype(np.float32) * 3
    rays_o, rays_d = np.concatenate([rays_o, start]), np.concatenate([rays_d, aim - start])
    rays_d /= np.linalg.norm(rays_d, axis=-1, keepdims=True)
    v0 = mesh.V[mesh.F[:, 0]]
    e1, e2 = mesh.V[mesh.F[:, 1]] - v0, mesh.V[mesh.F[:, 2]] - v0
    t, tri, u, v = native.ray_mesh_first_hit(rays_o, rays_d, v0, e1, e2)
    n_hit = 0
    for i in range(len(rays_o)):
        hit = oracle.mesh_first_hit(mesh, rays_o[i], rays_d[i])
        if hit is None:
            assert np.isinf(t[i]) and tri[i] == -1
            continue
        n_hit += 1
        assert abs(t[i] - hit[0]) < 1e-4 and tri[i] == hit[1]
        np.testing.assert_allclose([u[i], v[i]], hit[2][1:], atol=1e-4)
    assert n_hit > 20
    if jax_native.get_lib() is not None:
        for got, want in zip((t, tri, u, v),
                             jax_native.ray_mesh_first_hit(rays_o, rays_d, v0, e1, e2)):
            np.testing.assert_array_equal(got, want)


# -- the device instancer against the oracle ---------------------------------


def _device(scene, **kw):
    kw = dict(dict(max_hits=8, ray_block=4), **kw)
    return DeviceInstancer(scene, CPU, **kw)


def _run(dev, o, d, prm, n, step, key=0):
    out = dev.get_model_input(o, d, prm, n, step, key=jax_rng.key(key))
    return {k: v.numpy() for k, v in out.items() if not k.startswith("overflow")}


def _compare(scene, o, d, prm, n, step, atol=1e-4, **kw):
    """tests/test_device_instancer.py _compare: the device (its own draws)
    against the oracle on the RNG-independent outputs, the t grids re-based
    to each ray's first sample."""
    out_d = _run(_device(scene, **kw), o, d, prm, n, step)
    out_o = oracle.get_model_input(scene, o, d, prm, n, step)
    np.testing.assert_array_equal(out_d["hit"], out_o["hit"])
    for k in ("dists", "alpha_last", "color_last"):
        np.testing.assert_allclose(out_d[k], out_o[k], atol=atol, err_msg=k)
    for r in range(len(o)):
        nd, no = int((out_d["dists"][r] > 0).sum()), int((out_o["dists"][r] > 0).sum())
        assert nd == no
        if nd > 1:
            np.testing.assert_allclose(np.diff(out_d["t"][r, :nd]), np.diff(out_o["t"][r, :no]),
                                       atol=atol)
    return out_d, out_o


def test_device_matches_oracle_single_box():
    scene = Scene(b_0=[-0.5] * 3, b_1=[0.5] * 3)
    scene.add_instance(np.eye(4, dtype=np.float32))
    o, d = _down(4)
    _compare(scene, o, d, np.zeros((4, 0), np.float32), 64, 0.05)


def test_device_matches_oracle_disjoint_boxes():
    scene = Scene(b_0=[-0.5] * 3, b_1=[0.5] * 3)
    for dz in (0.0, 2.0, 3.5):
        scene.add_instance(_translate(dz=dz))
    o, d = _down(6)
    out_d, out_o = _compare(scene, o, d, np.zeros((6, 0), np.float32), 128, 0.05)
    for r in range(6):
        n = int((out_d["dists"][r] > 0).sum())
        ids_d, ids_o = out_d["instance_id"][r, :n], out_o["instance_id"][r, :n]
        assert abs((ids_d == 2).sum() - (ids_o == 2).sum()) <= 1
        assert abs((ids_d == 0).sum() - (ids_o == 0).sum()) <= 1


def test_device_matches_oracle_rotated_instances():
    scene = _rotated_instances(Scene, n=5)
    o, d = _down(8, spread=0.8, seed=2)
    out_d, _ = _compare(scene, o, d, np.zeros((8, 0), np.float32), 96, 0.03)
    valid = out_d["dists"] > 0
    pts = out_d["pts"][valid]
    assert np.all(pts >= scene.b_0 - 1e-3) and np.all(pts <= scene.b_1 + 1e-3)


def test_device_use_mean_distance_matches_oracle():
    scene = Scene(b_0=[-0.5] * 3, b_1=[0.5] * 3, use_mean_distance=True)
    scene.add_instance(np.eye(4, dtype=np.float32))
    o, d = _down(4)
    _compare(scene, o, d, np.zeros((4, 0), np.float32), 64, 0.05, atol=2e-3)


def test_device_mesh_terminator_matches_oracle():
    scene = Scene(b_0=[-0.5] * 3, b_1=[0.5] * 3)
    scene.add_instance(np.eye(4, dtype=np.float32))
    scene.base_mesh = SceneMesh(*_floor(-2.0))
    o, d = _down(4)
    out_d, _ = _compare(scene, o, d, np.zeros((4, 0), np.float32), 64, 0.05)
    assert np.all(out_d["alpha_last"] == 1.0)


def test_device_shadowing_matches_oracle():
    scene = _shadowing(Scene, SceneMesh)[0]
    o = np.float32([[5.0, 0, 0], [5.0, 2.0, 0]])
    d = np.tile(np.float32([-1.0, 0, 0]), (2, 1))
    prm = np.tile(np.float32([0, 0, 1.0]), (2, 1))
    out_d, out_o = _compare(scene, o, d, prm, 32, 0.1, ray_block=2, max_hits=4)
    n = int((out_d["dists"][0] > 0).sum())
    assert n > 0
    np.testing.assert_allclose(out_d["parameters"][0, :n, :3], out_o["parameters"][0, :n, :3],
                               atol=1e-5)
    np.testing.assert_allclose(out_d["parameters"][0, :n, :3], np.tile([0, 0, -1.0], (n, 1)))


def test_device_point_light_strength_matches_oracle():
    """With the oracle's offsets at the device's (0.5), each sample's
    inverse-square strength and light direction against the oracle's."""
    scene = Scene(b_0=[-0.5] * 3, b_1=[0.5] * 3, textures=["point"])
    scene.add_instance(np.eye(4, dtype=np.float32))
    o, d = _down(2, spread=0.2)
    prm = np.tile(np.float32([10.0, 0, 0, 3.0]), (2, 1))
    out_d = _run(_device(scene, max_hits=4, ray_block=2, deterministic_offset=True), o, d, prm,
                 32, 0.1)
    out_o = oracle.get_model_input(scene, o, d, prm, 32, 0.1, _HalfOffsets(0))
    valid = out_d["dists"] > 0
    assert valid.sum() > 10
    np.testing.assert_allclose(out_d["t"][valid], out_o["t"][valid], atol=1e-5)
    np.testing.assert_allclose(out_d["parameters"][valid][:, 0], out_o["parameters"][valid][:, 0],
                               rtol=1e-4)
    np.testing.assert_allclose(out_d["parameters"][valid][:, 1:], out_o["parameters"][valid][:, 1:],
                               atol=1e-5)


def test_aux_mesh_terminator_shading_matches_oracle():
    scene = Scene(b_0=[-0.5] * 3, b_1=[0.5] * 3, textures=["light"])
    scene.add_instance(np.eye(4, dtype=np.float32))
    scene.base_mesh = SceneMesh(*_floor(-9.0, half=9.0))
    scene.add_mesh(os.path.join(MESHES, "cloth_mesh.ply"), os.path.join(MESHES, "checkerboard.png"))
    scene.aux_meshes[0].V[:, 2] -= 2.0
    o = np.float32([[0.1, 0.05, 5.0], [-0.2, 0.1, 5.0]])
    d = np.tile(np.float32([0, 0, -1.0]), (2, 1))
    prm = np.tile(np.float32([0, 0, 1.0]), (2, 1))
    out_d = _run(_device(scene, max_hits=4, ray_block=2), o, d, prm, 32, 0.1)
    out_o = oracle.get_model_input(scene, o, d, prm, 32, 0.1)
    np.testing.assert_allclose(out_d["alpha_last"], out_o["alpha_last"], atol=1e-5)
    np.testing.assert_allclose(out_d["color_last"], out_o["color_last"], atol=2e-2)
    assert out_d["color_last"].max() > 0.05


class _HalfOffsets(np.random.RandomState):
    """The oracle's generator with every stratified offset at 0.5, the
    device's deterministic_offset."""

    def uniform(self, low=0.0, high=1.0, size=None):
        return low + 0.5 * (high - low)


def _texture_rays(n=8):
    rs = np.random.RandomState(0)
    o = np.concatenate([rs.uniform(-0.5, 0.5, (n, 2)), np.full((n, 1), 4.0)], -1)
    return (o.astype(np.float32), np.tile(np.float32([0, 0, -1.0]), (n, 1)),
            np.tile(np.float32([1.0, 1, 1, 0.1, 0, 0, -1.0]), (n, 1)))


def _closest_over(scene, candidates, pt, prm):
    """Texture slot 0 at the host's exact closest point over the given
    base-mesh triangles."""
    mesh = scene.base_mesh
    tris = mesh.F[candidates]
    points, bary = closest_point_triangles(pt, *(mesh.V[tris[:, k]] for k in range(3)))
    j = int(np.argmin(np.linalg.norm(points - pt, axis=-1)))
    uv = bary[j] @ mesh.UV[tris[j]]
    return float(prm[0] * sample_texture(scene.texture_channels[0], uv[None])[0])


@pytest.mark.parametrize("lookup", ["closest", "jacobian"])
def test_device_texture_parameters_match_get_parameters(cloth, lookup):
    """Texture slot 0 of eight samples a ray against Scene.get_parameters
    at the sample's point: "jacobian" at tests/test_device_instancer.py's
    mean 0.06 and max 0.25; "closest" within 1e-4, where the exact closest
    triangle is not among the instance's candidates (a candidate miss) of
    the host's closest point over those candidates."""
    o, d, prm = _texture_rays()
    out = _run(_device(cloth, max_hits=32, ray_block=8, texture_lookup=lookup), o, d, prm, 128,
               0.02)
    errs, misses = [], 0
    for r in range(len(o)):
        n = int((out["dists"][r] > 0).sum())
        for i in range(0, n, max(1, n // 8)):
            pt = o[r] + float(out["t"][r, i]) * d[r]
            want = float(cloth.get_parameters(pt, prm[r])[0])
            cand = cloth.instance_tri_candidates[out["instance_id"][r, i]]
            if lookup == "closest" and closest_point_on_mesh(pt, cloth.base_mesh)[0] not in cand:
                misses += 1
                want = _closest_over(cloth, cand, pt, prm[r])
            errs.append(abs(float(out["parameters"][r, i, 0]) - want))
    assert len(errs) > 60 and misses <= 0.05 * len(errs)
    if lookup == "closest":
        assert max(errs) < 1e-4, errs
    else:
        assert np.mean(errs) < 0.06 and max(errs) < 0.25, errs


def _nearest_mismatches(scene, out_d, out_o, o, d):
    """Samples whose nearest pick differs from the oracle's beyond a tie:
    both anchors equidistant within the device formula's float32 error
    (tests/test_torch_instancer.py _near_ties)."""
    origins = np.asarray(scene.origins, np.float64)
    r, s = np.nonzero((out_d["instance_id"] != out_o["instance_id"]) & (out_d["dists"] > 0))
    p = o[r].astype(np.float64) + d[r] * out_d["t"][r, s, None].astype(np.float64)
    da = np.sum((p - origins[out_d["instance_id"][r, s]]) ** 2, -1)
    db = np.sum((p - origins[out_o["instance_id"][r, s]]) ** 2, -1)
    terms = np.sum((o[r].astype(np.float64) - origins[out_d["instance_id"][r, s]]) ** 2, -1) \
        + out_d["t"][r, s].astype(np.float64) ** 2
    return int((np.abs(da - db) > 64 * 2.0**-24 * terms).sum())


def _farthest(scene, active, pt, rng):
    """A mutant _select_instance whose nearest picks the farthest anchor."""
    active = sorted(active)
    dists = [np.linalg.norm(pt - scene.origins[i]) for i in active]
    return active[int(np.argmax(dists))], 1.0


@pytest.mark.parametrize("mutant", [False, True])
def test_nearest_comparison_catches_a_farthest_pick(cloth, monkeypatch, mutant):
    """The device's nearest picks at the oracle's own arc positions equal
    the oracle's up to ties; an oracle that picks the farthest instance
    fails that comparison."""
    o, d, prm = _texture_rays(16)
    out_d = _run(_device(cloth, max_hits=32, ray_block=16, deterministic_offset=True), o, d, prm,
                 256, 0.01)
    if mutant:
        monkeypatch.setattr(oracle, "_select_instance", _farthest)
    view = copy.copy(cloth)
    view.texture_parameter_idxs = []
    out_o = oracle.get_model_input(view, o, d, prm, 256, 0.01, _HalfOffsets(0))
    valid = out_d["dists"] > 0
    assert valid.sum() > 200
    np.testing.assert_allclose(out_d["t"][valid], out_o["t"][valid], atol=1e-5)
    bad = _nearest_mismatches(cloth, out_d, out_o, o, d)
    if mutant:
        assert bad > 0.1 * valid.sum()
    else:
        assert bad == 0
