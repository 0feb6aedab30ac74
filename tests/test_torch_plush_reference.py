"""The port's plush frame (benchmark/configs/plush.json: an instance on each
of the bunny's 1,600 vertices, ``nearest_blend`` overlap picks reweighted
by 1 / p, a directional light with shadows, built as the benchmark's
plush.frames cell builds it) against the benchmark's plain reference
(benchmark/reference/blend.py) on the CPU, the kernels' plain versions in
the port.

The frame is a 16 x 16 crop of the 800 x 800 frame at the published pose,
at the silhouette of the bunny's back, handed to the renderer as a frame of
its own in ray blocks of 64, so that four sorted blocks draw their pick
uniforms; seeded random weights at the published widths, the full step
cap, and a light under which most of the crop's shadow points are blocked.
The reference renders 96 of its pixels, drawn from the seed.

- The port passes the cell's committed limits
  (benchmark/limits/plush.frames.json); the TF32 control fails them.
- Three faults planted in the port fail them: the pick forced to
  ``nearest``, the 1 / p reweighting dropped, the light's shadows ignored.
- The reference's vertex instances equal the port scene's.
"""

import contextlib
import copy
import os
import sys

import numpy as np
import pytest
import torch

from benchmark.harness import blend_session
from benchmark.harness import manifest as mf
from benchmark.harness.check_render import _premult, _ratio
from benchmark.reference.render import look_at, pixel_rays, proxy_t, straight_rgba

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_threads import one_torch_thread  # noqa: E402,F401

SEED = 2147483659
ROW, COL, SIDE = 160, 340, 16       # the crop in the 800 x 800 frame
RAY_BLOCK = 64
LIGHT_V = 0.3                       # the light's v on the config's sphere (u 0.2)
CHECKED = 96


def _light(u, v):
    z = 1 - 2 * u
    ring = np.sqrt(1 - z * z)
    return [np.cos(2 * np.pi * v) * ring, np.sin(2 * np.pi * v) * ring, z]


@pytest.fixture(scope="module")
def plush():
    """The port's session, the crop's rays and the reference's answers."""
    cfg = copy.deepcopy(mf.config(mf.load(), "plush"))
    cfg["operating_point"]["instancer"]["ray_block"] = RAY_BLOCK
    cell = blend_session.BlendSessionCell(cfg, mf.traffic("frames_blend"), SEED, "cpu")
    size = cell.height
    direction = np.asarray(cfg["camera"]["direction"])
    params = np.asarray(cfg["parameters"], np.float32)
    params[cfg["light"]["slots"]] = _light(cfg["light"]["u"], LIGHT_V)
    o, d, t, cone = cell.session.device_rays(cell.session.pose(direction,
                                                               cfg["camera"]["radius"]))
    crop = (torch.arange(ROW, ROW + SIDE)[:, None] * size
            + torch.arange(COL, COL + SIDE)[None, :]).reshape(-1)
    rays = {"rays_o": o[crop], "rays_d": d[crop], "t": t[crop], "cone_scale": cone[crop]}

    ref = blend_session.reference(cfg, cell.settings, cell.weights, cell.spec, mf.ROOT, "cpu")
    render = cfg["render"]
    loader = render["test_dataset_config"]["data_loader_config"]
    proxy = render["test_dataset_config"]["proxy_config"]
    ro, rd = pixel_rays(look_at(direction * cfg["camera"]["radius"]), size, size,
                        loader["angle"], crop, "cpu")
    tp = proxy_t(ro, rd, proxy["b_0"], proxy["b_1"])
    pixels = np.sort(np.random.default_rng([SEED, 3]).choice(SIDE * SIDE, CHECKED,
                                                              replace=False))
    want, low = (_premult(straight_rgba(*out)) for out in
                 ref.render_frame(ro, rd, tp, params, render.get("seed", 0), 0, pixels))
    yield {"cell": cell, "rays": rays, "params": params, "pixels": pixels, "want": want,
           "low": low, "ref": ref}
    cell.free()


def _port(plush):
    """The port's premultiplied RGBA at the checked pixels of the crop,
    rendered as the renderer's first frame."""
    from nerftex_torch.render.serve import straight_rgba
    from nerftex_torch.utils import rng

    r = plush["rays"]
    out = plush["cell"].session.renderer(
        rays_o=r["rays_o"][None], rays_d=r["rays_d"][None], t=r["t"][None],
        parameters=plush["params"][None], cone_scale=r["cone_scale"][None], training=False,
        key=rng.stream_key(rng.STREAM_PERTURB, 0))
    img = straight_rgba(out["color_pred"][0], out["alpha_pred"][0], SIDE, SIDE).reshape(-1, 4)
    return _premult(torch.as_tensor(img)[plush["pixels"]])


def _failed(plush, got) -> list:
    """The committed limits that ``got`` fails, with its ratios."""
    want, low = plush["want"], plush["low"]
    drawn = want[:, 3] > 0
    err = (got - want).abs().amax(-1)[drawn]
    base = (low - want).abs().amax(-1)[drawn]
    limits = mf.limits("plush.frames")
    ratios = {"median_vs_tf32": _ratio(err, base, 0.5), "p90_vs_tf32": _ratio(err, base, 0.9)}
    return [(k, v) for k, v in ratios.items() if not v <= limits[k]]


def test_the_port_passes_and_the_control_fails(plush):
    assert int((plush["want"][:, 3] > 0).sum()) >= CHECKED // 2
    assert _failed(plush, _port(plush)) == []
    assert [k for k, _ in _failed(plush, plush["low"])] == ["median_vs_tf32", "p90_vs_tf32"]


@contextlib.contextmanager
def nearest_pick(device_instancer):
    """Every overlap resolved by the nearest anchor, weight 1."""
    ds = device_instancer.ds
    ds.instance_sampling_method = "nearest"
    try:
        yield
    finally:
        ds.instance_sampling_method = "nearest_blend"


@contextlib.contextmanager
def unweighted(device_instancer):
    """The blended pick's density weight 1 / p dropped."""
    real = device_instancer._pick

    def pick(*args):
        sel_k, weight = real(*args)
        return sel_k, torch.ones_like(weight)

    device_instancer._pick = pick
    try:
        yield
    finally:
        del device_instancer._pick


@contextlib.contextmanager
def no_shadows(device_instancer):
    """The directional light's shadows ignored."""
    ds = device_instancer.ds
    ds.cast_shadow_rays = False
    try:
        yield
    finally:
        ds.cast_shadow_rays = True


@pytest.mark.parametrize("fault", [nearest_pick, unweighted, no_shadows])
def test_a_planted_fault_fails(plush, fault):
    with fault(plush["cell"].session.renderer.instancer.device_instancer):
        assert _failed(plush, _port(plush))


def test_the_reference_places_the_ports_vertex_instances(plush):
    scene = plush["cell"].session.renderer.instancer.scene
    ref = plush["ref"].scene
    assert ref.n_instances == scene.n_instances() == 1600
    np.testing.assert_allclose(ref.origins, np.asarray(scene.origins), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ref.forward, np.asarray(scene.forward), rtol=0, atol=1e-6)
