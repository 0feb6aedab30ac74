"""The plain reference against the port on the CPU (the kernels' plain
versions), at sizes a test run holds: a carpet frame, a grass frame with
shadows and a point light, and the training step.  Each run of the port
must pass the committed limits; the lower-precision control (the
reference in TF32 in the port's place) and each fault the cell can have,
planted in the port, must not."""

import contextlib
import json
import os

import pytest
import torch

from benchmark.harness import check_render, check_train, session, train
from benchmark.harness import manifest as mf

ROOT = mf.ROOT
SEED = 20260517


def _cfg(name):
    with open(os.path.join(ROOT, "benchmark", "configs", f"{name}.json")) as f:
        return json.load(f)


def _failed(checks):
    return [k for k, c in checks.items() if c["value"] > c["limit"]]


@contextlib.contextmanager
def altered_answers():
    """A quarter of every frame's rays come back at half their color."""
    from nerftex_torch.render.instance_renderer import InstanceRenderer

    real = InstanceRenderer.render_rays

    def render_rays(self, *a, **k):
        out = real(self, *a, **k)
        out["color_pred"][::4] = out["color_pred"][::4] * 0.5
        return out

    InstanceRenderer.render_rays = render_rays
    try:
        yield
    finally:
        InstanceRenderer.render_rays = real


def _frames(name, cell_name, size, faults=contextlib.nullcontext):
    cfg = _cfg(name)
    mix = dict(mf.traffic("frames"), size=[size, size], check_frames=2, check_pixels=size * size)
    cell = session.SessionCell(cfg, mix, SEED, "cpu")
    with faults():
        for _ in range(2):
            cell.unit()
    limits = mf.limits(cell_name)
    args = (cell.records, cfg, cell.settings, cell.weights, cell.spec, (size, size), SEED,
            limits, mix, ROOT, "cpu")
    return args


@pytest.fixture(scope="module")
def carpet():
    return _frames("carpet", "carpet.frames", 20)


@pytest.fixture(scope="module")
def grass():
    return _frames("grass", "grass.frames", 14)


@pytest.mark.parametrize("scene", ["carpet", "grass"])
def test_frame_matches_reference(scene, request):
    args = request.getfixturevalue(scene)
    assert not _failed(check_render.check(*args)), check_render.check(*args)


@pytest.mark.parametrize("scene", ["carpet", "grass"])
def test_frame_control_fails(scene, request):
    args = request.getfixturevalue(scene)
    assert "median_vs_tf32" in _failed(check_render.check(*args, control=True))


def test_altered_answers_fail():
    assert _failed(check_render.check(*_frames("carpet", "carpet.frames", 20, altered_answers)))


def _train_cfg():
    cfg = _cfg("carpet")
    cfg["train"]["train_dataset_config"]["pixel_sampler_config"]["n_samples"] = 16
    cfg["train"]["renderer_config"]["n_samples"] = 24
    return cfg


def _train_checks(faults=contextlib.nullcontext, control=False):
    mix = dict(mf.traffic("train"), swatches={"views": 8, "size": 24, "angle": 0.63,
                                              "radius": 5.0})
    cell = train.TrainCell(_train_cfg(), mix, SEED, "cpu")
    with faults():
        record = cell.checked_steps(int(mix["check_steps"]))
    return check_train.check(record, cell.set_spec, cell.spec, cell.weights, cell.train, SEED,
                             mf.limits("carpet.train"), "cpu", control=control)


@contextlib.contextmanager
def frozen_state():
    """Each step returns with the parameters and Adam's state unchanged."""
    import nerftex_torch.render.train as t

    real = t.optimizer_step
    t.optimizer_step = lambda optimizer: None
    try:
        yield
    finally:
        t.optimizer_step = real


@contextlib.contextmanager
def half_batch():
    """The loss is the mean over the first half of the batch only."""
    from nerftex_torch.render.loss import AlphaLoss

    real = AlphaLoss.__call__

    def call(self, **kw):
        half = {k: (v[: v.shape[0] // 2] if torch.is_tensor(v) and v.dim() else v)
                for k, v in kw.items()}
        return real(self, **half)

    AlphaLoss.__call__ = call
    try:
        yield
    finally:
        AlphaLoss.__call__ = real


def test_train_step_matches_reference():
    checks = _train_checks()
    assert not _failed(checks), checks


def test_train_control_fails():
    assert _failed(_train_checks(control=True))


@pytest.mark.parametrize("fault", [frozen_state, half_batch])
def test_train_faults_fail(fault):
    assert _failed(_train_checks(fault))


def test_retuned_program_point_is_not_followed(monkeypatch, capsys):
    """A re-tuning of the program's operating-point table leaves the
    settings that the program is built with, and that the reference
    follows, at the configuration's frozen point, and is reported."""
    from nerftex_torch import operating_points

    cfg = _cfg("carpet")
    frozen = cfg["operating_point"]["instancer"]
    retuned = {k: dict(v) if isinstance(v, dict) else v
               for k, v in operating_points.OPERATING_POINTS["carpet"].items()}
    retuned["instancer"]["max_steps_per_ray"] = frozen["max_steps_per_ray"] // 2
    retuned["instancer"]["max_hits"] = frozen["max_hits"] // 2
    monkeypatch.setitem(operating_points.OPERATING_POINTS, "carpet", retuned)
    mix = dict(mf.traffic("frames"), size=[8, 8])
    cell = session.SessionCell(cfg, mix, SEED, "cpu")
    inst = cell.session.renderer.instancer.device_instancer
    for key in ("max_steps_per_ray", "max_hits", "ray_block"):
        assert cell.settings[key] == frozen[key] == getattr(inst, key)
    assert "instancer.max_steps_per_ray" in capsys.readouterr().err
