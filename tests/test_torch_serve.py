"""The port's serving path against the JAX package's: RenderSession on one
checkpoint written by the JAX package's CheckpointManager and one seed
serves the JAX session's frames; the operating points, the random streams
and the config distributions equal the JAX modules'; the HTTP front end
answers; checkpoints keep the JAX retention policy and restore without
jax or optax.  At 16x16 with a depth-2, width-32 model (the size of
tests/test_serve.py)."""

import copy
import importlib
import io
import json
import os
import pickle
import subprocess
import sys
import tempfile
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from nerftex_tpu import operating_points as jax_points
from nerftex_tpu.render.checkpoint import CheckpointManager as JaxCheckpointManager
from nerftex_tpu.utils import rng as jax_rng_streams
from nerftex_tpu.utils import util as jax_util
from nerftex_torch import operating_points
from nerftex_torch.render import checkpoint as ckpt
from nerftex_torch.render.serve import RenderSession, make_handler
from nerftex_torch.utils import rng
from nerftex_torch.utils.util import EasyDict, instantiate

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _jax_reference import file_bytes, group, recorded  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULE = "test_torch_serve"
H = W = 16
POSES = ([0.30614675, -0.73910363, 0.6], [0.0, -0.7, 0.7])


def _grass_config(target_path):
    """configs/config_grass_render.py with absolute mesh paths, a depth-2,
    width-32 ParamNerf and its checkpoints under target_path."""
    cfg = copy.deepcopy(importlib.import_module("configs.config_grass_render").config)
    cfg["target_path"] = target_path
    inst = cfg["renderer_config"]["instancer_config"]
    for k in ("mesh_path", "patch_origins_path"):
        inst[k] = os.path.join(ROOT, inst[k])
    cfg["model_config"].update({"depth": 2, "width": 32, "skips": [1]})
    return cfg


def _grass_op():
    """The grass operating point cut to 16x16: max_hits 32 (one hit tier)
    and a step cap of 256, the rest as adopted."""
    op = copy.deepcopy(operating_points.resolve("grass"))
    op["instancer"].update(max_hits=32, max_steps_per_ray=256)
    return op


def _jax_sessions():
    """A JAX checkpoint of a depth-2 grass ParamNerf (optimizer state in
    its extra), and the JAX session on it: its default parameters, its
    restored weights and its frames of POSES, requested in order."""
    from nerftex_tpu.render.serve import RenderSession as JaxSession

    with tempfile.TemporaryDirectory() as target:
        cfg = _grass_config(target)
        jax_rng_streams.set_seed(7)
        import nerftex_tpu.models.mlp as jax_mlp

        jax_mlp._INIT_COUNTER[0] = 0
        params = jax_util.instantiate(jax_util.EasyDict(cfg["model_config"]))["model"].params
        import optax

        JaxCheckpointManager(os.path.join(target, "checkpoints")).save(
            {"models": {"model": params},
             "extra": {"step": 5, "opt_state": optax.adam(1e-3).init(params)}}, 5)
        jax_session = JaxSession(cfg, height=H, width=W, operating_point=_grass_op())
        return {"ckpt": file_bytes(os.path.join(target, "checkpoints", "ckpt-5.pkl")),
                "default_parameters": np.asarray(jax_session.default_parameters),
                **{f"weights/{k}": v for k, v in ckpt.flatten_params(
                    jax.tree.map(np.asarray, jax_session.models["model"].params)).items()},
                **{f"frame/{i}": jax_session.render(pose) for i, pose in enumerate(POSES)}}


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    """A JAX checkpoint of a depth-2 grass ParamNerf (optimizer state in
    its extra), the JAX session's recording on it and the port's session
    on it."""
    target = str(tmp_path_factory.mktemp("logs"))
    cfg = _grass_config(target)
    want = recorded(MODULE, "sessions")
    os.makedirs(os.path.join(target, "checkpoints"))
    with open(os.path.join(target, "checkpoints", "ckpt-5.pkl"), "wb") as f:
        f.write(want["ckpt"].tobytes())
    port_session = RenderSession(cfg, height=H, width=W, operating_point=_grass_op(),
                                 device="cpu")
    return want, port_session


def test_render_session_serves_the_jax_frames(sessions):
    """Two successive requests (the session's renderer draws the JAX
    package's STREAM_PERTURB keys 0 and 1): the port's straight-alpha
    frames match the JAX session's.  Measured: 77.33 and 77.27 dB, max
    pixel error 1.5e-3 and 1.3e-3 (the alpha division magnifies the
    float32 roundings of rays and frame, tests/test_torch_render.py, where
    alpha is small); the bounds are the frame tests' 60 dB and 3e-2."""
    jax_session, port_session = sessions
    assert port_session.restored_from.endswith("ckpt-5.pkl")
    assert port_session.renderer.render_chunk == H * W
    assert port_session.renderer.instancer.device_instancer.ray_block == 2048
    np.testing.assert_array_equal(port_session.default_parameters,
                                  jax_session["default_parameters"])
    for i, pose in enumerate(POSES):
        want = jax_session[f"frame/{i}"]
        got = port_session.render(pose)
        assert got.shape == want.shape == (H, W, 4) and got.dtype == np.float32
        assert want[..., 3].max() > 0.5
        mse = float(np.mean((got - want) ** 2))
        assert 10 * np.log10(1 / max(mse, 1e-20)) >= 60, pose
        assert np.abs(got - want).max() <= 3e-2
    assert port_session._frame == 2 and port_session.renderer._call_counter == 2


def test_session_rays_are_the_grass_golden_frame_rays(tmp_path):
    """The session's rays for the grass golden's pose (the config's radius
    and angle at 512x512) are those of the frame tests/golden_scene_grass.npz
    was rendered from (GenerateData's camera, tests/torch_grass_inputs.npz):
    origins equal, directions within 2.4e-7 (the session's float64 focal
    against the dataset's float32 one), proxy t within 4e-6 where the ray
    enters the box, the same rays missing it, and the same parameters.  So
    a served request differs from the golden frame only in its dots and
    draws (chip_smoke.py's serving phase renders it with both)."""
    import math

    from nerftex_torch.ops.rays import frame_rays

    inp = np.load(os.path.join(ROOT, "tests", "torch_grass_inputs.npz"))
    cfg = importlib.import_module("configs.config_grass_render").config
    proxy = cfg["test_dataset_config"]["proxy_config"]
    h, w, angle = int(inp["height"]), int(inp["width"]), float(inp["angle"])
    want = frame_rays(h, w, inp["eye"], angle, inp["parameters"], proxy["b_0"], proxy["b_1"],
                      focal=w / math.tan(angle / 2) / 2)
    session = RenderSession(dict(cfg, target_path=str(tmp_path)), operating_point="grass",
                            device="cpu")
    assert (session.height, session.width, session.angle) == (h, w, angle)
    np.testing.assert_array_equal(session.default_parameters, want["parameters"][0])
    rays_o, rays_d, t, cone = (x.numpy() for x in session.device_rays(session.pose(POSES[0])))
    np.testing.assert_array_equal(rays_o, want["rays_o"][0])
    np.testing.assert_allclose(rays_d, want["rays_d"][0], rtol=0, atol=2.4e-7)
    np.testing.assert_allclose(cone, want["cone_scale"][0], rtol=1e-6)
    hit = np.isfinite(want["t"][0])
    np.testing.assert_array_equal(np.isfinite(t), hit)
    assert hit.any() and not hit.all()
    np.testing.assert_allclose(t[hit], want["t"][0][hit], rtol=0, atol=4e-6)
    np.testing.assert_array_equal(t[~hit], want["t"][0][~hit])


def test_operating_points_equal_the_jax_module():
    assert operating_points.OPERATING_POINTS == jax_points.OPERATING_POINTS
    assert operating_points.ALIASES == jax_points.ALIASES
    for name in ("carpet", "grass", "plush", "carpet10k", "grass_filtered", "fur", "nope"):
        assert operating_points.resolve(name) == jax_points.resolve(name), name
    for path in ("configs/config_carpet_render.py", "configs.config_grass_filtered_render",
                 "configs/config_plush_train.py", "weird.py", "config_x"):
        assert operating_points.infer_scene(path) == jax_points.infer_scene(path), path


def test_http_endpoint_roundtrip(sessions):
    from http.server import HTTPServer

    from PIL import Image

    session = sessions[1]
    server = HTTPServer(("127.0.0.1", 0), make_handler(session))
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz") as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["resolution"] == [H, W]
        assert health["checkpoint"].endswith("ckpt-5.pkl")
        req = urllib.request.Request(f"http://127.0.0.1:{port}/render",
                                     data=json.dumps({"camera_pos": POSES[0]}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req) as r:
            png = r.read()
        assert png[:4] == b"\x89PNG"
        assert np.asarray(Image.open(io.BytesIO(png))).shape == (H, W, 4)
        bad = urllib.request.Request(f"http://127.0.0.1:{port}/render",
                                     data=b'{"camera_pos": "nonsense"}',
                                     headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(bad)
        assert e.value.code == 400 and "error" in json.loads(e.value.read())
    finally:
        server.shutdown()
        server.server_close()


def test_checkpoint_retention(tmp_path):
    """tests/test_more_paths.py's retention check on the port's manager."""
    mgr = ckpt.CheckpointManager(str(tmp_path / "ck"), max_to_keep=3, keep_every_n_hours=9999)
    for step in range(1, 8):
        mgr.save({"v": np.full(3, step)}, step)
    kept = mgr.checkpoints()
    assert len(kept) <= 4 and 7 in kept
    np.testing.assert_array_equal(mgr.restore_latest()["v"], [7, 7, 7])


def test_checkpoint_hourly_preservation_is_permanent(tmp_path, monkeypatch):
    """keep_every_n_hours keeps a checkpoint for good; later sweeps leave
    it (tests/test_more_paths.py's check on the port's manager)."""
    clock = [1000.0]
    monkeypatch.setattr(ckpt.time, "time", lambda: clock[0])
    mgr = ckpt.CheckpointManager(str(tmp_path / "ck"), max_to_keep=2, keep_every_n_hours=1)
    for i, step in enumerate(range(1, 13)):
        clock[0] = 1000.0 + i * 1200.0
        mgr.save({"v": torch.full((2,), step)}, step)
    kept = sorted(mgr.checkpoints())
    assert kept[-2:] == [11, 12]
    preserved = kept[:-2]
    assert len(preserved) >= 3, kept
    times = [1000.0 + (s - 1) * 1200.0 for s in preserved]
    assert all(b - a >= 3600.0 for a, b in zip(times, times[1:])), kept
    assert all(os.path.exists(os.path.join(str(tmp_path / "ck"), f"ckpt-{s}.pkl")) for s in kept)
    assert isinstance(mgr.restore_latest()["v"], np.ndarray)


def test_checkpoint_with_optax_state_restores_without_jax(sessions, tmp_path):
    """The JAX checkpoint (optax Adam state in its extra) restores in a
    process where jax and optax cannot be imported: the models equal the
    saved parameters and the optimizer state comes back as stand-ins."""
    target = os.path.dirname(os.path.dirname(sessions[1].restored_from))
    want = group(sessions[0], "weights/")
    np.savez(tmp_path / "want.npz", **{k.replace("/", "."): v for k, v in want.items()})
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'optax', 'nerftex_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import numpy as np\n"
        "from nerftex_torch.render import checkpoint as ckpt\n"
        f"saved = ckpt.CheckpointManager({os.path.join(target, 'checkpoints')!r}).restore_latest()\n"
        f"want = np.load({str(tmp_path / 'want.npz')!r})\n"
        "flat = ckpt.flatten_params(saved['models']['model'])\n"
        "assert sorted(flat) == sorted(k.replace('.', '/') for k in want.files)\n"
        "assert all(np.array_equal(flat[k.replace('.', '/')], want[k]) for k in want.files)\n"
        "assert int(saved['extra']['step']) == 5\n"
        "state = saved['extra']['opt_state']\n"
        "stubs = [s for s in state if isinstance(s, ckpt.Opaque)]\n"
        "assert stubs and all(s.module.startswith('optax') for s in stubs), state\n"
        "print('ok', sorted({s.name for s in stubs}))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.startswith("ok") and "ScaleByAdamState" in proc.stdout


class _Calls:
    """Pickles as a call of ``fn(*args)``."""

    def __init__(self, fn, *args):
        self.fn, self.args = fn, args

    def __reduce__(self):
        return self.fn, self.args


@pytest.mark.parametrize("fn", ["exec", "system", "runstring"])
def test_checkpoint_restore_runs_no_code_it_names(tmp_path, fn):
    """A checkpoint whose pickle names a function that runs code (builtins'
    exec, os.system, numpy.testing's runstring) restores that call as an
    Opaque stand-in holding its arguments, and the code does not run."""
    import numpy.testing

    flag = tmp_path / "ran"
    code = f"open({str(flag)!r}, 'w').close()"
    call = {"exec": _Calls(exec, code), "system": _Calls(os.system, f"touch {flag}"),
            "runstring": _Calls(numpy.testing.runstring, code, {})}[fn]
    manager = ckpt.CheckpointManager(str(tmp_path / "checkpoints"))
    with open(os.path.join(manager.directory, "ckpt-1.pkl"), "wb") as f:
        f.write(pickle.dumps({"models": {}, "extra": call}))
    saved = manager.restore_latest()
    assert isinstance(saved["extra"], ckpt.Opaque) and saved["extra"].name == call.fn.__name__
    assert tuple(saved["extra"]) == call.args
    assert not flag.exists()


def test_flat_parameter_vector_is_refused():
    """A model trained with flat_params=True saves one 1-D theta in
    ravel_pytree's order.  The port loads one of the model's size (the
    same weights as its tree) and refuses, saying so, one of another
    size."""
    model = instantiate(_grass_config("")["model_config"], device="cpu")
    with pytest.raises(ValueError, match="flat parameter vector"):
        ckpt.load_jax_params(model, np.zeros(1000, np.float32))
    tree = ckpt.export_jax_params(model)
    theta = np.concatenate([ckpt.flatten_params(tree)[f"{key}/{leaf}"].reshape(-1)
                            for key, leaf, _, _, _ in ckpt.jax_flat_layout(model)])
    other = instantiate(_grass_config("")["model_config"], device="cpu")
    ckpt.load_jax_params(other, theta)
    got = ckpt.flatten_params(ckpt.export_jax_params(other))
    for k, v in ckpt.flatten_params(tree).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("seed", [0, 7])
def test_stream_keys_match_jax(seed):
    jax_rng_streams.set_seed(seed)
    rng.set_seed(seed)
    for stream in (rng.STREAM_PERTURB, rng.STREAM_INSTANCER):
        for step in (0, 1, 5):
            want = np.asarray(jax.random.key_data(jax_rng_streams.stream_key(stream, step)))
            assert rng.stream_key(stream, step).tolist() == want.tolist(), (stream, step)
    assert (rng.STREAM_PERTURB, rng.STREAM_NOISE, rng.STREAM_IMPORTANCE, rng.STREAM_INSTANCER,
            rng.STREAM_FALSE_COLOR, rng.STREAM_DATA) == (
        jax_rng_streams.STREAM_PERTURB, jax_rng_streams.STREAM_NOISE,
        jax_rng_streams.STREAM_IMPORTANCE, jax_rng_streams.STREAM_INSTANCER,
        jax_rng_streams.STREAM_FALSE_COLOR, jax_rng_streams.STREAM_DATA)


@pytest.mark.parametrize("scene", ["grass", "plush", "carpet"])
def test_loader_distributions_match_jax(scene):
    """The render config's pose and parameter distributions draw what the
    JAX package's draw from the same numpy seed."""
    loader = importlib.import_module(f"configs.config_{scene}_render").config[
        "test_dataset_config"]["data_loader_config"]
    for name in ("pose_dist_config", "parameter_dist_config"):
        draws = []
        for make in (lambda c: jax_util.instantiate(jax_util.EasyDict(c)),
                     lambda c: instantiate(EasyDict(c))):
            np.random.seed(3)
            dist = make(loader[name])
            draws.append(np.stack([np.asarray(dist(), np.float64) for _ in range(7)]))
        np.testing.assert_array_equal(draws[1], draws[0], err_msg=f"{scene} {name}")


JAX_CASES = {"sessions": _jax_sessions}
