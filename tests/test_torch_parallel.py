"""nerftex_torch.parallel against the JAX package's nerftex_tpu.parallel at
tests/test_parallel.py's sizes (depth 4, width 64, n_samples 16, batch 2 x
32) and tolerances (data parallel: loss rtol 1e-5, parameters and frames
atol 1e-5; tensor parallel: loss rtol 1e-4, parameters atol 1e-4).

The port runs as gloo processes on the CPU
(tests/_torch_parallel_worker.py): two, spawned once for each of the three
data-parallel cases, and the tensor-parallel case once on a (2, 2) mesh
(four processes) and once on a (1, 2) mesh (two); each is killed at
RANK_TIMEOUT_S so that a hung collective fails the test.  JAX runs on its
8-device CPU mesh (tests/conftest.py).  The weights
go across with render/checkpoint.load_jax_params.  The training cases draw
(perturb and raw_noise_std on), so the shards' draws at their global rows
are held to JAX's sharded draws:

- the dp step against JAX's make_parallel_train_step and JAX's single
  step, the two ranks' parameters bit-equal; then the single writer:
  rank 1 writes no checkpoint, and both restore rank 0's;
- the fused dp step against JAX's make_parallel_fused_train_step (the
  setup of tests/test_parallel.py's fused test);
- shard_render on the plain Renderer and on the instanced real-MLP scene
  (compact path) against JAX's sharded and unsharded renders and the
  port's unsharded render, and on the sorted path against the port's
  unsharded render (JAX's sorted path compiles for minutes on the CPU);
- the tensor-parallel steps (shard_model, the model's layer 3 a skip
  layer, row-parallel, fed by [pos | h2]): the host-fed step against
  JAX's make_parallel_train_step(shard_model=True) on its (2, 2) mesh and
  JAX's single step, each process's blocks against JAX's at the same
  model rank, the checkpoint written inside ``gathered``; the fused step
  against JAX's fused steps on the (2, 2) mesh with shard_model and on
  the 8-way dp mesh; the replicated parameters bit-equal within each
  model row; shard_render of the gathered model over the data axis; and
  the mutation check: the gradients all-reduced over the whole job
  instead of the data column break the sharded parameters' match;
- in one process: Renderer.apply (n_importance) and MipRenderer.apply
  (mip_importance) on a ray shard with its global rows equal that slice
  of the whole batch's apply; model_shardings' specs against JAX's, and
  its refusals against JAX's on the shipped train configs' models;
  init_distributed without arguments or environment; the refusals."""

import os
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerftex_tpu.models.mlp as jax_mlp
from nerftex_tpu.parallel.mesh import (make_mesh as jax_make_mesh,
                                       make_parallel_fused_train_step as jax_fused_dp,
                                       make_parallel_train_step as jax_dp,
                                       shard_render as jax_shard_render)
from nerftex_tpu.render.loss import AlphaLoss as JaxAlphaLoss
from nerftex_tpu.render.renderer import Renderer as JaxRenderer
from nerftex_tpu.render.train import make_optimizer as jax_make_optimizer, make_train_step
from nerftex_tpu.utils import rng as jax_streams
from nerftex_tpu.utils import util as jax_util
from nerftex_torch import parallel
from nerftex_torch.models import mlp as port_mlp
from nerftex_torch.parallel import Mesh
from nerftex_torch.render.checkpoint import flatten_params
from nerftex_torch.render.renderer import MipRenderer, Renderer
from nerftex_torch.utils import jax_rng, rng
from nerftex_torch.utils.util import instantiate

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _jax_reference import group, recorded  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULE = "test_torch_parallel"
WORKER = os.path.join(ROOT, "tests", "_torch_parallel_worker.py")
RANK_TIMEOUT_S = 120
LOSS_RTOL = 1e-5     # tests/test_parallel.py:79
ATOL = 1e-5          # parameters (:81) and frames (:117, :184)
TP_LOSS_RTOL = 1e-4  # tests/test_parallel.py:102, the dp x tp step
TP_ATOL = 1e-4       # :104
TP_SHAPES = {"mesh2x2": (2, 2), "mesh1x2": (1, 2)}
CHUNKS = {"plain": 24, "compact": 64, "sorted": 32}  # 3 (uneven), 2 and 4 render chunks

MODEL = {
    "module": "network.model.ParamNerf",
    "pos_embedding": {"module": "network.model.FourierFeatures", "n_freq_bands": 6},
    "dir_embedding": {"module": "network.model.FourierFeatures", "n_freq_bands": 2},
    "param_embedding": {"module": "network.model.FourierFeatures", "n_freq_bands": 2},
    "n_parameters": [1, 6], "depth": 4, "width": 64, "skips": [2],
}
DRAWS = dict(n_samples=16, perturb=True, raw_noise_std=0.1)  # the worker's RENDERER


def _jax_setup(**renderer):
    """tests/test_parallel.py's _setup, with the draws on."""
    jax_streams.set_seed(0)
    jax_mlp._INIT_COUNTER[0] = 0
    models = jax_util.instantiate(jax_util.EasyDict(MODEL))
    r = JaxRenderer(model=models["model"], **dict(DRAWS, **renderer))
    loss_fn = JaxAlphaLoss(loss_fn="network.loss.smape", alpha_loss_fn="network.loss.mse")
    return models["model"], r, loss_fn, jax_make_optimizer(5e-4, 500)


def _batch(b=2, r=32, p=7, seed=0):
    rs = np.random.RandomState(seed)
    return {
        "rays_o": rs.randn(b, r, 3).astype(np.float32) * 0.1 + np.array([0, 0, 3], np.float32),
        "rays_d": np.tile(np.array([0, 0, -1.0], np.float32), (b, r, 1)),
        "t": np.tile(np.array([2.0, 4.0], np.float32), (b, r, 1)),
        "parameters": rs.rand(b, p).astype(np.float32),
        "cone_scale": np.full((b, r, 1), 0.01, np.float32),
        "color": rs.rand(b, r, 3).astype(np.float32),
        "alpha": rs.randint(0, 2, (b, r)).astype(np.float32),
    }


def _flat(params):
    return flatten_params(jax.tree.map(np.asarray, params["model"]))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(case, directory, inputs, world=2):
    """Run ``case`` in ``world`` gloo ranks on ``inputs``; their outputs."""
    np.savez(os.path.join(directory, "inputs.npz"), **inputs)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    port = _free_port()
    ranks = range(world)
    logs = [open(os.path.join(directory, f"rank{r}.log"), "w+") for r in ranks]
    procs = [subprocess.Popen([sys.executable, WORKER, case, str(r), str(world), str(port),
                               str(directory)], env=env, cwd=ROOT, stdout=logs[r],
                              stderr=subprocess.STDOUT) for r in ranks]
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        text = []
        for r, log in enumerate(logs):
            log.seek(0)
            text.append(f"rank {r}:\n{log.read()[-3000:]}")
            log.close()
    assert all(p.returncode == 0 for p in procs), "\n".join(text)
    return [dict(np.load(os.path.join(directory, f"out_{r}.npz"))) for r in ranks]


def _params_of(out, prefix="param/"):
    return {k[len(prefix):]: v for k, v in out.items() if k.startswith(prefix)}


def _check_step(outs, want_loss, want_params, prefix="", rtol=LOSS_RTOL, atol=ATOL):
    """Every rank's loss and parameters (``<prefix>loss``,
    ``<prefix>param/<leaf>``) against the reference, and the same on
    every rank."""
    for out in outs:
        np.testing.assert_allclose(float(out[prefix + "loss"]), float(want_loss), rtol=rtol)
        got = _params_of(out, prefix + "param/")
        assert set(got) == set(want_params)
        for leaf, p in want_params.items():
            np.testing.assert_allclose(got[leaf], p, rtol=0, atol=atol, err_msg=leaf)
    for out in outs[1:]:
        assert float(out[prefix + "loss"]) == float(outs[0][prefix + "loss"])
        for leaf, p in _params_of(outs[0], prefix + "param/").items():
            np.testing.assert_array_equal(_params_of(out, prefix + "param/")[leaf], p,
                                          err_msg=leaf)


# -- the dp step and the single writer (one spawn) ------------------------------------


def _jax_steps():
    """The model's weights, and JAX's single step and its 8-way dp and
    (2, 2) dp x tp sharded steps on _batch(), key(7): "weights/<leaf>",
    "<single | dp | tp>/loss", "<single | dp | tp>/param/<leaf>", and the
    tp step's blocks "block/<model rank>/<parameter name>" in nn.Linear's
    layout."""
    model, renderer, loss_fn, optimizer = _jax_setup()
    params = {"model": model.params}
    out = {f"weights/{k}": v for k, v in _flat(params).items()}  # before the steps donate
    batch = _batch()
    key = jax.random.key(7)
    single = make_train_step(renderer, loss_fn, optimizer, False, [1, 1, 1.0], donate=False)
    p1, _, loss1 = single(params, optimizer.init(params),
                          {k: jnp.asarray(v) for k, v in batch.items()}, key)
    out["single/loss"] = np.asarray(loss1, np.float32)
    out.update({f"single/param/{k}": v for k, v in _flat(p1).items()})
    for name, shape in (("dp", (8, 1)), ("tp", (2, 2))):
        mesh = jax_make_mesh(shape[0] * shape[1], shape=shape)
        step, place_params, place_batch = jax_dp(renderer, loss_fn, optimizer, mesh, False,
                                                 [1, 1, 1.0], batch, params,
                                                 shard_model=name == "tp")
        placed = place_params(params)
        p2, _, loss2 = step(placed, optimizer.init(placed), place_batch(batch), key)
        out[f"{name}/loss"] = np.asarray(loss2, np.float32)
        out.update({f"{name}/param/{k}": v for k, v in _flat(p2).items()})
    for m in range(2):
        device = mesh.devices[0, m]
        for i, layer in enumerate(p2["model"]["trunk"]):
            for leaf, pname in (("w", f"trunk.{i}.weight"), ("b", f"trunk.{i}.bias")):
                shard = next(s for s in layer[leaf].addressable_shards if s.device == device)
                block = np.asarray(shard.data)
                out[f"block/{m}/{pname}"] = block.T if leaf == "w" else block
    return out


def _steps_of(want, names):
    return {name: (float(want[f"{name}/loss"]), group(want, f"{name}/param/")) for name in names}


@pytest.fixture(scope="module")
def jax_steps():
    """The model's weights, the batch, and JAX's single step and its
    8-way dp and (2, 2) dp x tp sharded steps on them, key(7) (recorded):
    (weights, batch, {"single" | "dp" | "tp": (loss, parameters)}, the tp
    step's blocks {(model rank, parameter name): block in nn.Linear's
    layout})."""
    want = recorded(MODULE, "jax_steps")
    blocks = {(int(k.split("/")[0]), k.split("/")[1]): v
              for k, v in group(want, "block/").items()}
    return (group(want, "weights/"), _batch(), _steps_of(want, ("single", "dp", "tp")),
            blocks)


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory, jax_steps):
    weights, batch, want, _ = jax_steps
    inputs = {"key": np.int64(7), **{f"param/{k}": v for k, v in weights.items()},
              **{f"batch/{k}": v for k, v in batch.items()}}
    directory = tmp_path_factory.mktemp("dp")
    outs = _spawn("dp", directory, inputs)
    return outs, want["single"], want["dp"], directory


def test_dp_step_matches_jax_sharded_and_single(dp_run):
    """One step on 2 x 32 rays, 16 a rank: the loss and every parameter
    against JAX's 8-way sharded step and its single step, the ranks
    bit-equal."""
    outs, single, sharded, _ = dp_run
    for want_loss, want_params in (sharded, single):
        _check_step(outs, want_loss, want_params)


def test_single_writer_checkpoint(dp_run):
    """Rank 1's save writes nothing; the shared directory holds rank 0's
    one checkpoint, which both ranks restored after a barrier and matched
    to their own parameters (asserted in the worker)."""
    outs, _, _, directory = dp_run
    assert list(outs[0]["private_files"]) == ["ckpt-1.pkl"]
    assert list(outs[1]["private_files"]) == []
    assert list(outs[0]["shared_files"]) == list(outs[1]["shared_files"]) == ["ckpt-1.pkl"]
    assert sorted(os.listdir(directory / "private_1")) == []


# -- the fused dp step ------------------------------------------------------------------


def _fused_records():
    """tests/test_parallel.py's fused setup: four 16 x 16 records, their
    size and focal."""
    from math import tan

    from nerftex_tpu.data.dataset import look_at_np

    rs = np.random.RandomState(5)
    size, angle = 16, 0.63
    focal = size / tan(angle / 2) / 2
    records = []
    for _ in range(4):
        direction = rs.randn(3)
        direction[2] = abs(direction[2]) + 0.3
        records.append({"image": rs.rand(size, size, 3).astype(np.float32),
                        "alpha": rs.rand(size, size).astype(np.float32),
                        "pose": look_at_np(direction / np.linalg.norm(direction) * 5.0),
                        "parameters": rs.rand(7).astype(np.float32)})
    return records, size, focal


def _jax_fused():
    """JAX's make_parallel_fused_train_step on _fused_records(), one step
    under the streams' keys at step 0, on the 8-way dp mesh and on the
    (2, 2) mesh with shard_model: "weights/<leaf>", "<dp | tp>/loss" and
    "<dp | tp>/param/<leaf>"."""
    from nerftex_tpu.data.dataset import ListSource
    from nerftex_tpu.data.device_dataset import DeviceResidentSampler
    from nerftex_tpu.data.pixel_sampler import Proxy as ProxyPixels
    from nerftex_tpu.data.ray_sampler import Proxy as ProxyRays
    from nerftex_tpu.ops.proxy import AABB

    records, size, focal = _fused_records()
    proxy = AABB([-1.5, -1.3, -0.2], [1.3, 1.3, 1.9])
    sampler = DeviceResidentSampler(
        ListSource(records),
        ProxyPixels(height=size, width=size, n_samples=32, proxy=proxy, focal=focal,
                    downsample_factor=2),
        ProxyRays(height=size, width=size, focal=focal, proxy=proxy),
        batchsize=2, height=size, width=size, focal=focal, composite_bkgd=False,
        bkgd_color=[1, 1, 1.0])
    out = {}
    for name, shape in (("dp", (8, 1)), ("tp", (2, 2))):
        model, renderer, loss_fn, optimizer = _jax_setup()
        params = {"model": model.params}
        weights = _flat(params)  # before the sharded step donates its buffers
        mesh = jax_make_mesh(shape[0] * shape[1], shape=shape)
        step, place_params, place_tables = jax_fused_dp(
            renderer, loss_fn, optimizer, sampler, mesh, False, [1, 1, 1.0], params,
            shard_model=name == "tp")
        placed = place_params(params)
        data_key = jax.random.fold_in(jax_streams.stream_key(jax_streams.STREAM_DATA), 0)
        key = jax.random.fold_in(jax_streams.stream_key(jax_streams.STREAM_PERTURB), 0)
        p2, _, loss2 = step(placed, optimizer.init(placed), place_tables(), data_key, key)
        out[f"{name}/loss"] = np.asarray(loss2, np.float32)
        out.update({f"{name}/param/{k}": v for k, v in _flat(p2).items()})
    out.update({f"weights/{k}": v for k, v in weights.items()})
    return out


@pytest.fixture(scope="module")
def fused_jax():
    """tests/test_parallel.py's fused setup (four 16 x 16 records), and
    JAX's make_parallel_fused_train_step on it (recorded), one step under
    the streams' keys at step 0, on the 8-way dp mesh and on the (2, 2)
    mesh with shard_model: (the port's inputs, {"dp" | "tp": (loss,
    parameters)})."""
    records, size, focal = _fused_records()
    want = recorded(MODULE, "fused_jax")
    inputs = {"size": np.int64(size), "focal": np.float64(focal),
              **{f"param/{k}": v for k, v in group(want, "weights/").items()},
              **{name: np.stack([np.asarray(r[name], np.float32) for r in records])
                 for name in ("image", "alpha", "pose", "parameters")}}
    return inputs, _steps_of(want, ("dp", "tp"))


def test_fused_dp_step_matches_jax(tmp_path, fused_jax):
    """One device-resident step, the tables replicated and each rank's
    shard of the batch sampled under the step's data key, against JAX's
    make_parallel_fused_train_step on the 8-device mesh with the same
    step keys (the streams' keys at step 0)."""
    inputs, want = fused_jax
    outs = _spawn("fused", tmp_path, inputs)
    _check_step(outs, *want["dp"])


# -- the tensor-parallel steps (one spawn per mesh shape) -----------------------------


@pytest.fixture(scope="module", params=sorted(TP_SHAPES))
def tp_run(request, tmp_path_factory, jax_steps, fused_jax):
    shape = TP_SHAPES[request.param]
    weights, batch, want, blocks = jax_steps
    fused_inputs, fused_want = fused_jax
    inputs = dict(fused_inputs, key=np.int64(7), shape=np.int64(shape),
                  plain_chunk=np.int64(CHUNKS["plain"]),
                  **{f"batch/{k}": v for k, v in batch.items()},
                  **{f"plain/{k}": v for k, v in batch.items() if k not in ("color", "alpha")})
    outs = _spawn("tp", tmp_path_factory.mktemp(request.param), inputs,
                  world=shape[0] * shape[1])
    return shape, outs, want, blocks, fused_want


def test_tp_step_matches_jax_sharded_and_single(tp_run):
    """The host-fed dp x tp step: every rank's loss and whole parameters
    (gathered) against JAX's (2, 2) sharded step and its single step;
    each rank's blocks against JAX's at the same model rank (the layout
    model_shardings describes, the skip layer's row blocks JAX's); the
    checkpoint written inside gathered holds the whole parameters."""
    shape, outs, want, blocks, _ = tp_run
    for name in ("tp", "single"):
        _check_step(outs, *want[name], prefix="tp/", rtol=TP_LOSS_RTOL, atol=TP_ATOL)
    for rank, out in enumerate(outs):
        sharded = list(out["tp/sharded"])
        assert sharded == sorted([f"trunk.{i}.weight" for i in range(4)]
                                 + ["trunk.0.bias", "trunk.2.bias"])
        m = rank % shape[1]
        for pname in sharded:
            np.testing.assert_allclose(out[f"tp/local/{pname}"], blocks[(m, pname)], rtol=0,
                                       atol=TP_ATOL, err_msg=f"rank {rank} {pname}")
        for leaf, p in _params_of(out, "tp/param/").items():
            np.testing.assert_array_equal(out[f"ckpt/{leaf}"], p, err_msg=leaf)


def test_fused_tp_step_matches_jax(tp_run):
    """The device-resident dp x tp step, of a per-layer model (sharded)
    and of a flat_params one (replicated over "model", its flat gradient
    all-reduced over the data column), against JAX's fused step on the
    (2, 2) mesh with shard_model and on the 8-way dp mesh."""
    _, outs, _, _, fused_want = tp_run
    for name in ("tp", "dp"):
        for prefix in ("fused/", "flat/"):
            _check_step(outs, *fused_want[name], prefix=prefix, rtol=TP_LOSS_RTOL,
                        atol=TP_ATOL)


@pytest.mark.parametrize("step", ["tp", "fused"])
def test_tp_replicated_parameters_bit_equal_within_model_rows(tp_run, step):
    """After the step, the processes of a model row hold bit-equal
    replicated parameters (the heads, the parameter MLPs, the
    row-parallel biases): the conjugate pair gave them equal gradients."""
    shape, outs, _, _, _ = tp_run
    sharded = set(outs[0][f"{step}/sharded"])
    names = [k for k in outs[0] if k.startswith(f"{step}/local/")
             and k[len(f"{step}/local/"):] not in sharded]
    assert len(names) == 12  # two row-parallel biases and the five heads' w and b
    for d in range(shape[0]):
        row = outs[d * shape[1]:(d + 1) * shape[1]]
        for out in row[1:]:
            for k in names:
                np.testing.assert_array_equal(out[k], row[0][k], err_msg=k)


def test_tp_mutation_breaks_the_match(tp_run):
    """The mutation check: with every gradient all-reduced over the whole
    job instead of the data column, the sharded parameters (blocks of
    different processes averaged) leave JAX's step by more than the
    tolerance, while the replicated ones still match."""
    _, outs, want, _, _ = tp_run
    _, ref = want["tp"]
    got = _params_of(outs[0], "mutant/param/")
    err = {leaf: float(np.abs(got[leaf] - p).max()) for leaf, p in ref.items()}
    sharded = [f"trunk/{i}/w" for i in range(4)] + ["trunk/0/b", "trunk/2/b"]
    assert max(err[leaf] for leaf in sharded) > 2 * TP_ATOL, err
    assert max(v for leaf, v in err.items() if leaf not in sharded) <= TP_ATOL, err


def test_tp_render_needs_gathered_parameters(tp_run):
    """Outside gathered a render of the sharded model raises; inside it,
    shard_render over the data axis equals the unsharded render."""
    _, outs, _, _, _ = tp_run
    for out in outs:
        assert bool(out["render/outside_raised"])
        got = _params_of(out, "render/sharded/")
        assert {"color_pred", "alpha_pred"} <= set(got)
        for k, v in got.items():
            np.testing.assert_allclose(v, out[f"render/whole/{k}"], rtol=0, atol=ATOL, err_msg=k)


# -- shard_render (one spawn, three renderers) ------------------------------------------


def _instanced_jax(model, **kw):
    from nerftex_tpu.instancing.instancer import Instancer
    from nerftex_tpu.render.instance_renderer import InstanceRenderer

    shift = np.eye(4, dtype=np.float32)
    shift[0, 3] = 0.6
    inst = Instancer(b_0=[-0.5, -0.5, -0.5], b_1=[0.5, 0.5, 0.5],
                     transformations=[np.eye(4, dtype=np.float32), shift], ray_block=16,
                     max_hits=4)
    return InstanceRenderer(instancer_config=inst, model=model, n_samples=32, step_size=0.05,
                            **kw)


def _instanced_rays(n=128):
    """tests/test_parallel.py's real-MLP scene's rays."""
    rs = np.random.RandomState(1)
    return dict(
        rays_o=np.concatenate([rs.uniform(-0.3, 0.8, (1, n, 2)), np.full((1, n, 1), 5.0)],
                              -1).astype(np.float32),
        rays_d=np.tile([0, 0, -1.0], (1, n, 1)).astype(np.float32),
        t=np.tile([3.0, 7.0], (1, n, 1)).astype(np.float32),
        parameters=rs.rand(1, 7).astype(np.float32),
        cone_scale=np.full((1, n, 1), 0.01, np.float32),
    )


def _render_data():
    plain_data = {k: v for k, v in _batch().items() if k not in ("color", "alpha")}
    return plain_data, _instanced_rays()


def _jax_renders():
    """The model's weights, and JAX's unsharded and 8-way sharded renders
    of the plain and compact renderers under key(0):
    "<plain | compact>/<jax | jax_sharded>/<output>"."""
    model, plain, _, _ = _jax_setup(render_chunk=CHUNKS["plain"])
    mesh = jax_make_mesh(8, shape=(8, 1))
    plain_data, inst_data = _render_data()
    compact = _instanced_jax(model, render_chunk=CHUNKS["compact"], sample_budget_per_ray=16)
    out = {f"weights/{k}": v for k, v in _flat({"model": model.params}).items()}
    for name, renderer, data in (("plain", plain, plain_data), ("compact", compact, inst_data)):
        key = jax.random.key(0)
        ref = renderer(**data, training=False, key=key)
        sharded = jax_shard_render(renderer, mesh)(**data, training=False, key=key)
        for side, res in (("jax", ref), ("jax_sharded", sharded)):
            out.update({f"{name}/{side}/{k}": np.asarray(v) for k, v in res.items()
                        if not k.startswith("_")})
    return out


@pytest.fixture(scope="module")
def render_run(tmp_path_factory):
    recording = recorded(MODULE, "render_run")
    want = {name: {side: group(recording, f"{name}/{side}/") for side in ("jax", "jax_sharded")}
            for name in ("plain", "compact")}
    assert want["compact"]["jax"]["alpha_pred"].max() > 0, "the scene must be hit"
    plain_data, inst_data = _render_data()
    inputs = {**{f"param/{k}": v for k, v in group(recording, "weights/").items()},
              **{f"plain/{k}": v for k, v in plain_data.items()},
              **{f"instanced/{k}": v for k, v in inst_data.items()},
              **{f"{name}_chunk": np.int64(c) for name, c in CHUNKS.items()}}
    return _spawn("render", tmp_path_factory.mktemp("render"), inputs), want


@pytest.mark.parametrize("name", ["plain", "compact", "sorted"])
def test_shard_render_matches_the_unsharded_render(render_run, name):
    """Every rank's gathered frame equals the port's unsharded render of
    the same rays and key and, on the plain and compact renderers, JAX's
    unsharded and sharded renders; the drop counts are the unsharded
    render's."""
    outs, want = render_run
    for out in outs:
        got = {k.split("/")[-1]: v for k, v in out.items() if k.startswith(f"{name}/sharded/")}
        whole = {k.split("/")[-1]: v for k, v in out.items() if k.startswith(f"{name}/whole/")}
        assert set(got) == set(whole) and {"color_pred", "alpha_pred"} <= set(got)
        for k, v in got.items():
            np.testing.assert_allclose(v, whole[k], rtol=0, atol=ATOL, err_msg=k)
        for side in want.get(name, {}).values():
            for k, v in side.items():
                np.testing.assert_allclose(got[k], v, rtol=0, atol=ATOL, err_msg=k)
        (whole_drops, sharded_drops) = out[f"{name}/drops"]
        np.testing.assert_array_equal(sharded_drops, whole_drops)


# -- one process ------------------------------------------------------------------------


def _port_model(cfg):
    rng.set_seed(0)
    port_mlp._INIT_COUNTER[0] = 0
    return instantiate(cfg, device="cpu")


def _mip_renderer():
    cfg = dict(MODEL, pos_embedding={"module": "network.model.IntegratedPositionalEncoding",
                                     "n_freq_bands": 4}, n_pos=6, n_parameters=[1, 5])
    return MipRenderer(model=_port_model(cfg), blur_idx=0, n_samples=8, n_importance=8,
                       mip_importance=True, perturb=True, raw_noise_std=0.1, device="cpu")


@pytest.mark.parametrize("kind", ["renderer_importance", "mip_importance"])
def test_apply_on_a_shard_with_global_rows_is_that_slice_of_the_batch(kind):
    """Rank 1 of 2 renders rays 4-7 of each of two images with their global
    rows: every output equals those rays of the whole [2, 8] batch's
    apply, under the same key, with training draws (jitter, density noise
    and importance samples)."""
    if kind == "renderer_importance":
        renderer = Renderer(model=_port_model(MODEL), n_importance=8, device="cpu",
                            **dict(DRAWS, n_samples=8))
    else:
        renderer = _mip_renderer()
    data = {k: torch.tensor(v) for k, v in _batch(b=2, r=8).items()}
    data["cone_scale"] = data["cone_scale"] * 10
    key = jax_rng.key(3)
    mesh = Mesh(1, 2, "cpu")
    local = {k: v if k == "parameters" else mesh.shard(v, 1) for k, v in data.items()}
    with torch.no_grad():
        whole = renderer.apply(data, key)
        shard = renderer.apply(local, key, rows=mesh.global_rows(2, 4))
    assert "color_pred_coarse" in whole
    for k, v in whole.items():
        np.testing.assert_allclose(shard[k].numpy(), v[:, 4:8].numpy(), rtol=0, atol=1e-6,
                                   err_msg=k)


def test_model_shardings_match_jax():
    """The port's specs are JAX's model_shardings on a (4, 2) mesh, w's
    read in nn.Linear's [out, in] layout (reversed); every other leaf
    replicates; a flat-parameter model replicates whole."""
    from jax.sharding import PartitionSpec as P

    from nerftex_tpu.parallel.mesh import model_shardings as jax_model_shardings
    from nerftex_torch.render.train import apply_flat_param_space

    model, *_ = _jax_setup()
    want = jax_model_shardings({"model": model.params}, jax_make_mesh(8, shape=(4, 2)))["model"]
    port = _port_model(MODEL)
    got = parallel.model_shardings({"model": port}, Mesh(0, 8, "cpu", tp=2))["model"]
    assert set(got) == {n for n, _ in port.named_parameters()}
    for i, layer in enumerate(want["trunk"]):
        assert got[f"trunk.{i}.weight"].spec[::-1] == tuple(layer["w"].spec), i
        assert got[f"trunk.{i}.bias"].spec == tuple(layer["b"].spec), i
    assert [got[f"trunk.{i}.weight"].spec for i in range(3)] == [
        ("model", None), (None, "model"), ("model", None)]
    for key in ("alpha", "bottleneck", "pre_color", "color"):
        assert want[key]["w"].spec == P() and got[f"{key}.weight"].spec == ()
    apply_flat_param_space({"model": port})
    flat = parallel.model_shardings({"model": port}, Mesh(0, 8, "cpu", tp=2))["model"]
    assert {k: v.spec for k, v in flat.items()} == {"flat": ()}


SHARDING_CASES = [("config_carpet_train", 2), ("config_carpet_train", 4),
                  ("config_grass_filtered_train", 2), ("demo_grass_mip_train", 2)]


def _full_width_cfg(config):
    import importlib

    cfg = dict(importlib.import_module(f"configs.{config}").config["model_config"])
    cfg.setdefault("n_parameters", {"config_carpet_train": [1, 6],
                                    "config_grass_filtered_train": [2, 3]}.get(config))
    return cfg


def _jax_placement(config, tp):
    """JAX's device_put of the config's full-width model under
    model_shardings on a (2, tp) mesh: the trunk's w shapes, and the
    ValueError it raised ("" if it placed the model)."""
    from nerftex_tpu.parallel.mesh import model_shardings as jax_model_shardings

    jax_streams.set_seed(0)
    jax_mlp._INIT_COUNTER[0] = 0
    params = {"model": jax_util.instantiate(jax_util.EasyDict(_full_width_cfg(config)))["model"]
              .params}
    shapes = [tuple(layer["w"].shape) for layer in params["model"]["trunk"]]
    try:
        jax.device_put(params, jax_model_shardings(params, jax_make_mesh(2 * tp,
                                                                         shape=(2, tp))))
        jax_error = ""
    except ValueError as e:
        jax_error = str(e)
    return {"shapes": np.array(shapes), "error": np.array(jax_error)}


@pytest.mark.parametrize("config,tp", SHARDING_CASES)
def test_model_shardings_refuse_what_jax_refuses(config, tp):
    """A shipped train config's full-width model at tp 2 or 4: JAX's
    device_put under model_shardings and the port's model_shardings both
    place it or both raise ValueError (the row-parallel skip layer: carpet
    [328, 256] places at tp 2 and 4, grass_filtered [337, 256] and mip
    [325, 256] do not at tp 2), the port's naming the layer and the
    dimension."""
    want = recorded(MODULE, f"test_model_shardings_refuse_what_jax_refuses[{config}-{tp}]")
    shapes = [tuple(int(n) for n in s) for s in want["shapes"]]
    jax_error = str(want["error"]) or None
    port = _port_model(_full_width_cfg(config))
    mesh = Mesh(0, 2 * tp, "cpu", tp=tp)
    if jax_error is None:
        specs = parallel.model_shardings({"model": port}, mesh)["model"]
        assert len([s for s in specs.values() if s.spec]) == 8 + 4
    else:
        bad = next(i for i, (n_in, n_out) in enumerate(shapes)
                   if (n_out if i % 2 == 0 else n_in) % tp)
        dim = shapes[bad][0 if bad % 2 else 1]
        with pytest.raises(ValueError, match=f"trunk layer {bad} .* dimension of {dim} "):
            parallel.model_shardings({"model": port}, mesh)
    assert (jax_error is None) == ((config, tp) in {("config_carpet_train", 2),
                                                    ("config_carpet_train", 4)}), jax_error


def test_init_distributed_without_arguments_or_environment(monkeypatch):
    for name in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    assert parallel.init_distributed() is False
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="init_distributed"):
        parallel.make_mesh()


def test_refusals():
    """Uneven shards, fewer render chunks than processes, and a
    tensor-parallel shard_model whose trunk the model axis does not split
    (grass_filtered's row-parallel skip layer, [337, 256], at tp 2) raise
    before any collective."""
    mesh = Mesh(0, 2, "cpu")
    renderer = Renderer(model=_port_model(MODEL), render_chunk=32, device="cpu", **DRAWS)
    loss_fn = object()
    with pytest.raises(ValueError, match="evenly"):
        parallel.make_parallel_train_step(renderer, loss_fn, None, mesh, False, [1, 1, 1.0],
                                          _batch(r=33), {"model": renderer.model})
    _, _, place_batch = parallel.make_parallel_train_step(
        renderer, loss_fn, None, mesh, False, [1, 1, 1.0], _batch(), {"model": renderer.model})
    with pytest.raises(ValueError, match="evenly"):
        place_batch(_batch(r=31))
    data = {k: v for k, v in _batch(b=1, r=32).items() if k not in ("color", "alpha")}
    with pytest.raises(ValueError, match="render chunks"):
        parallel.shard_render(renderer, mesh)(**data, key=jax_rng.key(0))
    import importlib

    cfg = dict(importlib.import_module("configs.config_grass_filtered_train")
               .config["model_config"], n_parameters=[2, 3])
    grass = {"model": _port_model(cfg)}
    tp_mesh = Mesh(0, 2, "cpu", tp=2)
    with pytest.raises(ValueError, match="trunk layer 5 .* dimension of 337 "):
        parallel.make_parallel_train_step(renderer, loss_fn, None, tp_mesh, False, [1, 1, 1.0],
                                          _batch(), grass, shard_model=True)
    with pytest.raises(ValueError, match="trunk layer 5 .* dimension of 337 "):
        parallel.make_parallel_fused_train_step(renderer, loss_fn, None, None, tp_mesh, False,
                                                [1, 1, 1.0], grass, shard_model=True)


JAX_CASES = {
    "jax_steps": _jax_steps,
    "fused_jax": _jax_fused,
    "render_run": _jax_renders,
    **{f"test_model_shardings_refuse_what_jax_refuses[{config}-{tp}]":
       (lambda config=config, tp=tp: _jax_placement(config, tp)) for config, tp in SHARDING_CASES},
}
