"""One rank of a gloo job on the CPU for tests/test_torch_parallel.py:
runs the port's parallel code on the inputs the test wrote and writes what
it computed.

Usage: python tests/_torch_parallel_worker.py <case> <rank> <world> <port> <dir>

Reads <dir>/inputs.npz, writes <dir>/out_<rank>.npz.  Cases:
  dp      make_parallel_train_step, one step (the loss, the parameters),
          then the single writer: CheckpointManager.save into a directory
          of this rank's own and into a shared one, a barrier, and the
          shared checkpoint restored and held to this rank's parameters;
  fused   make_parallel_fused_train_step, one step (eager on the CPU);
  render  shard_render and the unsharded render of three scenes: the
          plain Renderer, and the instanced real-MLP scene on the compact
          and on the sorted path;
  tp      on the (dp, tp) mesh of the inputs' "shape", with shard_model:
          the host-fed step (the loss, each process's blocks and
          replicated parameters, the whole parameters inside gathered,
          where rank 0 also writes the one checkpoint and shard_render
          renders the plain Renderer beside the unsharded render; outside
          it a render raises), the fused step, the fused step of a
          flat_params model (replicated over "model"), and the host-fed
          step with its gradients all-reduced over the whole job instead
          of the data column (the mutation check).
The model is tests/test_parallel.py's (depth 4, width 64), with the JAX
weights in the inputs under "param/".  Imports no JAX.
"""

import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from nerftex_torch.parallel import (gathered, init_distributed, make_mesh,  # noqa: E402
                                    make_parallel_fused_train_step, make_parallel_train_step,
                                    shard_render)
from nerftex_torch.render.checkpoint import (CheckpointManager, export_jax_params,  # noqa: E402
                                             flatten_params, load_jax_params)
from nerftex_torch.render.loss import AlphaLoss  # noqa: E402
from nerftex_torch.render.train import apply_flat_param_space, make_optimizer  # noqa: E402
from nerftex_torch.utils import jax_rng, rng  # noqa: E402
from nerftex_torch.utils.util import instantiate  # noqa: E402

MODEL = {
    "module": "network.model.ParamNerf",
    "pos_embedding": {"module": "network.model.FourierFeatures", "n_freq_bands": 6},
    "dir_embedding": {"module": "network.model.FourierFeatures", "n_freq_bands": 2},
    "param_embedding": {"module": "network.model.FourierFeatures", "n_freq_bands": 2},
    "n_parameters": [1, 6], "depth": 4, "width": 64, "skips": [2],
}
# The training cases' draws: the stratified jitter and the density noise.
RENDERER = dict(n_samples=16, perturb=True, raw_noise_std=0.1)
LRATE, LRATE_DECAY = 5e-4, 500


def group(inputs, prefix):
    return {k[len(prefix):]: v for k, v in inputs.items() if k.startswith(prefix)}


def model_of(inputs):
    model = instantiate(MODEL, device="cpu")
    load_jax_params(model, group(inputs, "param/"))
    return model


def training(model):
    from nerftex_torch.render.renderer import Renderer

    renderer = Renderer(model=model, device="cpu", **RENDERER)
    loss_fn = AlphaLoss(loss_fn="network.loss.smape", alpha_loss_fn="network.loss.mse")
    return renderer, loss_fn, make_optimizer(model.parameters(), LRATE, LRATE_DECAY)


def params_out(model, prefix="param/"):
    return {prefix + k: v for k, v in flatten_params(export_jax_params(model)).items()}


def case_dp(inputs, mesh, out_dir):
    model = model_of(inputs)
    renderer, loss_fn, optimizer = training(model)
    batch = group(inputs, "batch/")
    params = {"model": model}
    step, place_params, place_batch = make_parallel_train_step(
        renderer, loss_fn, optimizer, mesh, False, [1, 1, 1.0], batch, params)
    place_params(params)
    loss = step(place_batch(batch), jax_rng.key(int(inputs["key"])))
    out = {"loss": np.float32(float(loss)), **params_out(model)}

    own = os.path.join(out_dir, f"private_{mesh.rank}")
    CheckpointManager(own).save({"model": export_jax_params(model)}, 1)
    manager = CheckpointManager(os.path.join(out_dir, "shared"))
    manager.save({"model": export_jax_params(model), "step": 1}, 1)
    torch.distributed.barrier()
    restored = manager.restore_latest()
    assert restored["step"] == 1
    mine = flatten_params(export_jax_params(model))
    for leaf, value in flatten_params(restored["model"]).items():
        np.testing.assert_array_equal(value, mine[leaf], err_msg=leaf)
    out["private_files"] = np.array(sorted(os.listdir(own)), dtype=str)
    out["shared_files"] = np.array(sorted(os.listdir(manager.directory)), dtype=str)
    return out


def fused_sampler(inputs):
    from nerftex_torch.data.dataset import ListSource
    from nerftex_torch.data.device_dataset import DeviceResidentSampler
    from nerftex_torch.data.pixel_sampler import Proxy as ProxyPixels
    from nerftex_torch.data.ray_sampler import Proxy as ProxyRays
    from nerftex_torch.ops.proxy import AABB

    records = [{"image": inputs["image"][i], "alpha": inputs["alpha"][i],
                "pose": inputs["pose"][i], "parameters": inputs["parameters"][i]}
               for i in range(inputs["image"].shape[0])]
    size, focal = int(inputs["size"]), float(inputs["focal"])
    proxy = AABB([-1.5, -1.3, -0.2], [1.3, 1.3, 1.9])
    sampler = DeviceResidentSampler(
        ListSource(records),
        ProxyPixels(height=size, width=size, n_samples=32, proxy=proxy, focal=focal,
                    downsample_factor=2),
        ProxyRays(height=size, width=size, focal=focal, proxy=proxy),
        batchsize=2, height=size, width=size, focal=focal, composite_bkgd=False,
        bkgd_color=[1, 1, 1.0], device="cpu")
    return sampler


def case_fused(inputs, mesh, out_dir):
    sampler = fused_sampler(inputs)
    model = model_of(inputs)
    renderer, loss_fn, optimizer = training(model)
    params = {"model": model}
    step, place_params, place_tables = make_parallel_fused_train_step(
        renderer, loss_fn, optimizer, sampler, mesh, False, [1, 1, 1.0], params)
    place_params(params)
    assert all(place_tables()[k] is v for k, v in sampler.tables.items())
    losses = step.run(0, 1)
    return {"loss": losses.numpy()[0], **params_out(model)}


def instanced(model, inputs, **kw):
    from nerftex_torch.instancing.instancer import Instancer
    from nerftex_torch.render.instance_renderer import InstanceRenderer

    shift = np.eye(4, dtype=np.float32)
    shift[0, 3] = 0.6
    inst = Instancer(b_0=[-0.5, -0.5, -0.5], b_1=[0.5, 0.5, 0.5],
                     transformations=[np.eye(4, dtype=np.float32), shift], ray_block=16,
                     max_hits=4, device="cpu")
    return InstanceRenderer(instancer_config=inst, model=model, n_samples=32, step_size=0.05,
                            device="cpu", **kw)


def case_render(inputs, mesh, out_dir):
    from nerftex_torch.render.renderer import Renderer

    model = model_of(inputs)
    renderers = {
        "plain": Renderer(model=model, render_chunk=int(inputs["plain_chunk"]), device="cpu",
                          **RENDERER),
        "compact": instanced(model, inputs, render_chunk=int(inputs["compact_chunk"]),
                             sample_budget_per_ray=16),
        "sorted": instanced(model, inputs, render_chunk=int(inputs["sorted_chunk"])),
    }
    out = {}
    for name, renderer in renderers.items():
        data = group(inputs, "plain/" if name == "plain" else "instanced/")
        # The (hits, samples) dropped, as each render reports them.
        drops, report = [], renderer._report_diagnostics
        renderer._report_diagnostics = lambda o: (drops.append(
            [o.get("_overflow_hits", 0), o.get("_overflow_steps", 0)]), report(o))
        key = jax_rng.key(0)
        whole = renderer(**data, training=False, key=key)
        sharded = shard_render(renderer, mesh)(**data, training=False, key=key)
        assert set(sharded) == set(whole), (set(sharded), set(whole))
        for k, v in sharded.items():
            out[f"{name}/sharded/{k}"] = v.numpy()
            out[f"{name}/whole/{k}"] = whole[k].numpy()
        out[f"{name}/drops"] = np.array(drops, np.int64)
    return out


def held(model, prefix):
    """This process's parameters as it holds them (nn.Linear layout),
    and the names of its sharded ones."""
    out = {f"{prefix}local/{k}": p.detach().numpy().copy() for k, p in model.named_parameters()}
    out[f"{prefix}sharded"] = np.array(sorted(model.sharded_trunk.shardings), dtype=str)
    return out


def tp_step(inputs, mesh):
    """A model, its renderer and the host-fed tensor-parallel step, placed."""
    model = model_of(inputs)
    renderer, loss_fn, optimizer = training(model)
    batch = group(inputs, "batch/")
    params = {"model": model}
    step, place_params, place_batch = make_parallel_train_step(
        renderer, loss_fn, optimizer, mesh, False, [1, 1, 1.0], batch, params, shard_model=True)
    place_params(params)
    return model, params, lambda: step(place_batch(batch), jax_rng.key(int(inputs["key"])))


def case_tp(inputs, mesh, out_dir):
    from nerftex_torch.render.renderer import Renderer

    model, params, step = tp_step(inputs, mesh)
    out = {"tp/loss": np.float32(float(step())), **held(model, "tp/")}
    plain = Renderer(model=model, render_chunk=int(inputs["plain_chunk"]), device="cpu",
                     **RENDERER)
    data = group(inputs, "plain/")
    try:
        plain(**data, training=False, key=jax_rng.key(0))
        out["render/outside_raised"] = np.bool_(False)
    except RuntimeError:
        out["render/outside_raised"] = np.bool_(True)
    manager = CheckpointManager(os.path.join(out_dir, "shared"))
    with gathered(params, mesh):
        out.update(params_out(model, "tp/param/"))
        manager.save({"model": export_jax_params(model), "step": 1}, 1)
        whole = plain(**data, training=False, key=jax_rng.key(0))
        sharded = shard_render(plain, mesh)(**data, training=False, key=jax_rng.key(0))
        for k, v in sharded.items():
            out[f"render/sharded/{k}"] = v.numpy()
            out[f"render/whole/{k}"] = whole[k].numpy()
    after = held(model, "tp/")  # the blocks are back as they were
    for k, v in after.items():
        np.testing.assert_array_equal(v, out[k], err_msg=k)
    torch.distributed.barrier()
    out.update({f"ckpt/{k}": v for k, v in
                flatten_params(manager.restore_latest()["model"]).items()})

    sampler = fused_sampler(inputs)
    for prefix in ("fused/", "flat/"):
        model = model_of(inputs)
        if prefix == "flat/":
            apply_flat_param_space({"model": model})
        renderer, loss_fn, optimizer = training(model)
        params = {"model": model}
        fused, place_params, _ = make_parallel_fused_train_step(
            renderer, loss_fn, optimizer, sampler, mesh, False, [1, 1, 1.0], params,
            shard_model=True)
        place_params(params)
        out[prefix + "loss"] = fused.run(0, 1).numpy()[0]
        if prefix == "fused/":
            out.update(held(model, prefix))
        else:  # replicated whole, as the JAX package's flat theta
            assert model.sharded_trunk is None and [k for k, _ in model.named_parameters()] == [
                "flat"]
        with gathered(params, mesh):
            out.update(params_out(model, prefix + "param/"))

    # The mutation: every gradient averaged over the whole job.
    model, params, step = tp_step(inputs, mesh)

    def world_mean_(x):
        torch.distributed.all_reduce(x)
        return x.mul_(1.0 / mesh.world)

    mesh.all_reduce_mean_ = world_mean_
    try:
        step()
    finally:
        del mesh.all_reduce_mean_
    with gathered(params, mesh):
        out.update(params_out(model, "mutant/param/"))
    return out


def main(case, rank, world, port, out_dir):
    torch.set_num_threads(1)
    rng.set_seed(0)
    assert init_distributed(f"localhost:{port}", int(world), int(rank), device="cpu")
    try:
        inputs = dict(np.load(os.path.join(out_dir, "inputs.npz")))
        shape = tuple(int(n) for n in inputs["shape"]) if "shape" in inputs else (int(world), 1)
        mesh = make_mesh(shape=shape, device="cpu")
        assert (mesh.rank, mesh.world, mesh.backend) == (int(rank), int(world), "gloo")
        assert (mesh.data_rank, mesh.model_rank) == divmod(int(rank), shape[1])
        out = {"case_dp": case_dp, "case_fused": case_fused, "case_render": case_render,
               "case_tp": case_tp}[f"case_{case}"](inputs, mesh, out_dir)
        np.savez(os.path.join(out_dir, f"out_{rank}.npz"), **out)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])
