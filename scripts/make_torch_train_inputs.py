"""Write tests/torch_train_inputs.npz: the JAX side of a full-width training
step for the PyTorch port (chip_smoke.py's training phase, which has no JAX).

configs/config_carpet_train.py's model, renderer, loss, batch shape and
Adam schedule, on a synthetic TFRecord (nerftex_tpu.tools.synth: 32 swatches
of 64x64, seed 0) in place of the Blender swatches:

  param/<layer>/<w|b>    the ParamNerf ([1, 6], depth 8, width 256, f32) as
                         the JAX factory initialises it under seed 0
  batch<s>/<name>        the s-th training batch of the JAX Dataset (4 images
                         x 256 Proxy rays: rays_o, rays_d, t, cone_scale,
                         parameters, color, alpha), s = 0 .. K - 1
  loss                   float32 [K]: the loss of step s under
                         fold_in(stream_key(STREAM_PERTURB), s), each after
                         the Adam updates of the steps before it
  grad/<layer>/<w|b>     the gradient of step 0
  grad64/<layer>/<w|b>   the gradient of step 0 with the model's dots in
                         float64 (jax_enable_x64, compute_dtype "float64",
                         float64 weights; the renderer's positions, Fourier
                         encodings and compositing stay float32, as the
                         package writes them), stored as float32

The step runs jitted with remat_net_chunks=True (value- and
gradient-identical to the config's False, and one net_chunk of activations
at a time instead of four): forward and backward over 262,144 samples take
about a minute each on the CPU.

Run from the repo root:  JAX_PLATFORMS=cpu python scripts/make_torch_train_inputs.py
"""

import copy
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "torch_train_inputs.npz")
K = 3
N_IMAGES, SIZE = 32, 64


def flatten_params(tree: dict) -> dict:
    """{"trunk/0/w": array, ...}: the "/"-joined keys of a ParamNerf tree."""
    flat = {}
    for key, value in tree.items():
        if isinstance(value, list):
            for i, layer in enumerate(value):
                for name in ("w", "b"):
                    flat[f"{key}/{i}/{name}"] = np.asarray(layer[name])
        else:
            for name in ("w", "b"):
                flat[f"{key}/{name}"] = np.asarray(value[name])
    return flat


def main() -> None:
    sys.path.insert(0, ROOT)
    import jax
    import jax.numpy as jnp

    import nerftex_tpu.models.mlp as jax_mlp
    from configs.config_carpet_train import config as stock
    from nerftex_tpu.render.train import make_optimizer, make_train_step
    from nerftex_tpu.tools.synth import make_synthetic_tfrecord
    from nerftex_tpu.utils import rng, util

    cfg = copy.deepcopy(stock)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tfr = os.path.join(tmp, "train.tfr")
        make_synthetic_tfrecord(tfr, n_images=N_IMAGES, size=SIZE, seed=0)
        cfg["train_dataset_config"]["data_loader_config"]["tfr_path"] = tfr
        rng.set_seed(cfg["seed"])
        jax_mlp._INIT_COUNTER[0] = 0
        dataset = util.instantiate(util.EasyDict(cfg["train_dataset_config"]))
        batches = list(dataset.take(K))
    model_cfg = util.EasyDict(cfg["model_config"])
    model_cfg.setdefault("n_parameters", dataset.n_parameters)  # as Train does
    model = util.instantiate(model_cfg)["model"]
    params = {"model": model.params}
    for k, v in flatten_params(jax.tree.map(np.asarray, model.params)).items():
        out[f"param/{k}"] = v
    renderer = util.instantiate(util.EasyDict(dict(cfg["renderer_config"], model=model,
                                                   remat_net_chunks=True)))
    loss_fn = util.instantiate(util.EasyDict(cfg["loss_config"]))
    optimizer = make_optimizer(cfg["lrate"], cfg["lrate_decay"])
    opt_state = optimizer.init(params)

    def loss_of(p, batch, key):
        pred = renderer.apply(p, batch, key, composite_bkgd=dataset.composite_bkgd,
                              bkgd_color=dataset.bkgd_color, training=True)
        return loss_fn(color_true=batch["color"], alpha_true=batch["alpha"], **pred)

    grad0 = jax.jit(jax.grad(loss_of))
    params0 = params
    step = make_train_step(renderer, loss_fn, optimizer, dataset.composite_bkgd,
                           dataset.bkgd_color, donate=False)
    base = rng.stream_key(rng.STREAM_PERTURB)
    losses = []
    for s, data in enumerate(batches):
        batch = {k: jnp.asarray(v) for k, v in data.items()}
        key = jax.random.fold_in(base, s)
        if s == 0:
            g = grad0(params, batch, key)
            for k, v in flatten_params(jax.tree.map(np.asarray, g["model"])).items():
                out[f"grad/{k}"] = v
        params, opt_state, loss = step(params, opt_state, batch, key)
        losses.append(float(loss))
        for k, v in data.items():
            out[f"batch{s}/{k}"] = np.asarray(v, np.float32)
        print(f"step {s}: loss {losses[-1]:.8f}", flush=True)
    out["loss"] = np.asarray(losses, np.float32)

    with jax.enable_x64(True):
        model64 = util.instantiate(util.EasyDict(dict(model_cfg, compute_dtype="float64")))["model"]
        renderer64 = util.instantiate(util.EasyDict(dict(cfg["renderer_config"], model=model64,
                                                         remat_net_chunks=True)))
        p64 = jax.tree.map(lambda w: jnp.asarray(w, jnp.float64), params0)
        batch = {k: jnp.asarray(v) for k, v in batches[0].items()}

        def loss64(p):
            pred = renderer64.apply(p, batch, jax.random.fold_in(base, 0),
                                    composite_bkgd=dataset.composite_bkgd,
                                    bkgd_color=dataset.bkgd_color, training=True)
            return loss_fn(color_true=batch["color"], alpha_true=batch["alpha"], **pred)

        g64 = jax.jit(jax.grad(loss64))(p64)
    for k, v in flatten_params(jax.tree.map(np.asarray, g64["model"])).items():
        out[f"grad64/{k}"] = v.astype(np.float32)
        rel = np.abs(out[f"grad/{k}"] - v).max() / np.abs(v).max()
        print(f"step 0 gradient {k}: float32 vs float64 dots {rel:.3g} of max |g|")
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({os.path.getsize(OUT) / 2**20:.2f} MiB)")


if __name__ == "__main__":
    main()
